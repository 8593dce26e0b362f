"""Port parity: the data axis (``tests/test_data_parallel.py``'s cases)
over ``torch.distributed`` gloo ranks on the CPU.

Each world (1, 2 and 4 ranks; subprocesses, one group each, a
``file://`` rendezvous) runs every case once and writes its results;
the tests read them.  The reference's mesh paths fail under jax 0.9.0
(``ShardingTypeError`` at ``bag_logits``' ``jnp.take``, ROADMAP C), so
the port is held against the reference's UNSHARDED path, on the
reference's rows and CWS matrices (handed over as arrays):

* ``TestShardedStreamedFeatures``: at every ndev, ``features`` /
  ``feature_chunks`` / ``launch_chunk`` under ``mesh=`` equal the
  unsharded port and the reference's ``features`` bit for bit (integer
  outputs); one launch a rank a chunk, of the chunk's block of rows (the
  counterpart of the reference's single-compile test: PyTorch runs
  eagerly, so the invariant is the launch shape).
* ``TestShardedTraining``: a one-rank mesh is the unsharded port bit for
  bit (which test_torch_linear_train.py holds to the reference); at
  every ndev the batch walk is the reference's and no rank launches more
  than its block of a batch; two runs at the same ndev give the same
  bits.
* ``TestMultiDeviceParity`` (ndev > 1): the gradient of a batch, each
  rank's block averaged over the axis, within ``GRAD_RTOL`` (of
  ``GRAD_ATOL_OF_MAX`` x max |g|) of the reference's gradient of the
  whole batch; after 200 steps the test accuracy within 0.5 pp of the
  unsharded port's (equal counts on 80 rows), and within ``ACC_PP`` of
  the unsharded reference's (tests/test_torch_linear_train.py: the
  port's AdamW differs from the jitted reference by about a rounding a
  step), and the table within rtol 1e-3 / ``TABLE_ATOL`` of the
  unsharded port's.  The reference's own case asks atol 1e-4 (and cannot
  run under jax 0.9.0); here the sums' other order, through AdamW's
  g / sqrt(v) where v is small, moves 9 of the 1,152 entries by up to
  8.0e-4 at 2 and at 4 ranks, so ``TABLE_ATOL`` is 2e-3.
"""
import datetime
import math
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import linear_model as jlm
from repro.data.synthetic import make_template_classification
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro.training import fit_linear_streamed as jfit_streamed
from repro.training import streamed_accuracy as jstreamed_accuracy
from repro.training.trainer import microbatch_grads as jmicrobatch_grads
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import linear_model as tlm
from repro_torch.core.cws import CWSParams
from repro_torch.core.regen import prng_key
from repro_torch.launch.mesh import data_axis_size, make_data_mesh
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.training import fit_linear_streamed, streamed_accuracy
from repro_torch.training.trainer import microbatch_grads

WORLDS = (1, 2, 4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-6   # test_torch_linear_train's
ACC_PP = 3.75                               # 3 of the 80 test rows
PARITY_STEPS = 200
TABLE_ATOL = 2e-3


def rand_nonneg(seed, shape, sparsity=0.4):
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.standard_normal(shape))
    return (mag * (rng.random(shape) < 1 - sparsity)).astype(np.float32)


def _ref_problem():
    """The reference tests' problem as numpy arrays: the dataset and the
    stored CWS matrices of ``FeaturePipeline.create(PRNGKey(7), 32, ...)``
    and of ``_pipe``'s ``PRNGKey(3)`` at D = 18, k = 10."""
    ds = make_template_classification(3, n_train=160, n_test=80, dim=32,
                                      n_classes=3, mult_noise=1.1,
                                      spike_prob=0.02, density=0.3)
    big = JPipe.create(jax.random.PRNGKey(7), 32, JSpec(num_hashes=24,
                                                        b_i=4))
    small = JPipe.create(jax.random.PRNGKey(3), 18, JSpec(num_hashes=10,
                                                          b_i=3))
    arrays = lambda p: tuple(np.asarray(m) for m in (p.params.r,
                                                     p.params.log_c,
                                                     p.params.beta))
    return {"data": (ds.x_train, ds.y_train, ds.x_test, ds.y_test),
            "big": arrays(big), "small": arrays(small),
            "regen_key": np.asarray(jax.random.PRNGKey(8), np.uint32),
            "regen_key_big": np.asarray(jax.random.PRNGKey(11), np.uint32)}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _pipe(arrays, spec, row_chunk=8192):
    return FeaturePipeline(CWSParams(*(torch.from_numpy(a) for a in arrays)),
                           spec, row_chunk=row_chunk)


def _spy(pipe, shapes):
    """Record each launch's row count on ``pipe``."""
    real = pipe._launch_with

    def launch(x, state):
        shapes.append(int(x.shape[0]))
        return real(x, state)

    pipe._launch_with = launch
    return pipe


def _features_cases(res, mesh, prob):
    ndev = data_axis_size(mesh)
    small = lambda rc: _pipe(prob["small"], FeatureSpec(10, 3), rc)
    pipe = small(28)
    res["chunk_rows"] = np.array([pipe.chunk_rows(), pipe.chunk_rows(mesh)])
    x27 = rand_nonneg(4, (27, 18))
    x27[25] = 0.0
    res["streamed_x"] = x27
    res["streamed"] = small(8).features(x27, mesh=mesh).numpy()
    res["whole"] = small(1 << 20).features(x27).numpy()
    # one launch a rank a chunk, of the chunk's block (ragged tail padded
    # to the axis' multiple)
    pipe = small(8)
    rows = pipe.chunk_rows(mesh)
    x = rand_nonneg(5, (3 * rows + 5, 18))
    shapes = []
    _spy(pipe, shapes)
    res["launch_x"] = x
    res["launch_feats"] = pipe.features(x, mesh=mesh).numpy()
    res["launch_shapes"] = np.array(shapes)
    x3 = rand_nonneg(6, (3, 18))
    res["tiny_x"] = x3
    res["tiny"] = small(8).features(x3, mesh=mesh).numpy()
    xn = rand_nonneg(7, (ndev, 18))
    keep = xn.copy()
    pipe = small(8)
    got = pipe.features(xn, mesh=mesh)
    [(_, _, via_chunks)] = list(pipe.feature_chunks(xn, mesh=mesh))
    res["whole_x"] = xn
    res["whole_launch"] = got.numpy()
    res["whole_chunks"] = via_chunks.numpy()
    res["whole_x_intact"] = np.array(np.array_equal(xn, keep))
    regen = FeaturePipeline.create_regen(prob["regen_key"], 18,
                                         FeatureSpec(10, 3), row_chunk=8,
                                         device="cpu")
    x9 = rand_nonneg(9, (27, 18))
    res["regen_x"] = x9
    res["regen_mesh"] = regen.features(x9, mesh=mesh).numpy()
    res["regen_plain"] = regen.features(x9).numpy()
    res["regen_staged"] = regen.staged_reference(x9).numpy()
    x10 = rand_nonneg(10, (ndev + 1, 18))
    try:
        small(8).launch_chunk(x10, mesh=mesh)
        res["indivisible"] = np.array("launched")
    except ValueError as e:
        res["indivisible"] = np.array(str(e))
    x11 = rand_nonneg(11, (2 * rows + 3, 18))
    res["spans_x"] = x11
    spans = list(small(8).feature_chunks(x11, mesh=mesh))
    res["spans"] = np.array([(lo, hi) for lo, hi, _ in spans])
    res["spans_feats"] = np.concatenate([f.numpy() for _, _, f in spans])
    pipe = _pipe(prob["small"], FeatureSpec(10, 3), 12)
    res["ragged_rows"] = np.array(pipe.chunk_rows(mesh))
    x13 = rand_nonneg(13, (61, 18))
    res["ragged_x"] = x13
    res["ragged"] = pipe.features(x13, mesh=mesh).numpy()
    packed = _pipe(prob["small"], FeatureSpec(10, 4, packed=True), 8)
    res["packed"] = packed.features(x27, mesh=mesh).view(
        torch.int32).numpy()
    res["packed_plain"] = packed.features(x27).view(torch.int32).numpy()


def _fit(pipe, data, mesh, steps=30, bs=32, seed=5, **kw):
    xtr, ytr = data[:2]
    p0 = tlm.init_bag(pipe.num_features, 3, device="cpu")
    cfg = tlm.TrainCfg(n_classes=3, steps=steps, lr=0.05, l2=1e-5,
                       batch_size=bs)
    return fit_linear_streamed(p0, pipe, xtr, ytr, cfg=cfg,
                               shuffle_key=prng_key(seed), mesh=mesh, **kw)


def _training_cases(res, mesh, prob):
    ndev = data_axis_size(mesh)
    xtr, ytr, xte, yte = prob["data"]
    data = tuple(torch.from_numpy(a) for a in prob["data"])
    pipe = _pipe(prob["big"], FeatureSpec(24, 4))
    if ndev == 1:
        # a one-rank mesh against the unsharded path
        for name, kw in (("one", {}), ("bs_n", dict(steps=20, bs=160)),
                         ("micro", dict(steps=8, seed=3,
                                        n_microbatches=2))):
            a = _fit(pipe, data, None, **kw)
            b = _fit(pipe, data, mesh, **kw)
            res[f"{name}_equal"] = np.array(torch.equal(a.w, b.w)
                                            and torch.equal(a.b, b.b))
    p0 = tlm.init_bag(pipe.num_features, 3, device="cpu")
    res["acc_unsharded"] = np.array(streamed_accuracy(p0, pipe, data[0],
                                                      data[1]))
    res["acc_mesh"] = np.array(streamed_accuracy(p0, pipe, data[0], data[1],
                                                 mesh=mesh))
    a = _fit(pipe, data, mesh, steps=20, seed=2)
    b = _fit(pipe, (xtr, ytr), mesh, steps=20, seed=2)
    res["host_equal"] = np.array(torch.equal(a.w, b.w))
    try:
        _fit(pipe, data, mesh, steps=5, bs=ndev + 1)
        res["bs_indivisible"] = np.array("trained")
    except ValueError as e:
        res["bs_indivisible"] = np.array(str(e))
    try:
        _fit(pipe, data, mesh, steps=2, bs=30 * ndev, n_microbatches=4)
        res["micro_indivisible"] = np.array("trained")
    except ValueError as e:
        res["micro_indivisible"] = np.array(str(e))
    # a Checkpointer the run did not build for its mesh is refused (its
    # ranks would each write one process's files into one dir)
    try:
        _fit(pipe, data, mesh, steps=2,
             ckpt=Checkpointer(tempfile.mkdtemp()), ckpt_every=1)
        res["foreign_ckpt"] = np.array("trained")
    except ValueError as e:
        res["foreign_ckpt"] = np.array(str(e))
    shapes = []
    _fit(_spy(_pipe(prob["big"], FeatureSpec(24, 4)), shapes), data, mesh,
         steps=6, bs=16)
    res["train_shapes"] = np.array(shapes)
    # the same ndev twice: the same bits
    res["twice_equal"] = np.array(torch.equal(
        _fit(pipe, data, mesh).w, _fit(pipe, data, mesh).w))


def _parity_cases(res, mesh, prob):
    data = tuple(torch.from_numpy(a) for a in prob["data"])
    xtr, ytr, xte, yte = data
    pipe = _pipe(prob["big"], FeatureSpec(24, 4))
    res["parity_features"] = pipe.features(xtr, mesh=mesh).numpy()
    # one batch's gradient: each rank its block, averaged over the axis
    ndev = data_axis_size(mesh)
    fb = pipe.features(xtr[:32])
    r = mesh.axis_index("data")
    lb = 32 // ndev
    cfg = tlm.TrainCfg(n_classes=3, steps=1, lr=0.05, l2=1e-5,
                       batch_size=32)
    p = tlm.LinearParams(torch.from_numpy(prob["grad_w"]),
                         torch.from_numpy(prob["grad_b"]))
    loss_fn = lambda q, i, l: (tlm._loss_fn(q, i, l, cfg, tlm.bag_logits),
                               {})
    loss, _, g = microbatch_grads(
        loss_fn, p, {"inputs": fb[r * lb:(r + 1) * lb],
                     "labels": ytr[:32][r * lb:(r + 1) * lb]},
        axis_name="data", mesh=mesh)
    res["grad_loss"] = loss.numpy()
    res["grad_w"], res["grad_b"] = g.w.numpy(), g.b.numpy()
    for name, pipe_ in (("stored", pipe),
                        ("regen", FeaturePipeline.create_regen(
                            prob["regen_key_big"], 32, FeatureSpec(24, 4),
                            device="cpu"))):
        steps = PARITY_STEPS if name == "stored" else 80
        q = _fit(pipe_, data, mesh, steps=steps, seed=5 if name == "stored"
                 else 6)
        res[f"{name}_w"] = q.w.numpy()
        res[f"{name}_acc"] = np.array(streamed_accuracy(q, pipe_, xte, yte,
                                                        mesh=mesh))
        res[f"{name}_acc_single"] = np.array(streamed_accuracy(q, pipe_,
                                                               xte, yte))


def _rank_main(rank, world, init, outdir, prob):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_data_mesh(world)
        res = {}
        _features_cases(res, mesh, prob)
        _training_cases(res, mesh, prob)
        _parity_cases(res, mesh, prob)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def prob():
    out = _ref_problem()
    rng = np.random.default_rng(0)
    num_features = 24 * (1 << 4)
    out["grad_w"] = (0.1 * rng.standard_normal((num_features, 3))).astype(
        np.float32)
    out["grad_b"] = (0.1 * rng.standard_normal(3)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def worlds(prob, tmp_path_factory):
    """Every rank's results, from one gloo group of each size."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"dp{world}")
        mp.spawn(_rank_main, args=(world, f"file://{d}/rendezvous", str(d),
                                   prob), nprocs=world, join=True)
        out[world] = [dict(np.load(d / f"rank{r}.npz"))
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def unsharded(prob):
    """The unsharded port and the unsharded reference: the features of
    each case's rows, and the parity fits."""
    jsmall = JPipe(_jparams(prob["small"]), JSpec(num_hashes=10, b_i=3))
    jbig = JPipe(_jparams(prob["big"]), JSpec(num_hashes=24, b_i=4))
    xtr, ytr, xte, yte = prob["data"]
    out = {"jsmall": jsmall, "jbig": jbig}
    out["ref_features"] = np.asarray(jbig.features(jnp.asarray(xtr)))
    cfg = jlm.TrainCfg(n_classes=3, steps=PARITY_STEPS, lr=0.05, l2=1e-5,
                       batch_size=32)
    p0 = jlm.init_bag(jax.random.PRNGKey(0), jbig.num_features, 3)
    jp = jfit_streamed(p0, jbig, jnp.asarray(xtr), jnp.asarray(ytr),
                       cfg=cfg, shuffle_key=jax.random.PRNGKey(5))
    out["ref_acc"] = jstreamed_accuracy(jp, jbig, jnp.asarray(xte),
                                        jnp.asarray(yte))
    pipe = _pipe(prob["big"], FeatureSpec(24, 4))
    data = tuple(torch.from_numpy(a) for a in prob["data"])
    q = _fit(pipe, data, None, steps=PARITY_STEPS)
    out["port_w"] = q.w.numpy()
    out["port_acc"] = streamed_accuracy(q, pipe, data[2], data[3])
    regen = FeaturePipeline.create_regen(prob["regen_key_big"], 32,
                                         FeatureSpec(24, 4), device="cpu")
    out["port_regen_acc"] = streamed_accuracy(
        _fit(regen, data, None, steps=80, seed=6), regen, data[2], data[3])
    return out


def _jparams(arrays):
    from repro.core.cws import CWSParams as JParams
    return JParams(*(jnp.asarray(a) for a in arrays))


def _ref_features(pipe, x):
    return np.asarray(pipe.features(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# TestShardedStreamedFeatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
class TestShardedStreamedFeatures:
    def test_chunk_rows_is_lcm(self, worlds, world):
        for r in worlds[world]:
            assert r["chunk_rows"].tolist() == [28, math.lcm(28, world)]

    def test_streamed_sharded_matches_unsharded(self, worlds, unsharded,
                                                world):
        for r in worlds[world]:
            want = _ref_features(unsharded["jsmall"], r["streamed_x"])
            np.testing.assert_array_equal(r["streamed"], r["whole"])
            np.testing.assert_array_equal(r["streamed"], want)

    def test_single_compile_under_mesh(self, worlds, unsharded, world):
        """One launch a rank a chunk, of the chunk's block: 3 full chunks
        of lcm(8, ndev) rows and the 5-row tail padded to ndev's
        multiple."""
        for r in worlds[world]:
            rows = math.lcm(8, world)
            tail = -(-5 // world)
            assert r["launch_shapes"].tolist() == [rows // world] * 3 + [tail]
            np.testing.assert_array_equal(
                r["launch_feats"], _ref_features(unsharded["jsmall"],
                                                 r["launch_x"]))

    def test_tiny_n_below_ndev(self, worlds, unsharded, world):
        for r in worlds[world]:
            np.testing.assert_array_equal(
                r["tiny"], _ref_features(unsharded["jsmall"], r["tiny_x"]))

    def test_whole_array_launch_never_donates(self, worlds, unsharded,
                                              world):
        """ndev rows (no pad): the whole-array launch and the one-chunk
        walk agree, and the caller's rows are left as they were."""
        for r in worlds[world]:
            np.testing.assert_array_equal(r["whole_chunks"],
                                          r["whole_launch"])
            np.testing.assert_array_equal(
                r["whole_launch"], _ref_features(unsharded["jsmall"],
                                                 r["whole_x"]))
            assert bool(r["whole_x_intact"])

    def test_param_free_sharded_streamed(self, worlds, prob, world):
        jregen = JPipe.create_regen(jnp.asarray(prob["regen_key"]), 18,
                                    JSpec(num_hashes=10, b_i=3))
        for r in worlds[world]:
            np.testing.assert_array_equal(r["regen_mesh"], r["regen_plain"])
            np.testing.assert_array_equal(r["regen_mesh"], r["regen_staged"])
            np.testing.assert_array_equal(
                r["regen_mesh"], _ref_features(jregen, r["regen_x"]))

    def test_launch_chunk_rejects_indivisible_rows(self, worlds, world):
        for r in worlds[world]:
            if world == 1:    # every row count divides a one-rank axis
                assert str(r["indivisible"]) == "launched"
            else:
                assert "divisible" in str(r["indivisible"])

    def test_feature_chunks_mesh_spans(self, worlds, unsharded, world):
        rows = math.lcm(8, world)
        n = 2 * rows + 3
        for r in worlds[world]:
            assert r["spans"].tolist() == [[0, rows], [rows, 2 * rows],
                                           [2 * rows, n]]
            np.testing.assert_array_equal(
                r["spans_feats"], _ref_features(unsharded["jsmall"],
                                                r["spans_x"]))

    def test_packed_words_gather_as_words(self, worlds, world):
        for r in worlds[world]:
            np.testing.assert_array_equal(r["packed"], r["packed_plain"])


# ---------------------------------------------------------------------------
# TestShardedTraining
# ---------------------------------------------------------------------------

class TestShardedTraining:
    @pytest.mark.parametrize("case", ("one", "bs_n", "micro"))
    def test_one_device_mesh_bit_identity(self, worlds, case):
        """30 steps of 32 rows, batch_size == n (20 steps), and two
        microbatches (8 steps): a one-rank mesh is the unsharded path."""
        assert bool(worlds[1][0][f"{case}_equal"])

    @pytest.mark.parametrize("world", WORLDS)
    def test_streamed_accuracy_mesh_identical(self, worlds, world):
        for r in worlds[world]:
            assert float(r["acc_mesh"]) == float(r["acc_unsharded"])

    @pytest.mark.parametrize("world", WORLDS)
    def test_host_numpy_dataset_mesh_matches_device(self, worlds, world):
        assert all(bool(r["host_equal"]) for r in worlds[world])

    @pytest.mark.parametrize("world", WORLDS)
    def test_batch_size_must_divide_data_axis(self, worlds, world):
        for r in worlds[world]:
            if world == 1:    # every batch size divides a one-rank axis
                assert str(r["bs_indivisible"]) == "trained"
            else:
                assert "data axis" in str(r["bs_indivisible"])

    @pytest.mark.parametrize("world", WORLDS)
    def test_microbatch_divides_local_batch(self, worlds, world):
        for r in worlds[world]:
            assert "microbatch" in str(r["micro_indivisible"])

    @pytest.mark.parametrize("world", WORLDS)
    def test_checkpointer_must_be_built_for_the_mesh(self, worlds, world):
        for r in worlds[world]:
            if world == 1:    # one rank writes one process's files
                assert str(r["foreign_ckpt"]) == "trained"
            else:
                assert "mesh=" in str(r["foreign_ckpt"])

    @pytest.mark.parametrize("world", WORLDS)
    def test_never_materializes_full_index_matrix(self, worlds, world):
        """Six steps of 16 rows: every launch of the fit is one rank's
        block of a batch, never the batch and never (n, k)."""
        for r in worlds[world]:
            assert r["train_shapes"].tolist() == [16 // world] * 6

    @pytest.mark.parametrize("world", WORLDS)
    def test_same_ndev_same_bits(self, worlds, world):
        assert all(bool(r["twice_equal"]) for r in worlds[world])
        w = [r["stored_w"] for r in worlds[world]]
        for other in w[1:]:     # every rank holds the same table
            np.testing.assert_array_equal(other, w[0])


# ---------------------------------------------------------------------------
# TestMultiDeviceParity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS[1:])
class TestMultiDeviceParity:
    def test_features_bit_parity(self, worlds, unsharded, world):
        for r in worlds[world]:
            np.testing.assert_array_equal(r["parity_features"],
                                          unsharded["ref_features"])

    def test_gradient_matches_reference(self, worlds, prob, unsharded,
                                        world):
        """One batch of 32 rows: the axis mean of the ranks' block
        gradients against the reference's gradient of the whole batch."""
        xtr, ytr = prob["data"][:2]
        cfg = jlm.TrainCfg(n_classes=3, steps=1, lr=0.05, l2=1e-5,
                           batch_size=32)
        jloss_fn = lambda p, i, l: (jlm._loss_fn(p, i, l, cfg,
                                                 jlm.bag_logits), {})
        fb = unsharded["jbig"].features(jnp.asarray(xtr[:32]))
        jloss, _, jg = jmicrobatch_grads(
            jloss_fn, jlm.LinearParams(jnp.asarray(prob["grad_w"]),
                                       jnp.asarray(prob["grad_b"])),
            {"inputs": fb, "labels": jnp.asarray(ytr[:32])})
        for r in worlds[world]:
            np.testing.assert_allclose(r["grad_loss"], float(jloss),
                                       rtol=1e-6)
            for got, want in ((r["grad_w"], jg.w), (r["grad_b"], jg.b)):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got, want, rtol=GRAD_RTOL,
                    atol=GRAD_ATOL_OF_MAX * np.abs(want).max())
        first = worlds[world][0]
        for r in worlds[world][1:]:   # the same bits on every rank
            np.testing.assert_array_equal(r["grad_w"], first["grad_w"])

    def test_training_accuracy_parity(self, worlds, unsharded, world):
        for r in worlds[world]:
            acc = float(r["stored_acc"])
            assert acc == float(r["stored_acc_single"])
            assert abs(acc - unsharded["port_acc"]) <= 0.005
            assert abs(acc - unsharded["ref_acc"]) * 100 <= ACC_PP
            np.testing.assert_allclose(r["stored_w"], unsharded["port_w"],
                                       rtol=1e-3, atol=TABLE_ATOL)

    def test_param_free_training_parity(self, worlds, unsharded, world):
        for r in worlds[world]:
            assert abs(float(r["regen_acc"])
                       - unsharded["port_regen_acc"]) <= 0.005

    def test_ragged_n_streamed_parity(self, worlds, unsharded, world):
        for r in worlds[world]:
            assert int(r["ragged_rows"]) == math.lcm(12, world)
            np.testing.assert_array_equal(
                r["ragged"], _ref_features(unsharded["jsmall"],
                                           r["ragged_x"]))
