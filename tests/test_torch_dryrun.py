"""Port parity: the dry run (``repro_torch.launch.dryrun``), every cell of
the production mesh built on the ``meta`` device at one rank's shards.

  * the cells, ``LONG_CONTEXT_ARCHS`` and ``N_MICRO`` are the reference's;
  * every rank's parameter, optimizer-state and cache bytes equal the
    reference's per-device shard bytes (``jax.eval_shape`` and its pspecs
    over an ``AbstractMesh``), for all ten archs on both production
    meshes, at rank 0 and at the last rank;
  * the counted matrix-product FLOPs of the unsharded smoke steps equal
    ``repro.launch.hlo_analysis.analyze`` of the reference's compiled
    steps, up to the terms named here;
  * the counts that rows 8 and 9 and their backward passes take on
    ``meta`` (formulas) equal the counts of the products they run on real
    tensors, and the extrapolation over microbatches equals the full
    count;
  * the counting route refuses a real tensor on a fake group and a
    ``meta`` tensor on a real one;
  * four full-width, full-depth cells run to their end and repeat their
    committed records; the CLI writes its JSON.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported,
so its ``N_MICRO`` is read from its source instead.
"""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import hlo_analysis as ref_hlo  # noqa: E402
from repro.models import init_caches as ref_init_caches  # noqa: E402
from repro.models import init_model as ref_init_model  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import collectives as coll  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch.hlo_analysis import GraphCounter  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models import init_caches, init_model  # noqa: E402
from repro_torch.models.sharding import make_rules  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(16, 16), (2, 16, 16)]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _ref_n_micro():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "N_MICRO":
            return ast.literal_eval(node.value)
    raise AssertionError("no N_MICRO in the reference's dryrun.py")


def test_cells_equal_the_reference():
    assert t_configs.cells() == ref_configs.cells()
    assert t_configs.cells(include_skipped=True) == \
        ref_configs.cells(include_skipped=True)
    assert len(t_configs.cells()) == 33
    assert t_configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    assert dryrun.N_MICRO == _ref_n_micro()


# ---------------------------------------------------------------------------
# bytes a rank against the reference's shard bytes
# ---------------------------------------------------------------------------

def _ref_bytes(shapes, specs, mesh) -> int:
    """Per-device bytes of a tree of ShapeDtypeStructs under its specs."""
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P) or x is None)
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for d, dim in enumerate(leaf.shape):
            ax = spec[d] if spec is not None and d < len(spec) else None
            div = 1
            for a in (() if ax is None else (ax,) if isinstance(ax, str)
                      else ax):
                div *= mesh.shape[a]
            assert dim % div == 0
            n *= dim // div
        total += n * leaf.dtype.itemsize
    return total


def _ref_cell_bytes(arch, mesh_shape):
    names = ("pod", "data", "model") if len(mesh_shape) == 3 else \
        ("data", "model")
    mesh = AbstractMesh(mesh_shape, names)
    rules = ref_sharding.make_rules(mesh)
    cfg = ref_configs.get_config(arch, "full")
    hp = ref_trainer.TrainHparams()
    state = jax.eval_shape(lambda: ref_trainer.init_train_state(
        jax.random.PRNGKey(0), cfg, hp))
    specs = ref_trainer.state_pspecs(cfg, rules, hp)
    out = {"param_bytes": _ref_bytes(state.params, specs.params, mesh),
           "mu_bytes": _ref_bytes(state.mu, specs.mu, mesh),
           "nu_bytes": _ref_bytes(state.nu, specs.nu, mesh),
           "step_bytes": _ref_bytes(state.step, specs.step, mesh)}
    params = jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0),
                                                   cfg))
    assert _ref_bytes(params, ref_trainer.param_pspecs(cfg, rules),
                      mesh) == out["param_bytes"]
    caches = {}
    for a, shape in ref_configs.cells():
        seq, batch, kind = ref_configs.SHAPES[shape]
        if a != arch or kind == "train":
            continue
        long = shape.startswith("long")
        c = jax.eval_shape(lambda: ref_init_caches(cfg, batch, seq,
                                                   long=long))
        caches[shape] = _ref_bytes(c, ref_trainer.cache_pspecs(
            cfg, rules, batch=batch, max_len=seq, long=long), mesh)
    return out, caches


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_shard_bytes_equal_the_reference(mesh_shape):
    multi = len(mesh_shape) == 3
    world = 512 if multi else 256
    want = {arch: _ref_cell_bytes(arch, mesh_shape)
            for arch in ref_configs.ARCHS}
    for rank in (0, world - 1):
        got = dryrun.shard_bytes(t_configs.ARCHS, multi_pod=multi,
                                 rank=rank)
        for arch, (state, caches) in want.items():
            train = got[arch]["train_4k"]
            for key, n in state.items():
                assert train[key] == n, (arch, rank, key)
            assert train["ef_residual_bytes"] == 0
            for shape, n in caches.items():
                mem = got[arch][shape]
                assert mem["cache_bytes"] == n, (arch, rank, shape)
                assert mem["param_bytes"] == state["param_bytes"]


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO count
# ---------------------------------------------------------------------------

SMOKE_B, SMOKE_S = 4, 64


def _meta_ints(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def test_smoke_train_flops_equal_the_reference():
    """The unsharded smoke train step: the reference's HLO count plus one
    term, the loss's logits that the port recomputes in the backward
    (``layers.chunked_cross_entropy`` checkpoints each chunk), 2 B S D V;
    XLA keeps the forward's."""
    rc = ref_configs.get_config("gemma3_12b", "smoke")
    tc = t_configs.get_config("gemma3_12b", "smoke")
    hp = ref_trainer.TrainHparams()
    state = jax.eval_shape(lambda: ref_trainer.init_train_state(
        jax.random.PRNGKey(0), rc, hp))
    batch = {k: jax.ShapeDtypeStruct((SMOKE_B, SMOKE_S), jnp.int32)
             for k in ("inputs", "labels")}
    text = jax.jit(ref_trainer.make_train_step(rc, hp, None)).lower(
        state, batch).compile().as_text()
    want = ref_hlo.analyze(text, 1).dot_flops
    ht = t_trainer.TrainHparams()
    _, got = hlo_analysis.analyze(
        t_trainer.make_train_step(tc, ht),
        t_trainer.init_train_state(tc, ht, device="meta"),
        {k: _meta_ints(SMOKE_B, SMOKE_S) for k in ("inputs", "labels")})
    logits_recompute = 2 * SMOKE_B * SMOKE_S * tc.d_model * tc.vocab
    assert got.dot_flops == want + logits_recompute
    assert got.n_collectives == {k: 0 for k in coll.COLLECTIVE_KINDS}


def test_smoke_serve_flops_equal_the_reference():
    rc = ref_configs.get_config("gemma3_12b", "smoke")
    tc = t_configs.get_config("gemma3_12b", "smoke")
    slots = SMOKE_S + 8
    pre_r, dec_r = ref_trainer.make_serve_steps(rc, None)
    params = jax.eval_shape(lambda: ref_init_model(jax.random.PRNGKey(0),
                                                   rc))
    caches = jax.eval_shape(lambda: ref_init_caches(rc, SMOKE_B, slots))
    sds = jax.ShapeDtypeStruct
    want_pre = ref_hlo.analyze(jax.jit(pre_r).lower(
        params, sds((SMOKE_B, SMOKE_S), jnp.int32), caches).compile()
        .as_text(), 1).dot_flops
    want_dec = ref_hlo.analyze(jax.jit(dec_r).lower(
        params, sds((SMOKE_B, 1), jnp.int32), sds((), jnp.int32), caches)
        .compile().as_text(), 1).dot_flops
    pre_t, dec_t = t_trainer.make_serve_steps(tc)
    pm = init_model(tc, device="meta")
    cm = init_caches(tc, SMOKE_B, slots, device="meta")
    with torch.no_grad():
        _, got_pre = hlo_analysis.analyze(pre_t, pm,
                                          _meta_ints(SMOKE_B, SMOKE_S), cm)
        _, got_dec = hlo_analysis.analyze(
            dec_t, pm, _meta_ints(SMOKE_B, 1),
            torch.tensor(SMOKE_S, dtype=torch.int32), cm)
    assert got_pre.dot_flops == want_pre
    assert got_dec.dot_flops == want_dec


# ---------------------------------------------------------------------------
# rows 8 and 9 on meta, their backward passes, repeated work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,sk,h,g,d,window,chunk,q_base", [
    (2, 64, 64, 4, 2, 8, 0, 16, 0), (1, 40, 96, 4, 1, 8, 0, 16, 56),
    (1, 64, 64, 4, 2, 8, 24, 16, 0), (1, 50, 50, 2, 2, 8, 0, 16, 0),
    (1, 32, 128, 2, 1, 8, 20, 16, 96), (1, 16, 16, 2, 2, 4, 0, 64, 0)])
def test_flash_meta_route_counts_what_the_plain_path_runs(
        b, sq, sk, h, g, d, window, chunk, q_base):
    """Row 8's meta route: 4 D FLOPs a visible pair and head; its
    backward's formula equals the products that the backward runs on CPU
    tensors (the chunked recompute and autograd's products)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, d)))
    counter = GraphCounter()
    with counter, torch.enable_grad():
        out = fa._ref_bwd_fn(q, k, v, window, chunk, q_base)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert fa.chunked_bwd_work(q.shape, k.shape, window, chunk, q_base) == \
        (counter.flops, counter.bytes)

    qm, km, vm = (t.detach().to("meta").requires_grad_(True)
                  for t in (q, k, v))
    fa.reset_meta_work()
    from repro_torch.kernels import ops
    out = ops.flash_attention(qm, km, vm, window=window, q_base=q_base,
                              chunk=chunk)
    assert out.shape == q.shape and out.device.type == "meta"
    torch.autograd.grad(out, (qm, km, vm), torch.ones_like(out))
    pos = np.arange(sq)[:, None] + q_base
    keys = np.arange(sk)[None, :]
    vis = keys <= pos
    if window:
        vis &= keys > pos - window
    fwd = fa.META_WORK["flash_attention_fwd"]
    assert fwd["calls"] == 1 and fwd["flops"] == 4 * d * b * h * vis.sum()
    assert fa.META_WORK["flash_attention_bwd"]["flops"] == counter.flops


@pytest.mark.parametrize("b,sq,h,g,d,chunk_elems", [
    (2, 40, 4, 2, 8, None), (2, 40, 4, 2, 8, 700), (1, 64, 6, 3, 16, None),
    (1, 64, 6, 3, 16, 700)])
def test_ring_backward_step_formula(b, sq, h, g, d, chunk_elems,
                                    monkeypatch):
    if chunk_elems:
        monkeypatch.setattr(fa, "_CHUNK_ELEMS", chunk_elems)
    rng = np.random.default_rng(sq)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = t(b, sq, h, d), t(b, sq, g, d), t(b, sq, g, d)
    out, lse, go = t(b, sq, h, d), t(b, sq, h), t(b, sq, h, d)
    counter = GraphCounter()
    with counter:
        fa.ring_flash_attention_bwd(q, k, v, out, lse, go, window=0,
                                    mesh=make_mesh(1, 1),
                                    seq_axes=("model",))
    assert fa.ring_bwd_step_work(q.shape, k.shape) == (counter.flops,
                                                       counter.bytes)


def test_visible_pairs():
    for sq, sk, qb, kb, w in ((7, 9, 0, 0, 0), (7, 9, 3, 2, 4),
                              (16, 16, 16, 0, 5), (5, 40, 30, 8, 0)):
        rows = np.arange(qb, qb + sq)[:, None]
        keys = np.arange(kb, kb + sk)[None, :]
        vis = keys <= rows
        if w:
            vis &= keys > rows - w
        assert fa.visible_pairs(sq, sk, q_base=qb, k_base=kb, window=w) == \
            vis.sum()


def test_microbatch_extrapolation_equals_the_full_count():
    """N = 4 microbatches on a sharded smoke step at (2, 2): the counts of
    one and two microbatches, extrapolated, equal the count of the step
    at four, collectives and all."""
    cfg = t_configs.get_config("gemma3_12b", "smoke")
    hp = t_trainer.TrainHparams(n_microbatches=4)
    with dryrun.fake_group(4, 3):
        rules = make_rules(Mesh({"data": 2, "model": 2}))
        _, _, state, local = dryrun.build(cfg, hp, rules, kind="train",
                                          seq_len=64, global_batch=16)
        got = dryrun.train_stats(cfg, hp, rules, state, local)
        _, want = hlo_analysis.analyze(
            t_trainer.make_train_step(cfg, hp, rules), state, local)
    assert got.as_dict() == want.as_dict()
    assert sum(want.n_collectives.values()) > 0


@pytest.mark.parametrize("global_batch,rank_micro", [(4, 2), (8, 4)])
def test_train_stats_take_fewer_rows_than_microbatches(global_batch,
                                                       rank_micro):
    """N = 16 microbatches on a rank holding 2 or 4 rows at (2, 2): the
    step and the dry run both take ``microbatch_count``'s one row a
    microbatch, and the dry run's count (extrapolated past two) equals
    the step's own (ROADMAP C11)."""
    cfg = t_configs.get_config("gemma3_12b", "smoke")
    hp = t_trainer.TrainHparams(n_microbatches=16)
    with dryrun.fake_group(4, 0):
        rules = make_rules(Mesh({"data": 2, "model": 2}))
        _, _, state, local = dryrun.build(cfg, hp, rules, kind="train",
                                          seq_len=64,
                                          global_batch=global_batch)
        rows = local["inputs"].shape[0]
        assert rows == rank_micro < hp.n_microbatches
        assert t_trainer.microbatch_count(rows, 16) == rank_micro
        got = dryrun.train_stats(cfg, hp, rules, state, local)
        _, want = hlo_analysis.analyze(
            t_trainer.make_train_step(cfg, hp, rules), state, local)
    assert got.as_dict() == want.as_dict()


def test_microbatch_count_keeps_the_memory_policy():
    for rows in range(1, 40):
        for n in range(1, 20):
            c = t_trainer.microbatch_count(rows, n)
            assert rows % c == 0
            assert rows // c <= max(rows / n, 1)
            if rows % n == 0:
                assert c == n


# ---------------------------------------------------------------------------
# the counting route's refusals
# ---------------------------------------------------------------------------

def test_counting_route_refuses_mixed_devices(monkeypatch):
    for backend, dev, says in (("gloo", "meta", "gloo group moves host"),
                               ("nccl", "meta", "NCCL group moves CUDA"),
                               ("fake", "cpu", "fake process group")):
        with pytest.raises(ValueError, match=says):
            coll.transport(backend, dev)
    assert coll.transport("fake", "meta") == "fake"
    assert coll.transport("gloo", "cpu") == "gloo"
    with dryrun.fake_group(2, 1):
        mesh = make_mesh(1, 2)
        with pytest.raises(ValueError, match="fake process group"):
            coll.all_gather_dim(torch.zeros(2, 3), mesh, "model")
        with pytest.raises(ValueError, match="fake process group"):
            coll.gather_parts(torch.zeros(2, 3), mesh, "model")
        coll.reset_collectives()
        out = coll.all_gather_dim(torch.zeros(2, 3, device="meta"), mesh,
                                  "model", dim=1)
        assert out.shape == (2, 6) and out.device.type == "meta"
        rec = coll.collectives_snapshot()["all_gather"]
        assert rec == {"count": 1, "bytes": 2 * 6 * 4,
                       "io_bytes": 2 * 3 * 4 + 2 * 6 * 4,
                       "axes": {"model": 1}}
        assert mesh.host_group is not None
    # every op has a meta route (shapes alone); one without it raises
    x = torch.empty(3, 5, device="meta")
    i_star, t_star = registry.resolve("cws_hash_rng", "meta")(x, (1, 2), 7)
    assert i_star.shape == t_star.shape == (3, 7)
    monkeypatch.delitem(registry.IMPLS["cws_hash"], "meta")
    with pytest.raises(KeyError, match="no meta route"):
        registry.resolve("cws_hash", "meta")


# ---------------------------------------------------------------------------
# full cells and the CLI
# ---------------------------------------------------------------------------

FULL = [("musicgen_large", "train_4k"), ("olmoe_1b_7b", "prefill_32k"),
        ("olmoe_1b_7b", "decode_32k"), ("recurrentgemma_2b", "long_500k")]


@pytest.mark.parametrize("arch,shape", FULL)
def test_full_cell_runs_and_repeats_its_record(arch, shape):
    got = dryrun.run_cell(arch, shape, multi_pod=False, rank=0)
    graph = got["graph"]
    assert graph["dot_flops"] > 0 and graph["bytes_accessed"] > 0
    assert graph["total_collective_bytes"] > 0
    assert got["memory"]["state_bytes"] > 0
    assert got["counted_params"] >= got["params"]
    rec = json.loads((dryrun.RESULTS_DIR / f"{arch}__{shape}__16x16.json")
                     .read_text())
    want = rec["ranks"]["0"]
    assert got["memory"] == want["memory"]
    assert graph == want["graph"]
    assert got["counted_params"] == rec["counted_params"]


def test_cli_writes_its_record(tmp_path):
    env = dict(__import__("os").environ,
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "recurrentgemma_2b", "--shape", "decode_32k",
                    "--out", str(tmp_path)], check=True, env=env,
                   capture_output=True, timeout=300)
    rec = json.loads((tmp_path / "recurrentgemma_2b__decode_32k__16x16.json")
                     .read_text())
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert sorted(rec["ranks"]) == ["0", "255"]
    for r in rec["ranks"].values():
        assert r["graph"]["dot_flops"] > 0
        assert r["memory"]["cache_bytes"] > 0
