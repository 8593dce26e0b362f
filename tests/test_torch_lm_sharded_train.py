"""Port parity: the sharded LM train step (FSDP x TP over gloo ranks)
against the unsharded step of both packages, on the CPU.

Each world size (1, 2 and 4 ranks) is one ``torch.multiprocessing`` spawn
over a ``file://`` rendezvous that runs every case of that size
(``torch_sharded_ranks``, a module without JAX); the three run at once,
the unsharded oracles meanwhile in this process.  Rank 0 writes each
case's losses, the gathered gradients of its first step and the gathered
parameters after its last.  The cases start from the reference's initial
state (``interop.lm_train_state(..., rules=)``) and take the same global
batches, each data rank its block of rows.  The driver's per-process
draws (``DictLoader``) are held by its own test below.

Tolerances.  Against the port's unsharded step the operations are the
same, the sums over ranks in other orders: losses within ``TIGHT_RTOL`` =
2e-6 relative, every gradient leaf within ``TIGHT_GRAD`` = 1e-5 of its
largest magnitude, parameters within ``PARAM_ATOL`` = 2e-5 (a few-ulp
gradient difference moves Adam's normalized update by a few ulps of the
learning rate); at one rank, the same bits.  Against the reference:
``tests/test_torch_seq_parallel.py``'s ``TOL`` = 1e-4 of the largest
magnitude for the gradients (recovered from its first moment after step
1: ``mu = 0.1 * g * clip``), and ``tests/test_torch_lm_train.py``'s
tolerances for the losses (1e-5; 1e-4 with int8 compression or bf16
masters) and the parameters.  With int8 compression an element within a
rounding of a half step may take the other code: parameters within the
learning rate a step.  bf16 masters round stochastically: parameters
within two bf16 ulps plus the learning rate a step.
"""
import concurrent.futures
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import torch_sharded_ranks as R  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.checkpoint import checkpointer as ref_ckpt  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.optim import optimizers as t_opt  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

TIGHT_RTOL, TIGHT_GRAD, PARAM_ATOL = 2e-6, 1e-5, 2e-5
REF_GRAD, FP32_RTOL, LOOSE_RTOL = 1e-4, 1e-5, 1e-4
BF16_ULP = 2.0 ** -7
ALL_CASES = [(w, c) for w, cs in R.CASES.items() for c in cs]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: PyTorch's default count spins badly when
    several test processes (and XLA's threads) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    arch, over, hp_over = R.CONFIGS[name]
    rc = dataclasses.replace(ref_configs.get_config(arch, "smoke"), **over)
    tc, ht = R.port_cfg(name)
    return rc, tc, ref_trainer.TrainHparams(lr=R.LR, warmup=2,
                                            total_steps=30, **hp_over), ht


_REF_INIT = {}


def _ref_state(name):
    """The reference's initial state, as the port's ``TrainState`` of
    numpy arrays (the ranks unpickle it without JAX)."""
    if name not in _REF_INIT:
        rc, _, hr, _ = _cfgs(name)
        st = ref_trainer.init_train_state(jax.random.PRNGKey(0), rc, hr)
        st = jax.tree_util.tree_map(np.asarray, st)
        _REF_INIT[name] = t_trainer.TrainState(*st)
    return _REF_INIT[name]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world size -> rank 0's results of that world's cases; the three
    worlds run at once, the unsharded oracles meanwhile here."""
    states = {name: _ref_state(name) for name in R.CONFIGS}
    started = R.start_worlds(states, str(tmp_path_factory.mktemp("worlds")))
    # the reference's compiles release the interpreter lock: overlap them
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(_oracles, name) for name in R.CONFIGS]:
            fut.result()
    return R.join_worlds(started)


# ---------------------------------------------------------------------------
# the unsharded oracles
# ---------------------------------------------------------------------------

_ORACLES = {}


def _oracles(name):
    """(the port's unsharded run, the reference's) on the global batch."""
    key = name
    if key not in _ORACLES:
        rc, tc, hr, _ = _cfgs(name)
        batches = R.batches(tc.vocab)
        port = R.run_port(name, interop.lm_train_state(
            _ref_state(name), tc, device="cpu"), batches)
        step = jax.jit(ref_trainer.make_train_step(rc, hr, None))
        rs = ref_trainer.TrainState(*jax.tree_util.tree_map(
            jnp.asarray, _ref_state(name)))
        losses, mu1 = [], None
        for x, y in batches:
            rs, m = step(rs, {"inputs": jnp.asarray(x),
                              "labels": jnp.asarray(y)})
            losses.append(float(m["loss"]))
            if mu1 is None:
                clip = min(1.0, hr.clip_norm / (float(m["grad_norm"]) + 1e-9))
                mu1 = [np.asarray(g, np.float32) / ((1 - hr.b1) * clip)
                       for g in jax.tree_util.tree_leaves(rs.mu)]
        params = [np.asarray(p, np.float32)
                  for p in jax.tree_util.tree_leaves(rs.params)]
        _ORACLES[key] = (port, (losses, mu1, params))
    return _ORACLES[key]


def _grads_close(got, want, frac):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= frac * scale, (i, err, scale)


@pytest.mark.parametrize("world,case", ALL_CASES,
                         ids=[f"{c[0]}@{c[1]}x{c[2]}" for _, c in ALL_CASES])
def test_sharded_step_tracks_both_packages(ranks, world, case):
    name, data, model = case
    got = ranks[world][f"{name}@{data}x{model}"]
    (losses, norms, g0, state), (r_losses, r_g0, r_params) = \
        _oracles(name)
    _, tc, _, ht = _cfgs(name)
    compressed = ht.compress_grads
    bf16 = tc.param_dtype == "bfloat16"
    if world == 1:      # a one-rank mesh: the unsharded step's bits
        assert got["losses"] == losses and got["norms"] == norms
        assert all(torch.equal(a, b) for a, b in
                   zip(got["grads"], tree_leaves(g0)))
        assert all(torch.equal(a, b) for a, b in
                   zip(got["params"], tree_leaves(state.params)))
    rtol = LOOSE_RTOL if compressed else TIGHT_RTOL
    np.testing.assert_allclose(got["losses"], losses, rtol=rtol)
    np.testing.assert_allclose(got["norms"], norms, rtol=rtol)
    _grads_close(got["grads"], [g.numpy() for g in tree_leaves(g0)],
                 TIGHT_GRAD)
    p_atol = R.LR * R.STEPS if (compressed or bf16) else PARAM_ATOL
    p_rtol = 2 * BF16_ULP if bf16 else 0.0
    for a, b in zip(got["params"], tree_leaves(state.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=p_rtol, atol=p_atol)
    # against the reference's make_train_step(cfg, hp, None)
    np.testing.assert_allclose(got["losses"], r_losses,
                               rtol=LOOSE_RTOL if (compressed or bf16)
                               else FP32_RTOL)
    if not (compressed or tc.moment_dtype == "bfloat16"):
        _grads_close(got["grads"], r_g0, REF_GRAD)
    for a, b in zip(got["params"], r_params):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=p_rtol,
                                   atol=p_atol)


@pytest.mark.parametrize("case", [("gemma3-flash", 2, 2),
                                  ("gemma3-chunked-2micro", 1, 4),
                                  ("nemotron-bf16", 2, 2)], ids=str)
def test_collectives_equal_the_dry_runs_count(ranks, case):
    """Each rank's first step over gloo ran the collectives, kind by kind
    (calls, wire bytes, operand and output bytes, mesh axes), that the dry
    run counts for that rank on the meta device (a fake group, the
    counting route: ``launch.dryrun``)."""
    from repro_torch.launch import dryrun
    name, data, model = case
    got = ranks[data * model][f"{name}@{data}x{model}"]["collectives"]
    cfg, hp = R.port_cfg(name)
    for rank, real in enumerate(got):
        dry = dryrun.dry_cell(cfg, hp, {"data": data, "model": model}, rank,
                              kind="train", seq_len=R.SEQ,
                              global_batch=R.BATCH)["graph"]
        assert sum(r["count"] for r in real.values()) > 0
        for kind, rec in real.items():
            assert rec["count"] == dry.n_collectives[kind], (rank, kind)
            assert rec["bytes"] == dry.collective_bytes[kind], (rank, kind)
            assert rec["axes"] == dry.collective_axes[kind], (rank, kind)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_backward_and_shard_units(ranks, world):
    """gradcheck of each differentiable collective; the max; the int8
    shard and the global norm over shards equal the unsharded ones bit
    for bit."""
    res = ranks[world]
    assert all(res["gradcheck"]), res["gradcheck"]
    assert all(res["shard_units"]), res["shard_units"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tied", [False, True])
def test_vocab_sharded_cross_entropy(ranks, world, tied):
    """The vocab-sharded loss and its gradients (the hidden state's and the
    table's or the head's) against ``chunked_cross_entropy``."""
    loss, cnt, g_hid, g_w, w, hid, labels, cfg = ranks[world]["ce"][tied]
    key = "tokens" if tied else "head"
    wt = w.clone().requires_grad_(True)
    ht = hid.clone().requires_grad_(True)
    embed = {"tokens": wt} if tied else {"tokens": torch.zeros(1), key: wt}
    want, want_cnt = t_layers.chunked_cross_entropy(embed, ht, labels, cfg)
    want.backward()
    assert cnt == float(want_cnt)
    np.testing.assert_allclose(loss, float(want), rtol=2e-6)
    for got, w_ in ((g_hid, ht.grad), (g_w, wt.grad)):
        scale = float(w_.abs().max())
        assert float((got - w_).abs().max()) <= 1e-5 * scale


def test_refusals_name_their_items(ranks):
    """The MoE (batch split), SSM and RG-LRU (model = 2) blocks take a
    sharded step now (ROADMAP A12.8), and so do heads that do not divide
    over model (A12.6, the sequence-sharded route); what still refuses
    names its item: sequence axes other than the tp axes, a sequence that
    does not divide."""
    got = ranks[2]["refusals"]
    for name in ("moe", "ssm", "rglru", "heads"):
        assert got[name] == "ran", got[name]
    assert got["sp_axes"].startswith("NotImplementedError") and \
        "tp axes" in got["sp_axes"]
    assert got["ragged"].startswith("ValueError") and \
        "does not divide" in got["ragged"]


def test_fused_adamw_shard_equals_the_slice():
    """A shard's stochastically rounded update (a bf16 leaf past the
    chunking threshold) equals the slice of the unsharded update bit for
    bit, for shards along dim 0 (within and across chunks) and dim 1."""
    gen = torch.Generator().manual_seed(3)
    shape = (32, 6, 10)      # chunk_threshold 1,024: 16 chunks of 2 rows
    p = (torch.randn(shape, generator=gen) * 0.1).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen).to(torch.bfloat16)
    m = torch.randn(shape, generator=gen) * 0.01
    v = torch.rand(shape, generator=gen) * 0.01
    kw = dict(lr=torch.tensor(1e-3), weight_decay=0.1, stochastic_round=True,
              sr_key=torch.tensor(5, dtype=torch.int32), chunk_threshold=1024,
              g_scale=torch.tensor(0.5))
    step = torch.tensor(4, dtype=torch.int32)
    whole = [t.clone() for t in (p, m, v)]
    t_opt.fused_adamw_apply([whole[0]], [g], [whole[1]], [whole[2]], step,
                            **kw)
    for sl in ((slice(0, 16),), (slice(8, 12),), (slice(3, 5),),
               (slice(None), slice(2, 4)), (slice(30, 32), slice(0, 3))):
        loc = [t[sl].clone() for t in (p, m, v)]
        offsets = tuple((s.start or 0) for s in sl) + (0,) * (3 - len(sl))
        t_opt.fused_adamw_apply([loc[0]], [g[sl].clone()], [loc[1]],
                                [loc[2]], step, shards=[(shape, offsets)],
                                **kw)
        for a, b in zip(loc, whole):
            assert torch.equal(a, b[sl]), sl
    # below the threshold: one chunk, the flat index of the whole leaf
    small = (8, 5)
    p2 = (torch.randn(small, generator=gen) * 0.1).to(torch.bfloat16)
    g2 = torch.randn(small, generator=gen).to(torch.bfloat16)
    z = [torch.zeros(small), torch.zeros(small)]
    want = p2.clone()
    t_opt.fused_adamw_apply([want], [g2], [z[0].clone()], [z[1].clone()],
                            step, **kw)
    loc = p2[:, 1:4].clone()
    t_opt.fused_adamw_apply([loc], [g2[:, 1:4].clone()],
                            [torch.zeros(8, 3)], [torch.zeros(8, 3)], step,
                            shards=[(small, (0, 1))], **kw)
    assert torch.equal(loc, want[:, 1:4])


def test_checkpoint_restores_across_meshes_and_packages(ranks):
    """Saved at (2, 2): restored at (4, 1), (2, 2) and (1, 4) on the
    ranks, unsharded here and by the reference's ``restore_checkpoint``:
    the same bits as the gathered state."""
    res = ranks[4]["checkpoint"]
    saved = res["saved"]
    for key in ("4x1", "2x2", "1x4"):
        assert all(torch.equal(a, b) for a, b in zip(res[key], saved)), key
    _, tc, hr, ht = _cfgs("gemma3-chunked-2micro")
    d = pathlib.Path(ranks[4]["dir"]) / "ckpt"
    template = t_trainer.init_train_state(tc, ht, device="meta")
    whole = t_ckpt.restore_checkpoint(d, 2, template, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole), saved))
    ref_template = jax.eval_shape(lambda: ref_trainer.init_train_state(
        jax.random.PRNGKey(0), _cfgs("gemma3-chunked-2micro")[0], hr))
    ref = ref_ckpt.restore_checkpoint(d, 2, ref_template)
    for a, b in zip(jax.tree_util.tree_leaves(ref), saved):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    manifest = t_ckpt.json.loads((d / "step_00000002" / "manifest.json")
                                 .read_text())
    assert manifest["n_processes"] == 4
    specs = {m["name"]: m["spec"] for m in manifest["leaves"]}
    assert specs[".params/['units']/['block0']/['mixer']/['wq']"] == \
        [None, "data", "model"]


# ---------------------------------------------------------------------------
# launch.train on two ranks
# ---------------------------------------------------------------------------

def _drive(argv):
    mp.spawn(R.driver_rank, args=(2, R.free_port(), argv), nprocs=2,
             join=True)


def test_driver_trains_checkpoints_and_resumes_on_two_ranks(tmp_path):
    """``launch.train``'s ``main`` under a torchrun-like environment, 2
    CPU ranks at (1, 2): an uninterrupted run of 4 steps against one
    stopped after step 2 (as a preemption would) and resumed on a fresh
    spawn: the final checkpoints hold the same bits."""
    base = ["--arch", "gemma3_12b", "--variant", "smoke", "--steps", "4",
            "--global-batch", "4", "--seq-len", "64", "--device", "cpu",
            "--mesh", "1", "2", "--ckpt-every", "2", "--log-every", "1"]
    _drive(base + ["--ckpt-dir", str(tmp_path / "a")])
    _drive(base + ["--ckpt-dir", str(tmp_path / "b"), "--stop-at", "2"])
    assert t_ckpt.latest_step(tmp_path / "b") == 2
    _drive(base + ["--ckpt-dir", str(tmp_path / "b")])
    cfg = t_configs.get_config("gemma3_12b", "smoke")
    template = t_trainer.init_train_state(cfg, t_trainer.TrainHparams(),
                                          device="meta")
    a = t_ckpt.restore_checkpoint(tmp_path / "a", 4, template, device="cpu")
    b = t_ckpt.restore_checkpoint(tmp_path / "b", 4, template, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert int(a.step) == 4


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        t_train.main(["--arch", "gemma3_12b", "--variant", "smoke",
                      "--production-mesh", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 512 ranks"):
        t_train.main(["--arch", "gemma3_12b", "--variant", "smoke",
                      "--multipod", "--device", "cpu"])
