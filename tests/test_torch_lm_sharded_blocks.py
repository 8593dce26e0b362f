"""Port parity: the MoE, SSM and RG-LRU configs' train step under the
sharded layout (FSDP x TP over gloo ranks: the experts over ``model``, the
SSM's heads and the RG-LRU's width over ``tp``) and their
sequence-parallel forward, against the unsharded step and forward of both
packages, on the CPU.

The smoke configs of ``olmoe_1b_7b`` (8 experts, top-2), ``llama4_
maverick`` (top-1, a shared expert, bf16 masters), ``mamba2_780m`` (8 SSM
heads) and ``recurrentgemma_2b`` (RG-LRU width 64, local attention) at
every mesh of 1, 2 and 4 ranks (``torch_sharded_blocks_ranks.MESHES``:
each world one ``torch.multiprocessing`` spawn over a ``file://``
rendezvous, the three at once, the oracles meanwhile in this process).
The train cases start from the reference's initial state and take
``tests/torch_sharded_ranks.py``'s global batches (4 x 128 tokens, 3
steps), each data rank its rows; the sequence-parallel forward takes 2 x
128 tokens, each rank its shard of the batch and the sequence, weights
whole.  The reference's mesh paths fail under jax 0.9.0 (ROADMAP C): its
oracles are unsharded.

Tolerances.  Against the port's unsharded step the operations are the
same, the sums over ranks in other orders (the global aux statistics, the
gated norm's sum of squares, the row-parallel partial sums): losses and
aux terms within ``TIGHT_RTOL`` = 2e-6 relative, every gradient leaf
within ``TIGHT_GRAD`` = 1e-5 of its largest magnitude, parameters within
``PARAM_ATOL`` = 2e-5 (bf16 masters: two bf16 ulps plus the learning rate
a step); at one rank, the same bits.  The MoE's slots, kept flags and
``moe_dropped`` exactly.  Against the reference: losses within 1e-5
relative (bf16 masters 1e-4), the aux terms within 1e-5 relative,
``moe_dropped`` exactly, gradients within ``REF_GRAD`` = 1e-4 of the
largest magnitude (recovered from the first moment, fp32 moments only),
parameters as against the port.  The forward's hidden states within
1e-5 of their largest magnitude of the port's unsharded forward and
``MODEL_TOL`` = 1e-4 of the reference's.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import torch_sharded_blocks_ranks as R  # noqa: E402
import torch_sharded_ranks as SR  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.sharding import named_leaves  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

TIGHT_RTOL, TIGHT_GRAD, PARAM_ATOL = 2e-6, 1e-5, 2e-5
FP32_RTOL, LOOSE_RTOL, REF_GRAD, MODEL_TOL = 1e-5, 1e-4, 1e-4, 1e-4
BF16_ULP = 2.0 ** -7
DRIVER_LR = 3e-4
AUX = ("moe_lb_loss", "moe_z_loss")
CASES = [(arch, mesh) for world, meshes in R.MESHES.items()
         for mesh in meshes for arch in R.ARCHS]
IDS = [f"{a}@{m[0]}x{m[1]}" for a, m in CASES]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: PyTorch's default count spins badly when
    several test processes (and XLA's threads) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ref_cfg(arch, impl="chunked"):
    return dataclasses.replace(ref_configs.get_config(R.ARCHS[arch], "smoke"),
                               attn_impl=impl)


def _ref_hp():
    return ref_trainer.TrainHparams(lr=SR.LR, warmup=2, total_steps=30)


_INIT = {}


def _ref_state(arch):
    """The reference's initial state as the port's ``TrainState`` of numpy
    arrays (the ranks unpickle it without JAX)."""
    if arch not in _INIT:
        st = ref_trainer.init_train_state(jax.random.PRNGKey(0),
                                          _ref_cfg(arch), _ref_hp())
        _INIT[arch] = t_trainer.TrainState(
            *jax.tree_util.tree_map(np.asarray, st))
    return _INIT[arch]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    states = {arch: _ref_state(arch) for arch in R.ARCHS}
    started = R.start_worlds("train", states,
                             str(tmp_path_factory.mktemp("blocks")))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(_oracles, arch) for arch in R.ARCHS]:
            fut.result()
    return R.join_worlds(started)


_ORACLES = {}


def _oracles(arch):
    """The port's unsharded step, slots and forward, and the reference's
    step and forward."""
    if arch not in _ORACLES:
        cfg = R.port_cfg(arch)
        batches = SR.batches(cfg.vocab)
        state = interop.lm_train_state(_ref_state(arch), cfg, device="cpu")
        slots, aux0 = R.forward_slots(cfg, state.params, batches[0][0])
        metrics, g0, state = R.run_train(cfg, state, batches)
        fcfg = R.port_cfg(arch, "flash")
        fwd = R.seq_forward(fcfg, interop.lm_params(
            _ref_state(arch).params, fcfg, device="cpu"))

        rc, hr = _ref_cfg(arch), _ref_hp()
        step = jax.jit(ref_trainer.make_train_step(rc, hr, None))
        rs = ref_trainer.TrainState(*jax.tree_util.tree_map(
            jnp.asarray, _ref_state(arch)))
        r_metrics, mu1 = [], None
        for x, y in batches:
            rs, m = step(rs, {"inputs": jnp.asarray(x),
                              "labels": jnp.asarray(y)})
            r_metrics.append({k: float(v) for k, v in m.items()})
            if mu1 is None:
                clip = min(1.0, hr.clip_norm / (float(m["grad_norm"]) + 1e-9))
                mu1 = [np.asarray(g, np.float32) / ((1 - hr.b1) * clip)
                       for g in jax.tree_util.tree_leaves(rs.mu)]
        params = jax.tree_util.tree_map(jnp.asarray, _ref_state(arch).params)
        r_hidden, _, r_aux = jax.jit(
            lambda p, t: ref_model.forward(p, t, rc))(
                params, jnp.asarray(R.fwd_tokens(cfg)))
        _ORACLES[arch] = {
            "port": (metrics, g0, state, slots, aux0, fwd),
            "ref": (r_metrics, mu1,
                    [np.asarray(p, np.float32)
                     for p in jax.tree_util.tree_leaves(rs.params)],
                    np.asarray(r_hidden, np.float32),
                    {k: float(v) for k, v in r_aux.items()})}
    return _ORACLES[arch]


def _grads_close(got, want, frac):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= frac * scale, (i, err, scale)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_sharded_step_tracks_both_packages(ranks, arch, mesh):
    got = ranks[("train", arch, mesh)]
    o = _oracles(arch)
    metrics, g0, state, slots, _, _ = o["port"]
    r_metrics, r_g0, r_params = o["ref"][:3]
    cfg = R.port_cfg(arch)
    bf16 = cfg.param_dtype == "bfloat16"
    if mesh == (1, 1):      # a one-rank mesh: the unsharded step's bits
        assert got["metrics"] == metrics
        assert all(torch.equal(a, b) for a, b in
                   zip(got["grads"], tree_leaves(g0)))
        assert all(torch.equal(a, b) for a, b in
                   zip(got["params"], tree_leaves(state.params)))
    # the MoE's slots, kept flags and dropped share: exactly
    assert len(got["slots"]) == len(slots)
    for a, b in zip(got["slots"], slots):
        assert torch.equal(a, b)
    for i, (g, w, r) in enumerate(zip(got["metrics"], metrics, r_metrics)):
        for key, tol in (("loss", TIGHT_RTOL), ("grad_norm", TIGHT_RTOL),
                         ("nll", TIGHT_RTOL)):
            np.testing.assert_allclose(g[key], w[key], rtol=tol,
                                       err_msg=f"step {i + 1} {key}")
        for key in AUX:
            np.testing.assert_allclose(g[key], w[key], rtol=TIGHT_RTOL,
                                       atol=1e-30, err_msg=f"{i} {key}")
            np.testing.assert_allclose(g[key], r[key], rtol=FP32_RTOL,
                                       atol=1e-30, err_msg=f"{i} {key}")
        assert g["moe_dropped"] == w["moe_dropped"] == r["moe_dropped"], i
        np.testing.assert_allclose(g["loss"], r["loss"],
                                   rtol=LOOSE_RTOL if bf16 else FP32_RTOL)
    _grads_close(got["grads"], [g.numpy() for g in tree_leaves(g0)],
                 TIGHT_GRAD)
    if cfg.moment_dtype != "bfloat16":
        _grads_close(got["grads"], r_g0, REF_GRAD)
    p_atol = SR.LR * SR.STEPS if bf16 else PARAM_ATOL
    p_rtol = 2 * BF16_ULP if bf16 else 0.0
    for a, b, r in zip(got["params"], tree_leaves(state.params), r_params):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=p_rtol, atol=p_atol)
        np.testing.assert_allclose(a.float().numpy(), r, rtol=p_rtol,
                                   atol=p_atol)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_sequence_parallel_forward(ranks, arch, mesh):
    """The forward under ``use_rules`` (each rank its shard of the batch
    and the sequence, weights whole): the blocks gather the sequence, run
    whole and keep their rows; the MoE's aux over the global batch."""
    hidden, aux = ranks[("fwd", arch, mesh)]
    want, want_aux = _oracles(arch)["port"][5]
    r_hidden, r_aux = _oracles(arch)["ref"][3:]
    scale = float(want.abs().max())
    assert float((hidden - want).abs().max()) <= 1e-5 * scale
    np.testing.assert_allclose(hidden.numpy(), r_hidden, rtol=0,
                               atol=MODEL_TOL * float(np.abs(r_hidden).max()))
    for key in AUX:
        np.testing.assert_allclose(aux[key], want_aux[key], rtol=TIGHT_RTOL,
                                   atol=1e-30)
        np.testing.assert_allclose(aux[key], r_aux[key], rtol=FP32_RTOL,
                                   atol=1e-30)
    assert aux["moe_dropped"] == want_aux["moe_dropped"] == \
        r_aux["moe_dropped"]


def test_capacity_drops_under_sp(ranks):
    """olmoe at (1, 2) and (2, 2): its capacity drops pairs in every step
    (``moe_dropped`` > 0), a share over the global batch equal to the
    unsharded step's, slot for slot."""
    metrics = _oracles("olmoe")["port"][0]
    assert all(m["moe_dropped"] > 0 for m in metrics)
    for mesh in ((1, 2), (2, 2), (1, 4)):
        got = ranks[("train", "olmoe", mesh)]
        assert [m["moe_dropped"] for m in got["metrics"]] == \
            [m["moe_dropped"] for m in metrics]
        kept = [int(t[1].sum()) for t in got["slots"]]
        assert kept and all(k < t[1].numel() for k, t in
                            zip(kept, got["slots"]))


def test_ssm_norm_and_conv_off_the_head_boundary(ranks):
    """mamba2 at model = 4: its packed x | B | C conv taps shard at 160 /
    4 = 40 channels, not on the 32-channel boundary of its rank's two
    heads; the gated RMSNorm's sum of squares spans every head.  The
    conv taps' and the norm scale's gradients, gathered, equal the
    unsharded step's."""
    cfg = R.port_cfg("mamba2")
    d_in = cfg.ssm.expand * cfg.d_model
    heads = d_in // cfg.ssm.head_dim
    got = ranks[("train", "mamba2", (1, 4))]
    conv = got["local_shapes"]["units/block0/mixer/conv_w"]
    assert conv[-1] == (d_in + 2 * cfg.ssm.d_state) // 4
    assert conv[-1] % (heads // 4 * cfg.ssm.head_dim)
    g0 = _oracles("mamba2")["port"][1]
    names = ["/".join(map(str, p)) for p, _ in named_leaves(g0)]
    for name in ("units/block0/mixer/conv_w",
                 "units/block0/mixer/norm_scale"):
        i = names.index(name)
        want = tree_leaves(g0)[i]
        assert float((got["grads"][i] - want).abs().max()) <= \
            TIGHT_GRAD * float(want.abs().max()), name


def test_rglru_gates_over_tp(ranks):
    """recurrentgemma at model = 2 and 4: the gates contract the conv'd x
    over the whole width (``w_a`` / ``w_i`` column-split): the gate
    matrices' and the input projection's gradients, gathered, equal the
    unsharded step's."""
    g0 = _oracles("recurrentgemma")["port"][1]
    names = ["/".join(map(str, p)) for p, _ in named_leaves(g0)]
    for mesh in ((1, 2), (1, 4)):
        got = ranks[("train", "recurrentgemma", mesh)]
        assert got["local_shapes"]["units/block0/mixer/w_a"][-1] == \
            64 // mesh[1]
        for leaf in ("w_a", "w_i", "in_x", "b_a", "lam"):
            i = names.index(f"units/block0/mixer/{leaf}")
            want = tree_leaves(g0)[i]
            assert float((got["grads"][i] - want).abs().max()) <= \
                TIGHT_GRAD * float(want.abs().max()), (mesh, leaf)


def test_ssm_heads_that_do_not_divide_run_whole(ranks):
    """mamba2 with 2 heads of 64 at model = 4: the heads do not divide,
    so every rank runs the whole block (``conv_w`` and ``out_proj``
    gathered, each rank its rows): the step's loss, gradients and the
    served logits equal the unsharded ones."""
    got = ranks["ssm_fallback"]
    assert got["specs"]["out_proj"][1] == "model"
    sh, wh = got["sharded"], got["whole"]
    np.testing.assert_allclose(sh["loss"], wh["loss"], rtol=TIGHT_RTOL)
    _grads_close(sh["grads"], [g.numpy() for g in wh["grads"]], TIGHT_GRAD)
    scale = float(wh["logits"].abs().max())
    assert float((sh["logits"] - wh["logits"]).abs().max()) <= \
        1e-5 * scale


@pytest.mark.parametrize("arch", list(R.ARCHS))
def test_driver_trains_the_blocks_on_two_ranks(tmp_path, arch):
    """``launch.train``'s ``main`` in a torchrun-like environment, 2 CPU
    ranks at (1, 2) (the experts, the SSM's heads, the RG-LRU's width over
    model): 2 steps and a checkpoint, whose parameters equal one process's
    run of the same command (fp32 within ``PARAM_ATOL``; bf16 masters
    within two bf16 ulps plus the learning rate a step)."""
    base = ["--arch", R.ARCHS[arch], "--variant", "smoke", "--steps", "2",
            "--global-batch", "4", "--seq-len", "64", "--device", "cpu",
            "--ckpt-every", "2", "--log-every", "1", "--lr", str(DRIVER_LR)]
    mp.spawn(SR.driver_rank, args=(2, SR.free_port(), base + [
        "--mesh", "1", "2", "--ckpt-dir", str(tmp_path / "ranks")]),
        nprocs=2, join=True)
    t_train.main(base + ["--ckpt-dir", str(tmp_path / "one")])
    cfg = t_configs.get_config(R.ARCHS[arch], "smoke")
    template = t_trainer.init_train_state(cfg, t_trainer.TrainHparams(),
                                          device="meta")
    a, b = (t_ckpt.restore_checkpoint(tmp_path / d, 2, template,
                                      device="cpu").params
            for d in ("ranks", "one"))
    bf16 = cfg.param_dtype == "bfloat16"
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(
            x.float().numpy(), y.float().numpy(),
            rtol=2 * BF16_ULP if bf16 else 0.0,
            atol=DRIVER_LR * 2 if bf16 else PARAM_ATOL)
