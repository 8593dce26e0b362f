"""Port parity: the LM stack with MoE, SSM and RG-LRU blocks against the
JAX package on the CPU, on the four smoke configs that carry them:
``olmoe_1b_7b`` (8 experts, top-2, every layer), ``llama4_maverick_400b_
a17b`` (top-1, a shared expert, MoE on every 2nd block, bf16 masters),
``mamba2_780m`` (SSM blocks, no MLP) and ``recurrentgemma_2b`` (RG-LRU
and local attention).

The reference's weights (and train state) are carried across with
``interop.lm_params`` / ``lm_train_state``; inputs are made with numpy
and handed to both packages.  Attention takes the flash route where the
sequence passes ``attn_chunk`` (the reference's Pallas kernel in
interpret mode; the port's plain version).

Tolerances (fp32 compute).  Both packages do the same operations, the
sums in other orders: logits through the 2-4 smoke layers within
``MODEL_TOL`` = 1e-4 of the largest logit (``tests/test_torch_lm.py``'s);
the loss and its nll within 1e-5 relative; the MoE aux terms within
1e-5 relative, their integer ``moe_dropped`` exactly; gradients within
1e-4 relative plus 1e-5 of the largest gradient (``tests/
test_torch_lm_train.py``'s).  The train steps: as ``tests/
test_torch_lm_train.py`` states them, fp32 losses and norms within 1e-5,
parameters within 2e-5; bf16 masters (llama4) with stochastic rounding
from the same seeds: losses and norms within 1e-4, parameters within two
bf16 ulps plus ``lr`` a step.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.data.loader import TokenBatchLoader  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.linear_model import value_and_grad  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.sharding import (AxisRules, TrainLayout,  # noqa: E402
                                         use_rules)
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

ARCHS = ["olmoe_1b_7b", "llama4_maverick_400b_a17b", "mamba2_780m",
         "recurrentgemma_2b"]
MODEL_TOL = 1e-4
RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5
PARAM_ATOL = 2e-5
LOOSE_RTOL = 1e-4
BF16_ULP = 2.0 ** -7
BATCH, PROMPT, STEPS = 2, 96, 3
LR, SEQ = 1e-3, 64
AUX = ("moe_lb_loss", "moe_z_loss", "moe_dropped")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    over.setdefault("attn_impl", "flash")
    return (dataclasses.replace(ref_configs.get_config(arch, "smoke"), **over),
            dataclasses.replace(t_configs.get_config(arch, "smoke"), **over))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, param_dtype=None):
    over = {} if param_dtype is None else {"param_dtype": param_dtype}
    rc, _ = _cfgs(arch, **over)
    return ref_model.init_model(jax.random.PRNGKey(0), rc)


# ---------------------------------------------------------------------------
# prefill + decode, and the forward's aux
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """96-token prompts (above attn_chunk 64, so prefill takes the flash
    route; 96 x top-2 = 192 <= 256 pairs, so olmoe's prefill is dropless,
    as the reference decides), then 4 greedy decode steps: every step's
    logits, the greedy ids and the final states."""
    rc, tc = _cfgs(arch)
    params = _ref_params(arch)
    prompts = np.random.default_rng(9).integers(0, rc.vocab, (BATCH, PROMPT))
    caches = ref_model.init_caches(rc, BATCH, PROMPT + STEPS + 2)
    pre = jax.jit(functools.partial(ref_model.prefill, cfg=rc))
    dec = jax.jit(functools.partial(ref_model.decode_step, cfg=rc))
    logits, caches = pre(params, jnp.asarray(prompts, jnp.int32),
                         caches=caches)
    want, want_tok = [np.asarray(logits, np.float32)], []
    for t in range(STEPS + 1):
        tok = jnp.argmax(logits[:, :rc.vocab], -1)[:, None]
        want_tok.append(np.asarray(tok))
        logits, caches = dec(params, tok, jnp.int32(PROMPT + t),
                             caches=caches)
        want.append(np.asarray(logits, np.float32))

    tparams = interop.lm_params(_np(params), tc, device="cpu")
    tcaches = t_model.init_caches(tc, BATCH, PROMPT + STEPS + 2,
                                  device="cpu")
    logits, tcaches = t_model.prefill(tparams, torch.from_numpy(prompts), tc,
                                      tcaches)
    got, got_tok = [logits.numpy()], []
    for t in range(STEPS + 1):
        tok = logits[:, :tc.vocab].argmax(-1)[:, None]
        got_tok.append(tok.numpy())
        logits, tcaches = t_model.decode_step(tparams, tok, PROMPT + t, tc,
                                              tcaches)
        got.append(logits.numpy())
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=MODEL_TOL * scale)
    np.testing.assert_array_equal(np.concatenate(got_tok, 1),
                                  np.concatenate(want_tok, 1))
    for g, w in zip(tcaches, _np(caches)):
        assert type(g).__name__ == type(w).__name__
        for gf, wf, name in zip(g, w, g._fields):
            if name == "length":
                np.testing.assert_array_equal(gf.numpy(), wf)
            else:
                np.testing.assert_allclose(gf.float().numpy(), wf,
                                           atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick_400b_a17b"])
@pytest.mark.parametrize("cached", [False, True])
def test_forward_aux_matches_reference(arch, cached):
    """The forward's MoE aux, summed over blocks and units as the
    reference sums them, at 2 x 160 tokens: without a cache the capacity
    path drops pairs; with one, 160 x top-k pairs decide (olmoe's 320 >
    256 keeps the capacity, llama4's 160 is dropless)."""
    rc, tc = _cfgs(arch)
    params = _ref_params(arch)
    x = np.random.default_rng(3).integers(0, rc.vocab, (BATCH, 160))
    rcache = ref_model.init_caches(rc, BATCH, 160) if cached else None
    hidden, _, aux = jax.jit(functools.partial(
        ref_model.forward, cfg=rc, update_cache=cached))(
            params, jnp.asarray(x), caches=rcache)
    tparams = interop.lm_params(_np(params), tc, device="cpu")
    tcache = t_model.init_caches(tc, BATCH, 160, device="cpu") \
        if cached else None
    with torch.no_grad():
        th, _, taux = t_model.forward(tparams, torch.from_numpy(x), tc,
                                      caches=tcache, update_cache=cached)
    scale = float(np.abs(np.asarray(hidden)).max())
    np.testing.assert_allclose(th.numpy(), np.asarray(hidden), rtol=0,
                               atol=MODEL_TOL * scale)
    assert float(taux["moe_dropped"]) == float(aux["moe_dropped"])
    if arch.startswith("olmoe") or not cached:
        assert float(taux["moe_dropped"]) > 0
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(aux[key]),
                                   rtol=RTOL, err_msg=key)


# ---------------------------------------------------------------------------
# the loss, its gradients, and the train step
# ---------------------------------------------------------------------------

def _batch(vocab, seed=0, batch=BATCH, seq=SEQ):
    ld = TokenBatchLoader(vocab=vocab, global_batch=batch, seq_len=seq,
                          seed=seed)
    return next(ld)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch):
    """``train_loss`` (nll plus 0.01 lb + 1e-3 z for the MoE configs) and
    its gradients through the remat units (each checkpointed unit returns
    its aux), fp32 masters, 2 x 64 tokens (the capacity path drops)."""
    rc, tc = _cfgs(arch, param_dtype="float32")
    params = _ref_params(arch, "float32")
    x, y = _batch(rc.vocab)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        functools.partial(ref_model.train_loss, cfg=rc), has_aux=True))(
            params, jnp.asarray(x), jnp.asarray(y))
    tparams = interop.lm_params(_np(params), tc, device="cpu")
    (tloss, tm), tg = value_and_grad(
        lambda p, a, b: t_model.train_loss(p, a, b, tc), tparams,
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL)
    np.testing.assert_allclose(float(tm["nll"]), float(metrics["nll"]),
                               rtol=RTOL)
    assert float(tm["tokens"]) == float(metrics["tokens"])
    for key in AUX:
        if key == "moe_dropped":
            assert float(tm[key]) == float(metrics[key]), key
        else:
            np.testing.assert_allclose(float(tm[key]), float(metrics[key]),
                                       rtol=RTOL, atol=1e-7, err_msg=key)
    if rc.moe is not None:
        assert float(tloss) > float(tm["nll"])
        assert float(tm["moe_lb_loss"]) > 0
    gl, wl = tree_leaves(tg), jax.tree_util.tree_leaves(grads)
    assert len(gl) == len(wl)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_track_the_reference(arch):
    """STEPS steps of both packages' train steps from the same state
    (``make_train_step(cfg, hp, None)``, jitted, against the port's), 2
    microbatches for the MoE configs: every step's loss, norm, nll, token
    count and aux terms, then the parameters.  llama4's smoke config keeps
    its bf16 masters, moments and accumulator, rounding stochastically;
    its fp32 router does not."""
    rc, tc = _cfgs(arch)
    kw = dict(lr=LR, warmup=1, total_steps=20,
              n_microbatches=2 if rc.moe is not None else 1)
    hr, ht = ref_trainer.TrainHparams(**kw), t_trainer.TrainHparams(**kw)
    rs = ref_trainer.init_train_state(jax.random.PRNGKey(0), rc, hr)
    ts = interop.lm_train_state(rs, tc, device="cpu")
    step_r = jax.jit(ref_trainer.make_train_step(rc, hr, None))
    step_t = t_trainer.make_train_step(tc, ht)
    bf16 = rc.param_dtype == "bfloat16"
    rtol = LOOSE_RTOL if bf16 else RTOL
    ld = TokenBatchLoader(vocab=rc.vocab, global_batch=BATCH * 2,
                          seq_len=SEQ, seed=0)
    for _ in range(STEPS):
        x, y = next(ld)
        rs, mr = step_r(rs, {"inputs": jnp.asarray(x),
                             "labels": jnp.asarray(y)})
        ts, mt = step_t(ts, {"inputs": torch.from_numpy(x),
                             "labels": torch.from_numpy(y)})
        for key in ("loss", "grad_norm", "nll", "moe_lb_loss",
                    "moe_z_loss"):
            np.testing.assert_allclose(float(mt[key]), float(mr[key]),
                                       rtol=rtol, atol=1e-7, err_msg=key)
        assert float(mt["tokens"]) == float(mr["tokens"])
        assert float(mt["moe_dropped"]) == float(mr["moe_dropped"])
    for got, want in zip(tree_leaves(ts.params),
                         jax.tree_util.tree_leaves(rs.params)):
        assert str(got.dtype).endswith(str(want.dtype))
        w = np.asarray(want, np.float32)
        if bf16 and got.dtype == torch.bfloat16:
            np.testing.assert_allclose(got.float().numpy(), w,
                                       rtol=2 * BF16_ULP, atol=LR * STEPS)
        else:
            np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                       atol=PARAM_ATOL if not bf16
                                       else LR * STEPS)
    for tree in (ts.mu, ts.nu):
        assert {str(t.dtype) for t in tree_leaves(tree)} == \
            {f"torch.{rc.moment_dtype}"}


# ---------------------------------------------------------------------------
# dtypes, refusals, the two CLIs
# ---------------------------------------------------------------------------

def test_lm_params_keep_fp32_leaves_under_bf16_masters():
    """llama4's smoke config has bf16 masters: its routers stay fp32, as
    the reference makes them, through ``lm_params``, ``lm_train_state``
    (whose moments are all ``moment_dtype``) and ``cast_params``; and so
    do the SSM's and RG-LRU's decay leaves under bf16 masters."""
    rc, tc = _cfgs("llama4_maverick_400b_a17b")
    assert tc.master_dtype == torch.bfloat16
    ref = _ref_params("llama4_maverick_400b_a17b")
    p = interop.lm_params(_np(ref), tc, device="cpu")
    for got, want in zip(tree_leaves(p), jax.tree_util.tree_leaves(ref)):
        assert str(got.dtype) == f"torch.{want.dtype}"
    assert p["units"]["block1"]["mlp"]["router"].dtype == torch.float32
    assert p["units"]["block1"]["mlp"]["up"].dtype == torch.bfloat16
    assert "router" not in p["units"]["block0"]["mlp"]
    rs = ref_trainer.init_train_state(jax.random.PRNGKey(0), rc,
                                      ref_trainer.TrainHparams())
    ts = interop.lm_train_state(rs, tc, device="cpu")
    assert {t.dtype for t in tree_leaves(ts.mu)} == {torch.bfloat16}
    cast = t_model.cast_params(p, torch.bfloat16)
    assert cast["units"]["block1"]["mlp"]["router"].dtype == torch.float32
    for arch in ("mamba2_780m", "recurrentgemma_2b"):
        cfg = dataclasses.replace(t_configs.get_config(arch, "smoke"),
                                  param_dtype="bfloat16")
        mixer = t_model.cast_params(t_model.init_model(
            cfg, device="meta"), torch.bfloat16)["units"]["block0"]["mixer"]
        for name, t in mixer.items():
            want = torch.float32 if name in t_model.FP32_LEAVES \
                else torch.bfloat16
            assert t.dtype == want, (arch, name)


@pytest.mark.parametrize("arch", ARCHS + ["gemma3_12b"])
def test_sequence_sharding_refuses_the_new_blocks(arch):
    """Since ROADMAP A12.8 the MoE, SSM and RG-LRU blocks pass the check
    under rules whose sequence axis spans 2 ranks and under the train
    layout at model = 2 and at data = 2 (their sharded forms:
    ``tests/test_torch_lm_sharded_blocks*.py``), as dense attention models
    do.  What still refuses, for every config: a layout whose sequence
    axes are not its tp axes.  (Attention heads that do not divide over
    tp run the sequence-sharded route: ``tests/test_torch_grouped_heads.
    py``.)"""
    _, tc = _cfgs(arch)
    # the check reads the mesh's axis sizes alone: a 2-rank mesh's shape
    # stands in for a process group of 2
    rules = AxisRules(mesh=SimpleNamespace(shape={"data": 1, "model": 2}),
                      rules={"sp": "model", "tp": "model",
                             "batch": "data"})
    fsdp = AxisRules(mesh=SimpleNamespace(shape={"data": 2, "model": 1}),
                     rules={"sp": "model", "tp": "model", "batch": "data",
                            "fsdp": "data"})
    other = AxisRules(mesh=SimpleNamespace(shape={"data": 2, "model": 1}),
                      rules={"sp": "data", "tp": "model", "batch": "data"})
    with use_rules(rules):
        t_model.check_supported(tc)
    t_model.check_supported(tc, TrainLayout(rules, {}))
    t_model.check_supported(tc, TrainLayout(fsdp, {}))
    t_model.check_supported(tc)       # without rules
    with pytest.raises(NotImplementedError, match="tp axes"):
        t_model.check_supported(tc, TrainLayout(other, {}))
    odd = AxisRules(mesh=SimpleNamespace(shape={"data": 1, "model": 3}),
                    rules={"sp": "model", "tp": "model", "batch": "data"})
    t_model.check_supported(tc, TrainLayout(odd, {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_new_archs(arch, tmp_path, capsys):
    """``launch.serve --arch A --variant smoke --device cpu`` and
    ``launch.train --arch A --variant smoke --device cpu`` (with a
    checkpoint)."""
    out = t_serve.serve_lm(t_serve.parser().parse_args([
        "--arch", arch, "--variant", "smoke", "--device", "cpu", "--batch",
        "2", "--prompt-len", "24", "--gen", "3"]))
    cfg = t_configs.get_config(arch, "smoke")
    assert out["generated"].shape == (2, 3)
    assert ((out["generated"] >= 0) & (out["generated"] < cfg.vocab)).all()
    state = t_train.main([
        "--arch", arch, "--variant", "smoke", "--steps", "2",
        "--global-batch", "2", "--seq-len", "32", "--device", "cpu",
        "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every",
        "2"])
    assert int(state.step) == 2
    losses = [float(line.split()[3]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
