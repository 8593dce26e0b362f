"""Port parity: LM training (``repro_torch.training.trainer``) against the
JAX package on the CPU.

The oracle is the reference's ``make_train_step(cfg, hp, None)`` with its
``init_train_state``, jitted; its ``build_trainer`` fails in its mesh under
jax 0.9.0 (``tests/test_trainer_integration.py``), so the driver's own
checks run in the port alone.  Weights and moments are carried across
with ``interop.lm_train_state``; batches are ``TokenBatchLoader``'s (the
same numpy draws in both packages).  The reference's flash route runs its
Pallas kernel in interpret mode; the port's, its plain version, through
the ``FlashAttention`` autograd function either way.

Tolerances.  fp32: both packages do the same operations, the sums in
other orders (a few 1e-7 relative), so losses and gradient norms agree
within ``FP32_RTOL`` = 1e-5 through 5 steps, and the parameters within
``PARAM_ATOL`` = 2e-5 (Adam normalizes each update to at most about the
learning rate, so a few-ulp gradient difference moves a parameter by a
few ulps of ``lr``).  With int8 compression an element whose
``g / scale`` lies within a rounding of a half step can take the other
int8 code, a change of one quantization step that Adam's normalized
update can turn into up to ``lr`` per step: parameters within ``lr``
times the steps, losses and norms within 1e-4.  With bf16 masters both
round stochastically from the same seeds; a p32 one rounding apart can
carry the noise over the next bf16 boundary: parameters within two bf16
ulps (2^-6 relative), losses and norms within 1e-4; and where a master
sits near zero with a gradient near zero, Adam's sign of m / sqrt(v)
follows the last bits, so such an element may differ by up to ``lr`` a
step (seen: one element of 32,768 in the embedding table).

The driver, its resume and the cross-package checkpoints are held in
``tests/test_torch_lm_resume.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.loader import TokenBatchLoader
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.training import trainer as ref_trainer
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.checkpoint import tree_paths
from repro_torch.core.linear_model import value_and_grad
from repro_torch.kernels import ops, registry
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models.sharding import make_rules
from repro_torch.optim import tree_leaves
from repro_torch.training import trainer as t_trainer

FP32_RTOL = 1e-5
PARAM_ATOL = 2e-5
LOOSE_RTOL = 1e-4
BF16_ULP = 2.0 ** -7
LR, STEPS, BATCH, SEQ = 1e-3, 5, 2, 128


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: PyTorch's default count spins badly when
    several test processes (and XLA's threads) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    return (dataclasses.replace(ref_configs.get_config(arch, "smoke"), **over),
            dataclasses.replace(t_configs.get_config(arch, "smoke"), **over))


def _hps(**over):
    kw = dict(lr=LR, warmup=2, total_steps=30, **over)
    return ref_trainer.TrainHparams(**kw), t_trainer.TrainHparams(**kw)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batches(vocab, n, seed=0, batch=BATCH, seq=SEQ):
    ld = TokenBatchLoader(vocab=vocab, global_batch=batch, seq_len=seq,
                          seed=seed)
    return [next(ld) for _ in range(n)]


def _close_tree(got, want, rtol, atol):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [
    ("gemma3_12b", dict(vocab=500, loss_chunk=16)),
    ("starcoder2_7b", dict(vocab=300, loss_chunk=24, logit_softcap=30.0)),
])
def test_chunked_cross_entropy_value_and_grads(arch, over):
    """vocab not a multiple of 256 (padded ids masked), a sequence of 40
    (not a multiple of the chunk), labels -1, vocab and beyond masked;
    gemma3's table tied, starcoder2's head untied and softcapped."""
    rc, tc = _cfgs(arch, **over)
    rng = np.random.default_rng(0)
    embed = _np(ref_layers.init_embed(jax.random.PRNGKey(1), rc))
    x = rng.standard_normal((2, 40, rc.d_model)).astype(np.float32)
    labels = rng.integers(0, rc.vocab, (2, 40)).astype(np.int32)
    labels[0, 3], labels[1, 0], labels[1, 39] = -1, rc.vocab, \
        rc.padded_vocab + 7
    labels[0, 20:30] = -1

    def ref_loss(e, x_):
        return ref_layers.chunked_cross_entropy(e, x_, jnp.asarray(labels),
                                                rc)
    je = jax.tree_util.tree_map(jnp.asarray, embed)
    nll, cnt = ref_loss(je, jnp.asarray(x))
    ge, gx = jax.grad(lambda e, x_: ref_loss(e, x_)[0], argnums=(0, 1))(
        je, jnp.asarray(x))
    te = {k: torch.tensor(v, requires_grad=True) for k, v in embed.items()}
    tx = torch.tensor(x, requires_grad=True)
    got, got_cnt = t_layers.chunked_cross_entropy(te, tx,
                                                  torch.from_numpy(labels),
                                                  tc)
    got.backward()
    assert float(got_cnt) == float(cnt) == 2 * 40 - 13
    np.testing.assert_allclose(got.item(), float(nll), rtol=FP32_RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-6)
    for k in embed:
        # an untied model's token table takes no gradient from the loss
        grad = te[k].grad if te[k].grad is not None else \
            torch.zeros_like(te[k])
        np.testing.assert_allclose(grad.numpy(), np.asarray(ge[k]),
                                   rtol=1e-4, atol=1e-6)
        # the padded vocabulary rows take no gradient
        rows = grad[rc.vocab:] if k == "tokens" else grad[:, rc.vocab:]
        assert not rows.any()


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

def _flash_grads_ref(q, k, v, window, block, g_out):
    def f(q_, k_, v_):
        return ref_flash(q_, k_, v_, window, block, True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g_out))]


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("detached", [False, True])
def test_flash_autograd_grads_equal_the_reference(window, detached,
                                                  monkeypatch):
    """q, k, v gradients through ``ops.flash_attention`` against the
    reference's custom_vjp (Pallas in interpret mode), GQA 6 over 2 heads,
    fp32.  ``detached``: the CPU route returns a tensor with no graph, as
    the card's kernel does; the gradients must arrive all the same."""
    rng = np.random.default_rng(window + detached)
    b, s, h, g, d, block = 2, 80, 6, 2, 16, 32
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    g_out = rng.standard_normal((b, s, h, d)).astype(np.float32)
    want_out, want = _flash_grads_ref(q, k, v, window, block, g_out)
    if detached:
        plain = registry.IMPLS["flash_attention"]["reference"]
        monkeypatch.setitem(registry.IMPLS["flash_attention"], "reference",
                            lambda *a, **kw: plain(*a, **kw).detach())
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ts, window=window, chunk=block)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g_out))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-5)
    for t, w in zip(ts, want):
        assert t.grad is not None and t.grad.abs().max() > 0
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4, atol=1e-5)


def test_flash_without_grad_takes_the_route_alone():
    """Serving: no graph wanted, so no autograd function and nothing
    saved.  A sharded offset under autograd (a rank's rows at q_base
    against the whole K/V) goes through ``FlashAttention``: its output and
    gradients are the rows' part of the whole sequence's."""
    q = torch.randn(1, 70, 2, 16)
    k, v = torch.randn(1, 70, 1, 16), torch.randn(1, 70, 1, 16)
    assert ops.flash_attention(q, k, v).grad_fn is None
    g = torch.randn(1, 70, 2, 16)
    g[:, :8] = 0
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    whole = ops.flash_attention(*ts, chunk=32)
    want = torch.autograd.grad(whole, ts, g)
    rows = [q[:, 8:].clone().requires_grad_(True), k.clone()
            .requires_grad_(True), v.clone().requires_grad_(True)]
    out = ops.flash_attention(*rows, q_base=8, chunk=32)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, rows, g[:, 8:])
    np.testing.assert_allclose(out.detach().numpy(),
                               whole[:, 8:].detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(got, (want[0][:, 8:],) + want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,impl", [("gemma3_12b", "chunked"),
                                       ("starcoder2_7b", "flash")])
def test_train_loss_and_grads_equal_the_reference(arch, impl):
    rc, tc = _cfgs(arch, attn_impl=impl)
    params = _np(ref_model.init_model(jax.random.PRNGKey(3), rc))
    (x, y), = _batches(rc.vocab, 1, seed=2, batch=2)

    def loss(p):
        return ref_model.train_loss(p, jnp.asarray(x), jnp.asarray(y), rc)
    (want, metrics), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = interop.lm_params(params, tc, device="cpu")
    (got, tm), tg = value_and_grad(
        lambda p, a, b: t_model.train_loss(p, a, b, tc), tp,
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=FP32_RTOL)
    assert float(tm["tokens"]) == float(metrics["tokens"]) == x.size
    np.testing.assert_allclose(float(tm["nll"]), float(metrics["nll"]),
                               rtol=FP32_RTOL)
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree_util.tree_leaves(grads))
    _close_tree(tg, grads, rtol=1e-4, atol=1e-5 * scale)


# (arch, config overrides, hparam overrides); the three heavier gemma3
# variants run from tests/test_torch_lm_train_steps.py, so that the two
# files share the work between test workers
VARIANTS = {
    "gemma3-chunked": ("gemma3_12b", {}, {}),
    "gemma3-flash-2micro": ("gemma3_12b", dict(attn_impl="flash"),
                            dict(n_microbatches=2)),
    "gemma3-compressed": ("gemma3_12b", {}, dict(compress_grads=True)),
    "gemma3-bf16-masters": ("gemma3_12b", dict(param_dtype="bfloat16"), {}),
    "starcoder2-chunked": ("starcoder2_7b", {}, {}),
    "starcoder2-flash-2micro": ("starcoder2_7b", dict(attn_impl="flash"),
                                dict(n_microbatches=2)),
}
HERE = ("gemma3-chunked", "starcoder2-chunked", "starcoder2-flash-2micro")
_REF_INIT = {}


def _ref_init(rc, hr):
    """The reference's initial state, drawn once per parameter layout."""
    key = (rc.name, rc.param_dtype, hr.compress_grads)
    if key not in _REF_INIT:
        _REF_INIT[key] = ref_trainer.init_train_state(jax.random.PRNGKey(0),
                                                      rc, hr)
    return _REF_INIT[key]


def check_train_steps(variant):
    """STEPS steps of both packages' train steps from the same state on the
    same batches: every step's loss, norm, nll and token count, then the
    parameters (tolerances in the module docstring)."""
    arch, over, hp_over = VARIANTS[variant]
    rc, tc = _cfgs(arch, **over)
    hr, ht = _hps(**hp_over)
    rs = _ref_init(rc, hr)
    ts = interop.lm_train_state(rs, tc, device="cpu")
    assert tree_paths(ts) == ref_paths(rs)
    step_r = jax.jit(ref_trainer.make_train_step(rc, hr, None))
    step_t = t_trainer.make_train_step(tc, ht)
    if hp_over.get("compress_grads"):
        rtol, p_rtol, p_atol = LOOSE_RTOL, 0.0, LR * STEPS
    elif over.get("param_dtype") == "bfloat16":
        rtol, p_rtol, p_atol = LOOSE_RTOL, 2 * BF16_ULP, LR * STEPS
    else:
        rtol, p_rtol, p_atol = FP32_RTOL, 0.0, PARAM_ATOL
    for x, y in _batches(rc.vocab, STEPS):
        rs, mr = step_r(rs, {"inputs": jnp.asarray(x),
                             "labels": jnp.asarray(y)})
        ts, mt = step_t(ts, {"inputs": torch.from_numpy(x),
                             "labels": torch.from_numpy(y)})
        for key in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(float(mt[key]), float(mr[key]),
                                       rtol=rtol, err_msg=key)
        assert float(mt["tokens"]) == float(mr["tokens"])
    assert int(ts.step) == int(rs.step) == STEPS
    _close_tree(ts.params, rs.params, rtol=p_rtol, atol=p_atol)
    for got, want in zip(tree_leaves(ts.params),
                         jax.tree_util.tree_leaves(rs.params)):
        assert str(got.dtype).endswith(str(want.dtype))
    if hp_over.get("compress_grads"):
        assert ts.ef_residual is not None and any(
            r.abs().max() > 0 for r in tree_leaves(ts.ef_residual))


@pytest.mark.parametrize("variant", HERE)
def test_train_steps_track_the_reference(variant):
    check_train_steps(variant)


def ref_paths(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return ["/".join(str(k) for k in path) for path, _ in flat]


def test_remat_is_bit_identical():
    _, tc = _cfgs("gemma3_12b", attn_impl="flash")
    (x, y), = _batches(tc.vocab, 1, batch=2)
    params = t_model.init_model(tc, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        (loss, _), grads = value_and_grad(
            lambda p, a, b: t_model.train_loss(p, a, b, cfg), params,
            torch.from_numpy(x), torch.from_numpy(y))
        out[remat] = (loss, tree_leaves(grads))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))


def test_sharded_training_raises():
    """Sharded training runs (``tests/test_torch_lm_sharded_train.py``);
    on a one-rank mesh it is the unsharded step, bit for bit; the
    production mesh refuses only for want of its 256 ranks."""
    _, tc = _cfgs("gemma3_12b")
    hp = t_trainer.TrainHparams(lr=LR, warmup=2, total_steps=30)
    rules = make_rules(make_mesh(1, 1))
    (x, y), = _batches(tc.vocab, 1, batch=2)
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    plain, mp = t_trainer.make_train_step(tc, hp)(
        t_trainer.init_train_state(tc, hp, generator=gen(), device="cpu"),
        batch)
    sharded, ms = t_trainer.make_train_step(tc, hp, rules=rules)(
        t_trainer.init_train_state(tc, hp, generator=gen(), device="cpu",
                                   rules=rules), batch)
    assert torch.equal(mp["loss"], ms["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain),
                                                 tree_leaves(sharded)))
    with pytest.raises(ValueError, match="needs 256 ranks"):
        t_train.main(["--arch", "gemma3_12b", "--production-mesh",
                      "--device", "cpu"])


@pytest.mark.parametrize("arch", ["pixtral_12b", "musicgen_large"])
def test_embedding_inputs_train_like_the_reference(arch):
    """An LM fed embeddings (the vision and audio stub frontends): the loss
    never reads the token table, whose gradient is then zero, as
    ``jax.grad`` gives it, and the step only decays it; two steps against
    the reference's ``make_train_step(cfg, hp, None)``."""
    rc, tc = _cfgs(arch)
    hr, ht = _hps()
    rs = _ref_init(rc, hr)
    ts = interop.lm_train_state(rs, tc, device="cpu")
    step_r = jax.jit(ref_trainer.make_train_step(rc, hr, None))
    step_t = t_trainer.make_train_step(tc, ht)
    rng = np.random.default_rng(11)
    for _ in range(2):
        x = rng.standard_normal((BATCH, SEQ, rc.d_model)).astype(np.float32)
        y = rng.integers(0, rc.vocab, (BATCH, SEQ)).astype(np.int32)
        rs, mr = step_r(rs, {"inputs": jnp.asarray(x),
                             "labels": jnp.asarray(y)})
        ts, mt = step_t(ts, {"inputs": torch.from_numpy(x),
                             "labels": torch.from_numpy(y)})
        for key in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(float(mt[key]), float(mr[key]),
                                       rtol=FP32_RTOL, err_msg=key)
    _close_tree(ts.params, rs.params, rtol=0.0, atol=PARAM_ATOL)
    assert float(ts.mu["embed"]["tokens"].abs().max()) == 0.0
