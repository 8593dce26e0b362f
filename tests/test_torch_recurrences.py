"""Port parity: the SSD (Mamba-2) and RG-LRU recurrences and their blocks
(``repro_torch.models.ssm`` / ``rglru``) against the JAX package on the
CPU, and the counterpart of ``tests/test_recurrences.py`` case for case.

Inputs are made with ``jax.random`` as the reference test makes them (or
numpy) and handed to both packages through numpy; block weights are the
reference's ``init_ssm`` / ``init_rglru`` draws.

Tolerances.  Against the float64 sequential oracles, the reference
test's own (SSD 2e-4, RG-LRU scan 1e-5).  Against the reference:
  * the RG-LRU scan runs ``lax.associative_scan``'s recursion in the same
    order, but XLA contracts the combine's ``a2 * b1 + b2`` into fused
    multiply-adds on the CPU, which round once where the port rounds
    twice, and the port adds each chunk's carry after the chunk's scan
    (h_t = B_t + A_t h) where the reference folds it into the first step:
    within ``SCAN_TOL`` = 1e-6 relative and absolute (a few ulps through
    8 levels and the chunk carries);
  * the SSD and the blocks: the same fp32 operations summed in other
    orders (the einsum contractions, the chunk sums), a few 1e-7 relative
    through one block: ``BLOCK_TOL`` = 1e-5 relative and absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.config import ModelConfig, SSMCfg  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

SCAN_TOL = 1e-6
BLOCK_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ssm_cfgs(chunk):
    kw = dict(name="t", n_layers=2, d_model=32, n_heads=0, n_kv_heads=0,
              head_dim=0, d_ff=0, vocab=64, dtype="float32",
              block_pattern=("ssm",))
    return (ModelConfig(ssm=SSMCfg(d_state=8, d_conv=4, expand=2,
                                   head_dim=8, chunk=chunk), **kw),
            t_config.ModelConfig(ssm=t_config.SSMCfg(
                d_state=8, d_conv=4, expand=2, head_dim=8, chunk=chunk),
                **kw))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def naive_ssd(x, dt, a, bmat, cmat):
    """The reference test's float64 sequential SSM recurrence."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    hstate = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros((b, l, h, p), np.float64)
    xf, dtf, af = (np.asarray(v, np.float64) for v in (x, dt, a))
    bf, cf = np.asarray(bmat, np.float64), np.asarray(cmat, np.float64)
    for t in range(l):
        da = np.exp(dtf[:, t] * af[None])
        xb = np.einsum("bhp,bn->bhpn", dtf[:, t, :, None] * xf[:, t],
                       bf[:, t])
        hstate = hstate * da[..., None, None] + xb
        ys[:, t] = np.einsum("bhpn,bn->bhp", hstate, cf[:, t])
    return ys, hstate


def _ssd_inputs(key, b, l, h, p, n):
    x = jax.random.normal(key, (b, l, h, p))
    dt = jax.nn.softplus(jax.random.normal(jax.random.fold_in(key, 1),
                                           (b, l, h)))
    a = -jnp.exp(jax.random.normal(jax.random.fold_in(key, 2), (h,)))
    bmat = jax.random.normal(jax.random.fold_in(key, 3), (b, l, n))
    cmat = jax.random.normal(jax.random.fold_in(key, 4), (b, l, n))
    return x, dt, a, bmat, cmat


class TestSSD:
    @pytest.mark.parametrize("l,chunk", [(16, 4), (33, 8), (64, 16),
                                         (20, 32)])
    def test_chunked_matches_sequential(self, l, chunk):
        rc, tc = _ssm_cfgs(chunk)
        ins = _ssd_inputs(jax.random.PRNGKey(l * 7 + chunk), 2, l, 8, 8, 8)
        y, h_last = t_ssm._ssd_chunked(*map(_t, ins), tc)
        y_ref, h_ref = naive_ssd(*ins)
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(h_last.numpy(), h_ref, rtol=2e-4,
                                   atol=2e-4)
        want_y, want_h = ref_ssm._ssd_chunked(*ins, rc)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_h),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)

    def test_decode_state_matches_train_tail(self):
        _, tc = _ssm_cfgs(8)
        b, l, h, p, n = 1, 24, 8, 8, 8
        x, dt, a, bm, cm = map(_t, _ssd_inputs(jax.random.PRNGKey(0), b,
                                               l + 1, h, p, n))
        _, h_prefix = t_ssm._ssd_chunked(x[:, :l], dt[:, :l], a, bm[:, :l],
                                         cm[:, :l], tc)
        da = torch.exp(dt[:, l] * a[None])
        xb = torch.einsum("bhp,bn->bhpn", dt[:, l, :, None] * x[:, l],
                          bm[:, l])
        h_step = h_prefix * da[..., None, None] + xb
        y_step = torch.einsum("bhpn,bn->bhp", h_step, cm[:, l])
        y_full, _ = t_ssm._ssd_chunked(x, dt, a, bm, cm, tc)
        np.testing.assert_allclose(y_step.numpy(), y_full[:, l].numpy(),
                                   rtol=2e-4, atol=2e-4)

    def test_gradient_finite_where_the_decay_overflows(self):
        """dt = 2 and a = -1, -2 over a 64-token chunk: exp(cs_i - cs_j)
        above the diagonal reaches exp(252), inf in fp32.  The forward is
        the reference's exactly; the reference's gradient is NaN (0 * inf
        in the masked product's backward), the port's finite and within
        1e-4 of the float64 sequential recurrence's."""
        rc, tc = _ssm_cfgs(64)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((1, 64, 2, 4)).astype(np.float32)
        dt = np.full((1, 64, 2), 2.0, np.float32)
        a = np.array([-1.0, -2.0], np.float32)
        bm, cm = (rng.standard_normal((1, 64, 4)).astype(np.float32)
                  for _ in range(2))
        want = ref_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                    rc)[0]
        got = t_ssm._ssd_chunked(*map(_t, (x, dt, a, bm, cm)), tc)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        ref_g = jax.grad(lambda b_: ref_ssm._ssd_chunked(
            jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), b_,
            jnp.asarray(cm), rc)[0].sum())(jnp.asarray(bm))
        assert not bool(jnp.isfinite(ref_g).all())
        bt = _t(bm).requires_grad_(True)
        t_ssm._ssd_chunked(_t(x), _t(dt), _t(a), bt, _t(cm), tc)[0].sum() \
            .backward()
        assert bool(torch.isfinite(bt.grad).all())
        # the float64 sequential recurrence's gradient, by autograd
        b64 = torch.from_numpy(bm.astype(np.float64)).requires_grad_(True)
        x64, dt64, a64, c64 = (torch.from_numpy(v.astype(np.float64))
                               for v in (x, dt, a, cm))
        hs, total = torch.zeros(1, 2, 4, 4, dtype=torch.float64), 0.0
        for t in range(64):
            hs = hs * torch.exp(dt64[:, t] * a64)[..., None, None] + \
                torch.einsum("bhp,bn->bhpn", dt64[:, t, :, None] * x64[:, t],
                             b64[:, t])
            total = total + torch.einsum("bhpn,bn->bhp", hs, c64[:, t]).sum()
        total.backward()
        g = b64.grad.numpy()
        np.testing.assert_allclose(bt.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max())


class TestRGLRUScan:
    def naive(self, a, bb, h0):
        a_, b_ = np.asarray(a, np.float64), np.asarray(bb, np.float64)
        h = np.asarray(h0, np.float64)
        out = np.zeros_like(b_)
        for t in range(a_.shape[1]):
            h = a_[:, t] * h + b_[:, t]
            out[:, t] = h
        return out

    @pytest.mark.parametrize("l,chunk", [(8, 4), (30, 8), (64, 256),
                                         (257, 64)])
    def test_chunked_matches_sequential(self, l, chunk):
        key = jax.random.PRNGKey(l)
        a = jax.nn.sigmoid(jax.random.normal(key, (2, l, 16)))
        bb = jax.random.normal(jax.random.fold_in(key, 1), (2, l, 16))
        h0 = jax.random.normal(jax.random.fold_in(key, 2), (2, 16))
        got = t_rglru._chunked_linear_scan(_t(a), _t(bb), _t(h0),
                                           chunk=chunk).numpy()
        np.testing.assert_allclose(got, self.naive(a, bb, h0), rtol=1e-5,
                                   atol=1e-5)
        want = ref_rglru._chunked_linear_scan(a, bb, h0, chunk=chunk)
        np.testing.assert_allclose(got, np.asarray(want), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)

    @given(st.integers(0, 10 ** 6), st.integers(1, 50))
    @settings(max_examples=10, deadline=None)
    def test_property_decay_bound(self, seed, l):
        rng = np.random.default_rng(seed)
        a = 0.9 / (1 + np.exp(-rng.standard_normal((1, l, 4))))
        bb = rng.standard_normal((1, l, 4))
        h = t_rglru._chunked_linear_scan(_t(a), _t(bb), torch.zeros(1, 4),
                                         chunk=16)
        bound = float(np.abs(bb).max()) / (1 - 0.9) + 1e-3
        assert float(h.abs().max()) <= bound


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64, 256])
def test_associative_scan_matches_lax(n):
    """The odd/even recursion at even, odd and power-of-two lengths
    against ``lax.associative_scan`` with the reference's combine."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (3, n, 5)).astype(np.float32)
    b = rng.standard_normal((3, n, 5)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                              jnp.asarray(b)), axis=1)
    got = t_rglru.associative_scan(_t(a), _t(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


# ---------------------------------------------------------------------------
# the blocks against the reference
# ---------------------------------------------------------------------------

def _block_cfgs(arch):
    rc = ref_configs.get_config(arch, "smoke")
    tc = t_configs.get_config(arch, "smoke")
    return rc, tc


def _run_blocks(arch, l, state_len, seed):
    """Both packages' block (``ssm_block`` or ``rglru_block``) on the same
    weights and numpy input: the train path (no state), a prefill that
    updates a state, and one decode step from that state."""
    rc, tc = _block_cfgs(arch)
    if arch.startswith("mamba2"):
        ref_mod, t_mod, init, blk = ref_ssm, t_ssm, "init_ssm", "ssm_block"
    else:
        ref_mod, t_mod, init = ref_rglru, t_rglru, "init_rglru"
        blk = "rglru_block"
    ref_p = _np(getattr(ref_mod, init)(jax.random.PRNGKey(seed), rc))
    t_p = jax.tree_util.tree_map(_t, ref_p)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((2, l + 1, tc.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_p)
    rfn, tfn = getattr(ref_mod, blk), getattr(t_mod, blk)
    out = {}
    out["train"] = (rfn(jp, jnp.asarray(u[:, :l]), rc)[0],
                    tfn(t_p, _t(u[:, :l]), tc)[0])
    # the prefill from a state (its length state_len), then one step
    if arch.startswith("mamba2"):
        d_in, h, p, n = ref_ssm._dims(rc)
        zero = (np.zeros((2, 3, d_in + 2 * n), np.float32),
                np.zeros((2, h, p, n), np.float32))
        r_state = ref_ssm.SSMState(jnp.asarray(zero[0]), jnp.asarray(zero[1]),
                                   jnp.int32(state_len))
        t_state = t_ssm.SSMState(_t(zero[0]), _t(zero[1]),
                                 torch.tensor(state_len, dtype=torch.int32))
    else:
        w = tc.rnn_width
        h0 = rng.standard_normal((2, w)).astype(np.float32)
        conv0 = np.zeros((2, 3, w), np.float32)
        r_state = ref_rglru.RGLRUState(jnp.asarray(h0), jnp.asarray(conv0),
                                       jnp.int32(state_len))
        t_state = t_rglru.RGLRUState(_t(h0), _t(conv0),
                                     torch.tensor(state_len,
                                                  dtype=torch.int32))
    ry, rs = rfn(jp, jnp.asarray(u[:, :l]), rc, state=r_state,
                 update_state=True)
    ty, ts = tfn(t_p, _t(u[:, :l]), tc, state=t_state, update_state=True)
    out["prefill"] = (ry, ty)
    out["prefill_state"] = (rs, ts)
    ry, rs = rfn(jp, jnp.asarray(u[:, l:]), rc, state=rs, update_state=True)
    ty, ts = tfn(t_p, _t(u[:, l:]), tc, state=ts, update_state=True)
    out["decode"] = (ry, ty)
    out["decode_state"] = (rs, ts)
    return out


def _close_state(got, want):
    for g, w, name in zip(got, want, got._fields):
        if name == "length":
            assert int(g) == int(w)
        else:
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=BLOCK_TOL, atol=BLOCK_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b"])
@pytest.mark.parametrize("l,state_len", [(40, 0), (2, 5), (1, 3)])
def test_block_matches_the_reference(arch, l, state_len):
    """40 tokens (mamba2's smoke chunk is 32: two chunks, the second
    ragged; RG-LRU's scan chunk is 256); 2 tokens, fewer than d_conv - 1,
    so the conv tail is padded; 1 token with a state, which takes the
    recurrent branch.  A prefill given a state of length ``state_len``:
    the SSD restarts from zero (the reference's behaviour), the RG-LRU
    carries the state's h."""
    out = _run_blocks(arch, l, state_len, seed=l)
    for key in ("train", "prefill", "decode"):
        want, got = out[key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL,
                                   err_msg=key)
    for key in ("prefill_state", "decode_state"):
        want, got = out[key]
        _close_state(got, want)
    assert int(out["decode_state"][1].length) == state_len + l + 1


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b"])
def test_block_bf16_keeps_fp32_state_and_gates(arch):
    """bf16 compute: the state's h stays fp32, the outputs bf16, and the
    result within a few bf16 ulps of the fp32 run's (the gates and the
    recurrence compute in fp32)."""
    rc, tc = _block_cfgs(arch)
    tc16 = dataclasses.replace(tc, dtype="bfloat16")
    mod = t_ssm if arch.startswith("mamba2") else t_rglru
    init = mod.init_ssm if mod is t_ssm else mod.init_rglru
    block = mod.ssm_block if mod is t_ssm else mod.rglru_block
    p = init(torch.Generator().manual_seed(0), tc, "cpu")
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, tc.d_model)).astype(np.float32))
    y32, s32 = block(p, u, tc, state=None, update_state=True)
    y16, s16 = block(p, u.bfloat16(), tc16, state=None, update_state=True)
    assert y16.dtype == torch.bfloat16 and s16.h.dtype == torch.float32
    assert s16.conv.dtype == torch.bfloat16
    scale = float(y32.abs().max())
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=0,
                               atol=0.05 * scale)
