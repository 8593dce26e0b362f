"""Port parity: mixture-of-experts (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe`` on the CPU, and the counterpart of
``tests/test_moe_dispatch.py`` case for case.

The reference's weights are carried across through numpy; inputs are
made with numpy and handed to both packages.

Exactness.  Routing picks, slots and drops are integer results and must
equal the reference's exactly: both packages compute the router logits
in fp32 from the same inputs, and the test inputs keep every top-k pick
clear of a near tie (the gap between the k-th and the (k+1)-th
probability is checked to be far above fp32 roundings), except the
deliberate exact ties of an all-zero router input, which both must break
towards the lowest expert.  ``moe_dropped``, the fp32 share 1 - count/n
of those drops, is held within one rounding (2^-24): the port computes
1 - count * fp32(1/n) in one fused multiply-add, as XLA compiles the
reference's model (``tests/test_torch_lm_blocks.py`` holds that sum over
blocks exactly), but XLA fuses the reference's ``moe_mlp`` jitted alone
only at some shapes.  Tolerances for the float outputs: the
same fp32 operations summed in other orders, a few 1e-7 relative through
one layer: ``TOL`` = 1e-5 relative and absolute for the outputs and the
aux losses.  Against the dense (no-dispatch) reference the reference
test's own rtol 2e-4 / atol 2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import config as ref_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

TOL = 1e-5
DENSE_RTOL, DENSE_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tiny_cfgs(e=8, k=2, d=16, ff=32, **moe):
    """The reference test's ``tiny_cfg`` from both packages."""
    def make(pkg):
        return pkg.ModelConfig(
            name="t", n_layers=2, d_model=d, n_heads=2, n_kv_heads=2,
            head_dim=8, d_ff=ff, vocab=64, dtype="float32",
            moe=pkg.MoECfg(num_experts=e, top_k=k, d_ff_expert=ff, **moe))
    return make(ref_config), make(t_config)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _params(rc, seed=0):
    """The reference's ``init_moe`` draws, as numpy and as the port's."""
    ref = _np(ref_moe.init_moe(jax.random.PRNGKey(seed), rc))
    return ref, jax.tree_util.tree_map(torch.from_numpy, ref)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def dense_moe_reference(params, x, cfg):
    """The reference test's dense reference in torch: every expert on
    every token, weighted by the normalized top-k probabilities."""
    m = cfg.moe
    probs = torch.softmax(x @ params["router"], -1)
    top_w, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    g = torch.einsum("bsd,edf->bsef", x, params["gate"])
    u = torch.einsum("bsd,edf->bsef", x, params["up"])
    y_all = torch.einsum("bsef,efd->bsed", torch.nn.functional.silu(g) * u,
                         params["down"])
    w_full = torch.zeros(probs.shape).scatter_add(-1, top_i, top_w)
    return torch.einsum("bse,bsed->bsd", w_full, y_all)


def ref_slots(top_i, e, cap):
    """The reference's slotting lines (``repro.models.moe.moe_mlp``), as
    jax runs them: the slot of every (token, choice) pair and the valid
    mask in sorted order."""
    b, s, k = top_i.shape
    flat_e = top_i.reshape(b, s * k)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, se, side="left"))(
        sorted_e)
    pos = jnp.arange(s * k)[None, :] - first
    valid = pos < cap
    slot_sorted = jnp.where(valid, sorted_e * cap + pos, e * cap)
    slot = jax.vmap(lambda sf, o, v: sf.at[o].set(v))(
        jnp.zeros_like(slot_sorted), order, slot_sorted)
    return np.asarray(slot), np.asarray(valid)


def _clear_picks(probs, k):
    """The k-th and (k+1)-th probabilities of every token lie far apart."""
    top = np.sort(np.asarray(probs), -1)[..., ::-1]
    if k < top.shape[-1]:
        assert (top[..., k - 1] - top[..., k]).min() > 1e-5


def _ref_moe_mlp(ref_p, x, rc, exact=False):
    """The reference's ``moe_mlp`` jitted, as its model runs it."""
    return jax.jit(functools.partial(ref_moe.moe_mlp, cfg=rc,
                                     exact_capacity=exact))(
        jax.tree_util.tree_map(jnp.asarray, ref_p), jnp.asarray(x))


def _close_dropped(got_aux, want_aux):
    assert abs(float(got_aux["moe_dropped"]) -
               float(want_aux["moe_dropped"])) <= 2.0 ** -24


def _check_against_reference(rc, tc, ref_p, t_p, x, exact):
    want, want_aux = _ref_moe_mlp(ref_p, x, rc, exact)
    got, got_aux = t_moe.moe_mlp(t_p, torch.from_numpy(x), tc,
                                 exact_capacity=exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the integer results: picks, slots, drops
    logits = x @ ref_p["router"]
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    _clear_picks(probs, rc.moe.top_k)
    _, ref_i = jax.lax.top_k(probs, rc.moe.top_k)
    _, _, _, top_i = t_moe.route(t_p, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    cap = t_moe.capacity(tc, x.shape[1], exact)
    slot, valid = t_moe.dispatch_slots(top_i, tc.moe.num_experts, cap)
    want_slot, want_valid = ref_slots(ref_i, rc.moe.num_experts, cap)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    _close_dropped(got_aux, want_aux)
    assert int(valid.sum()) == int(want_valid.sum())
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(got_aux[key]), float(want_aux[key]),
                                   rtol=TOL, err_msg=key)
    return got_aux


# ---------------------------------------------------------------------------
# tests/test_moe_dispatch.py, case for case
# ---------------------------------------------------------------------------

class TestMoEDispatch:
    @pytest.mark.parametrize("e,k,s", [(8, 2, 16), (4, 1, 8), (16, 4, 32)])
    def test_exact_capacity_matches_dense(self, e, k, s):
        rc, tc = tiny_cfgs(e=e, k=k)
        ref_p, t_p = _params(rc)
        x = _x((2, s, tc.d_model))
        y, aux = t_moe.moe_mlp(t_p, torch.from_numpy(x), tc,
                               exact_capacity=True)
        y_ref = dense_moe_reference(t_p, torch.from_numpy(x), tc)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(),
                                   rtol=DENSE_RTOL, atol=DENSE_ATOL)
        assert float(aux["moe_dropped"]) == 0.0
        _check_against_reference(rc, tc, ref_p, t_p, x, exact=True)

    def test_capacity_drops_reported(self):
        rc, tc = tiny_cfgs(e=8, k=2, capacity_factor=0.5)
        ref_p, t_p = _params(rc)
        x = _x((2, 64, tc.d_model))
        aux = _check_against_reference(rc, tc, ref_p, t_p, x, exact=False)
        assert float(aux["moe_dropped"]) > 0.0

    def test_lb_loss_uniform_router_is_one(self):
        """With a zero router (uniform probs), the switch LB loss == 1;
        every expert ties, and the pick is expert 0, as jax's top_k picks
        the lowest index among ties."""
        rc, tc = tiny_cfgs(e=8, k=1)
        ref_p, t_p = _params(rc)
        t_p["router"] = torch.zeros_like(t_p["router"])
        x = _x((2, 256, tc.d_model))
        _, aux = t_moe.moe_mlp(t_p, torch.from_numpy(x), tc,
                               exact_capacity=True)
        assert abs(float(aux["moe_lb_loss"]) - 1.0) < 0.05
        assert not t_moe.route(t_p, torch.from_numpy(x), tc)[3].any()

    @given(st.integers(0, 1000))
    @settings(max_examples=8, deadline=None)
    def test_property_combine_weights_sum(self, seed):
        rc, tc = tiny_cfgs(e=4, k=2)
        _, t_p = _params(rc)
        x = torch.from_numpy(_x((1, 8, tc.d_model), seed))
        y, _ = t_moe.moe_mlp(t_p, x, tc, exact_capacity=True)
        y_ref = dense_moe_reference(t_p, x, tc)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(),
                                   rtol=DENSE_RTOL, atol=DENSE_ATOL)


# ---------------------------------------------------------------------------
# moe_mlp against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick_400b_a17b"])
@pytest.mark.parametrize("exact", [False, True])
def test_moe_mlp_matches_the_reference(arch, exact):
    """The smoke configs' MoE layers (olmoe: 8 experts, top-2; llama4: top-1
    and a shared expert) in fp32 masters, 2 x 48 tokens: with the
    capacity (olmoe C = 30, llama4 C = 8) and dropless."""
    rc = dataclasses.replace(ref_configs.get_config(arch, "smoke"),
                             param_dtype="float32")
    tc = dataclasses.replace(t_configs.get_config(arch, "smoke"),
                             param_dtype="float32")
    ref_p, t_p = _params(rc, seed=3)
    assert ("shared" in t_p) == tc.moe.shared_expert
    x = _x((2, 48, tc.d_model), seed=4)
    aux = _check_against_reference(rc, tc, ref_p, t_p, x, exact)
    if exact:      # no drop: 1 - n * fp32(1/n), within a rounding of 0
        assert abs(float(aux["moe_dropped"])) <= 2.0 ** -24


def test_capacity_is_the_reference_float_ceiling():
    """C = max(1, int(-(-s * k * cf // e))) across factors, including ones
    whose product is not exact in binary."""
    for cf in (0.5, 1.0, 1.1, 1.25, 1.3, 2.0):
        for s, k, e in ((16, 2, 8), (2048, 8, 64), (2048, 1, 128),
                        (7, 3, 5), (1, 1, 64)):
            _, tc = tiny_cfgs(e=e, k=k, capacity_factor=cf)
            assert t_moe.capacity(tc, s) == \
                max(1, int(-(-s * k * cf // e)))
            assert t_moe.capacity(tc, s, exact=True) == s * k


def test_all_zero_inputs_tie_to_the_lowest_experts():
    """An all-zero router input ties every expert: jax's top_k takes the
    lowest indices, and so must the port, slots and drops included (at
    C = 2 every token's pairs crowd experts 0 and 1)."""
    rc, tc = tiny_cfgs(e=8, k=2, capacity_factor=0.5)
    ref_p, t_p = _params(rc)
    x = np.zeros((2, 8, tc.d_model), np.float32)
    x[1, ::2] = _x((4, tc.d_model))          # a row mixing ties and picks
    want, want_aux = _ref_moe_mlp(ref_p, x, rc)
    got, got_aux = t_moe.moe_mlp(t_p, torch.from_numpy(x), tc)
    _, ref_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ ref_p["router"]),
                                            -1), 2)
    top_i = t_moe.route(t_p, torch.from_numpy(x), tc)[3]
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(top_i[0].numpy(), [[0, 1]] * 8)
    cap = t_moe.capacity(tc, 8)
    slot, _ = t_moe.dispatch_slots(top_i, 8, cap)
    np.testing.assert_array_equal(slot.numpy(), ref_slots(ref_i, 8, cap)[0])
    _close_dropped(got_aux, want_aux)
    assert float(got_aux["moe_dropped"]) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_gradients_match_the_reference():
    """d(sum of outputs + lb + z) / d(router, experts, input) through the
    dispatch (its scatter and gather) against ``jax.grad``, with drops."""
    rc, tc = tiny_cfgs(e=8, k=2, capacity_factor=0.75)
    ref_p, t_p = _params(rc, seed=5)
    x = _x((2, 24, tc.d_model), seed=6)

    def ref_loss(p, x):
        y, aux = ref_moe.moe_mlp(p, x, rc)
        return y.sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]

    want = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, ref_p), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in t_p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_mlp(leaves, xt, tc)
    (y.sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    assert float(aux["moe_dropped"]) > 0
    for k in leaves:
        g = np.asarray(want[0][k])
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
    g = np.asarray(want[1])
    np.testing.assert_allclose(xt.grad.numpy(), g, rtol=1e-4,
                               atol=1e-5 * np.abs(g).max())


def test_expert_stacks_cast_a_slice_at_a_time(monkeypatch):
    """bf16 expert stacks under fp32 compute (llama4's smoke config): cast
    three experts at a time, the outputs and gradients equal the whole
    stack's cast, bit for bit (the experts are independent)."""
    tc = t_configs.get_config("llama4_maverick_400b_a17b", "smoke")
    assert tc.master_dtype == torch.bfloat16
    p = t_moe.init_moe(torch.Generator().manual_seed(0), tc, "cpu")
    x = torch.from_numpy(_x((2, 40, tc.d_model), seed=7))

    def run():
        leaves = {k: v.clone().requires_grad_(True) if isinstance(
            v, torch.Tensor) else v for k, v in p.items()}
        y, aux = t_moe.moe_mlp(leaves, x, tc)
        (y.sum() + aux["moe_lb_loss"]).backward()
        return y.detach(), leaves["up"].grad

    whole = run()
    monkeypatch.setattr(t_moe, "CAST_SLICE", 3 * p["up"][0].numel())
    sliced = run()
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
