"""Port parity: the gradient transforms of ``repro.optim``.

Every ported schedule and transform against the reference on the same
numpy trees (a NamedTuple and a dict of float32 arrays), step by step,
each framework fed the same gradients.  Two references:

  * the reference as written, evaluated op by op (``jax.disable_jit``):
    the schedules, Adam's moments and its update are float32 elementwise
    arithmetic that the port does in the same order, with true divisions
    and correctly rounded roots, so they must match exactly (0 ulp);
  * the reference as it trains, jitted: XLA's CPU compiler rewrites the
    source (a division by a constant becomes a multiply by its rounded
    reciprocal, ``a / b / c`` becomes ``a / (b * c)``, constant factors
    fold, and ``b1 * m + (1 - b1) * g`` becomes one fused multiply-add),
    so each rewritten value moves by about one rounding, which
    cancellation magnifies where a moment or ``1 + cos`` nears zero:
    schedule values within 1e-6 relative, moments and updates within
    4e-7 relative plus 1e-6 of the leaf's largest magnitude.

Global-norm clipping sums the squares of every leaf, the reference in
float32 in XLA's order, the port in float64 (so that the norm rounds to
the same float32 on every device), so where it binds its scale (and the
clipped gradients) are held within 1e-6 relative (float32 sums of a few
thousand squares differ by a few ulps, and the square root halves that);
where it does not bind the scale is 1 and the gradients pass unchanged.
"""
import contextlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt


class Pair(NamedTuple):
    w: object
    b: object


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: (scale * rng.standard_normal(shape)).astype(
        np.float32)
    return {"p": Pair(draw(300, 7), draw(7)),
            "q": draw(50)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


# the jitted reference's rewritten arithmetic (see the module docstring)
JIT_SCHEDULE_RTOL = 1e-6
JIT_RTOL, JIT_ATOL_OF_MAX = 4e-7, 1e-6


def _assert_trees_equal(jtree, ttree, rtol=0.0, atol_of_max=0.0):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]
    tl = [x.numpy() for x in topt.tree_leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        if rtol == 0.0 and atol_of_max == 0.0:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(
                b, a, rtol=rtol, atol=atol_of_max * np.abs(a).max())


def test_tree_leaf_order_matches_reference():
    tree = _tree(0)
    jl = jax.tree_util.tree_leaves(tree)
    tl = topt.tree_leaves(_t(tree))
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), a)


SCHEDULES = [
    ("constant", lambda m: m.constant_schedule(0.05), (0, 1, 399)),
    ("cosine", lambda m: m.cosine_schedule(0.05, 400), (0, 1, 2, 200, 399,
                                                       400, 450)),
    ("cosine_short", lambda m: m.cosine_schedule(0.3, 7, 0.2), (0, 1, 6, 7)),
    ("warmup_cosine", lambda m: m.linear_warmup_cosine(1e-3, 10, 100),
     (0, 1, 9, 10, 11, 55, 99, 100)),
]


@pytest.mark.parametrize("name,make,steps", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_values(name, make, steps):
    jf, tf = make(jopt), make(topt)
    for step in steps:
        got = tf(step)
        assert got.dtype == torch.float32
        with jax.disable_jit():
            written = np.asarray(jf(jnp.int32(step)))
        assert got.numpy() == written, (name, step, got, written)
        jitted = np.asarray(jax.jit(jf)(jnp.int32(step)))
        np.testing.assert_allclose(got.numpy(), jitted,
                                   rtol=JIT_SCHEDULE_RTOL, atol=0)


@pytest.mark.parametrize("max_norm,scale", [(1.0, 1.0), (1e3, 1.0),
                                            (0.5, 1e-3)])
def test_clip_by_global_norm(max_norm, scale):
    g = _tree(1, scale)
    jt, tt = jopt.clip_by_global_norm(max_norm), topt.clip_by_global_norm(
        max_norm)
    ju, _ = jax.jit(jt.update)(_j(g), jt.init(_j(g)), _j(g), jnp.int32(0))
    tu, state = tt.update(_t(g), tt.init(_t(g)), _t(g), 0)
    assert state == ()
    gnorm = np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                        for a in jax.tree_util.tree_leaves(g)))
    binds = gnorm > max_norm
    _assert_trees_equal(ju, tu, rtol=1e-6 if binds else 0.0)
    if binds:     # clipped to max_norm
        got = np.sqrt(sum(np.sum(np.square(x.double().numpy()))
                          for x in topt.tree_leaves(tu)))
        np.testing.assert_allclose(got, max_norm, rtol=1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr", ["cosine", 0.01])
@pytest.mark.parametrize("jit", [False, True], ids=["written", "jitted"])
def test_adamw_steps(weight_decay, lr, jit):
    """Each step starts both frameworks from the reference's (params,
    state), so a rounding never compounds across steps."""
    make = lambda m: m.adamw(m.cosine_schedule(0.05, 6) if lr == "cosine"
                             else lr, weight_decay=weight_decay)
    jtx, ttx = make(jopt), make(topt)
    tol = dict(rtol=JIT_RTOL, atol_of_max=JIT_ATOL_OF_MAX) if jit else {}
    jp = _j(_tree(2))
    js = jtx.init(jp)
    _assert_trees_equal(js, ttx.init(_t(_tree(2))))
    jupd = jax.jit(jtx.update) if jit else jtx.update
    for step in range(6):
        g = _tree(10 + step, 0.1 if step % 2 else 10.0)
        tp, ts = _t(jp), _t(js)
        with contextlib.ExitStack() as stack:
            if not jit:
                stack.enter_context(jax.disable_jit())
            ju, js = jupd(_j(g), js, jp, jnp.int32(step))
            jp = jopt.apply_updates(jp, ju)
        tu, ts = ttx.update(_t(g), ts, tp, step)
        _assert_trees_equal(ju, tu, **tol)
        _assert_trees_equal(js, ts, **tol)
        _assert_trees_equal(jp, topt.apply_updates(tp, tu), **tol)


def test_adamw_bf16_moments_follow_moment_dtype():
    ttx = topt.adamw(0.01, moment_dtype=torch.bfloat16)
    tp = _t(_tree(3))
    ts = ttx.init(tp)
    assert all(x.dtype == torch.bfloat16 for x in topt.tree_leaves(ts))
    tu, ts = ttx.update(_t(_tree(4)), ts, tp, 0)
    assert all(x.dtype == torch.float32 for x in topt.tree_leaves(tu))
    assert all(x.dtype == torch.bfloat16 for x in topt.tree_leaves(ts))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_exact(momentum):
    jtx = jopt.sgd(jopt.cosine_schedule(0.1, 4), momentum=momentum)
    ttx = topt.sgd(topt.cosine_schedule(0.1, 4), momentum=momentum)
    p = _tree(5)
    jp, tp = _j(p), _t(p)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        g = _tree(20 + step)
        with jax.disable_jit():
            ju, js = jtx.update(_j(g), js, jp, jnp.int32(step))
            jp = jopt.apply_updates(jp, ju)
        tu, ts = ttx.update(_t(g), ts, tp, step)
        _assert_trees_equal(ju, tu)
        if momentum:
            _assert_trees_equal(js, ts)
        tp = topt.apply_updates(tp, tu)
        _assert_trees_equal(jp, tp)


def test_chain_of_clip_and_adamw_steps():
    """The linear tier's recipe: clipping that binds on some steps and not
    on others, then AdamW, as written.  A binding step carries the
    clip's 1e-6 into the moments and the update, which Adam's
    m / sqrt(v) can grow tenfold: from it on they are held to 1e-5
    relative; before it, exactly."""
    make = lambda m: m.chain(m.clip_by_global_norm(10.0),
                             m.adamw(m.cosine_schedule(0.05, 4)))
    jtx, ttx = make(jopt), make(topt)
    p = _tree(6)
    jp, tp = _j(p), _t(p)
    js, ts = jtx.init(jp), ttx.init(tp)
    assert js[0] == () and ts[0] == ()
    for step, scale in enumerate((0.01, 0.01, 5.0, 0.01)):
        g = _tree(30 + step, scale)
        with jax.disable_jit():
            ju, js = jtx.update(_j(g), js, jp, jnp.int32(step))
            jp = jopt.apply_updates(jp, ju)
        tu, ts = ttx.update(_t(g), ts, tp, step)
        rtol = 0.0 if step < 2 else 1e-5
        _assert_trees_equal(ju, tu, rtol=rtol)
        _assert_trees_equal(js, ts, rtol=rtol)
        tp = topt.apply_updates(tp, tu)


def test_apply_updates_keeps_dtype():
    p = (torch.ones(3, dtype=torch.bfloat16), torch.ones(2))
    u = (torch.full((3,), 0.5), torch.full((2,), 0.25))
    out = topt.apply_updates(p, u)
    assert out[0].dtype == torch.bfloat16 and out[1].dtype == torch.float32
    assert out[0].tolist() == [1.5] * 3 and out[1].tolist() == [1.25] * 2
