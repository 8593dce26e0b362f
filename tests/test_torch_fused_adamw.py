"""Port parity: the LM trainer's fused AdamW (``fused_adamw_apply``), its
stochastic rounding and the int8 error-feedback compression, against
``repro.optim``.

  * ``_murmur_bits`` and ``_stochastic_round_bf16`` are integer
    arithmetic on the float's bits: equal to the reference's exactly, for
    1-D to 3-D shapes and seeds up to 2^32 - 1.
  * ``fused_adamw_apply`` on a tree with a leaf above a small
    ``chunk_threshold`` (updated slice by slice of dim 0, each slice
    seeded apart), one above it whose dim 0 does not divide (updated
    whole), a 1-D leaf (no decay) and a bf16 leaf, over three steps with
    the clip folded in: bit-identical to the reference evaluated op by op
    (``jax.disable_jit``), with fp32 masters and with bf16 masters and
    stochastic rounding.  Against the jitted reference (every leaf below
    the threshold, as in the train step at these sizes), whose XLA rewrites
    move each value by about one rounding (``tests/test_torch_optim.py``),
    the fp32 leaves and moments are held within 4e-7 relative plus 1e-6
    of the leaf's largest magnitude, and a stochastically rounded bf16
    leaf within one bf16 ulp (a p32 one rounding away can carry the
    noise over the next bf16 boundary).
  * ``error_feedback_compress``: the dequantized gradients and the
    residual equal the reference's op by op, exactly.  Jitted, XLA folds
    the dequantizing multiply otherwise and rounds it one ulp away, which
    the residual (g - deq) keeps and carries to the next step: both within
    8 roundings (2^-24 relative) of the leaf's largest magnitude.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt

SHAPES = [(1,), (37,), (5, 7), (3, 4, 6), (2, 1, 9)]
SEEDS = [0, 1, 101, 7919 * 3 + 1, 2 ** 31, 2 ** 32 - 1]
JIT_RTOL, JIT_ATOL_OF_MAX = 4e-7, 1e-6
BF16_ULP = 2.0 ** -7
JIT_EF_ULPS = 8


@pytest.mark.parametrize("shape", SHAPES)
def test_murmur_bits_equal_the_reference(shape):
    for seed in SEEDS:
        want = np.asarray(jopt._murmur_bits(shape, jnp.uint32(seed)))
        got = topt._murmur_bits(shape, seed).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        # a seed given as an int64 tensor, as the trainer passes it
        got_t = topt._murmur_bits(shape, torch.tensor(seed)).numpy()
        np.testing.assert_array_equal(got_t, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_stochastic_round_bf16_equals_the_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(
        -6, 6, shape)).astype(np.float32)
    x.flat[0] = -x.flat[0]
    for seed in SEEDS:
        want = np.asarray(jopt._stochastic_round_bf16(
            jnp.asarray(x), jnp.uint32(seed)).astype(jnp.float32))
        got = topt._stochastic_round_bf16(torch.from_numpy(x), seed)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                      want.view(np.uint32))


def _fori_loop(lo, hi, body, carry):
    """``lax.fori_loop`` with an int32 index, for the reference run op by
    op: under ``disable_jit`` jax hands the body a Python int, on which
    the chunked update's ``ci.astype`` fails."""
    for i in range(lo, hi):
        carry = body(jnp.int32(i), carry)
    return carry


@contextlib.contextmanager
def _op_by_op(on: bool):
    """The reference evaluated op by op (``jax.disable_jit``, its chunk
    loop a Python loop), or as it is."""
    if not on:
        yield
        return
    real = jax.lax.fori_loop
    jax.lax.fori_loop = _fori_loop
    try:
        with jax.disable_jit():
            yield
    finally:
        jax.lax.fori_loop = real


def _state(seed, bf16_master):
    """params, grads, mu, nu (numpy float32) with the leaf kinds the
    module docstring lists; ``c`` is chunked at CHUNK_THRESHOLD 64."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    shapes = {"a": (6, 20), "b": (11,), "c": (8, 16), "d": (3, 5, 4)}
    p = {k: draw(*s) * 0.1 for k, s in shapes.items()}
    g = {k: draw(*s) for k, s in shapes.items()}
    mu = {k: draw(*s) * 0.01 for k, s in shapes.items()}
    nu = {k: np.abs(draw(*s)) * 1e-4 for k, s in shapes.items()}
    bf16 = {k: bf16_master or k == "d" for k in shapes}
    return p, g, mu, nu, bf16


def _run_ref(p, g, mu, nu, bf16, steps, jit, chunk_threshold=64):
    jp = {k: jnp.asarray(v, jnp.bfloat16 if bf16[k] else jnp.float32)
          for k, v in p.items()}
    jm = {k: jnp.asarray(v) for k, v in mu.items()}
    jv = {k: jnp.asarray(v) for k, v in nu.items()}
    def one(jp, jm, jv, step, scale):
        return jopt.fused_adamw_apply(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jm, jv, step,
            lr=jnp.float32(3e-3), weight_decay=0.1, stochastic_round=True,
            sr_key=step.astype(jnp.uint32), chunks=4,
            chunk_threshold=chunk_threshold, g_scale=scale)

    fn = jax.jit(one) if jit else one
    with _op_by_op(not jit):
        for s in range(steps):
            jp, jm, jv = fn(jp, jm, jv, jnp.int32(s + 3),
                            jnp.float32(0.5 + 0.25 * s))
    return jp, jm, jv


def _run_port(p, g, mu, nu, bf16, steps, chunk_threshold=64):
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if bf16[k] else
                                    torch.float32) for k, v in p.items()}
    tm = {k: torch.from_numpy(v.copy()) for k, v in mu.items()}
    tv = {k: torch.from_numpy(v.copy()) for k, v in nu.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    for s in range(steps):
        step = torch.tensor(s + 3, dtype=torch.int32)
        out = topt.fused_adamw_apply(
            tp, tg, tm, tv, step, lr=torch.tensor(3e-3), weight_decay=0.1,
            stochastic_round=True, sr_key=step, chunks=4,
            chunk_threshold=chunk_threshold,
            g_scale=torch.tensor(0.5 + 0.25 * s))
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
    return tp, tm, tv


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("bf16_master", [False, True])
def test_fused_adamw_op_by_op_is_bit_identical(bf16_master):
    p, g, mu, nu, bf16 = _state(0, bf16_master)
    want = _run_ref(p, g, mu, nu, bf16, 3, jit=False)
    got = _run_port(p, g, mu, nu, bf16, 3)
    for jt, tt in zip(want, got):
        for k in sorted(p):
            assert str(tt[k].dtype).endswith(str(jt[k].dtype))
            np.testing.assert_array_equal(tt[k].float().numpy().view(
                np.uint32), _f32(jt[k]).view(np.uint32), err_msg=k)


def test_chunked_leaf_takes_its_own_seeds():
    """The chunked leaf's slices are seeded ``leaf_seed + ci * 7919``: the
    same update unchunked (threshold above the leaf) rounds otherwise."""
    p, g, mu, nu, _ = _state(1, True)
    bf16 = dict.fromkeys(p, True)
    chunked = _run_port(p, g, mu, nu, bf16, 1)[0]["c"]
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    topt.fused_adamw_apply(
        tp, {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v.copy()) for k, v in mu.items()},
        {k: torch.from_numpy(v.copy()) for k, v in nu.items()},
        torch.tensor(3, dtype=torch.int32), lr=torch.tensor(3e-3),
        weight_decay=0.1, stochastic_round=True,
        sr_key=torch.tensor(3, dtype=torch.int32), chunks=4,
        chunk_threshold=1 << 24, g_scale=torch.tensor(0.5))
    assert not torch.equal(chunked, tp["c"])
    assert torch.allclose(chunked.float(), tp["c"].float(), rtol=2 * BF16_ULP)


@pytest.mark.parametrize("bf16_master", [False, True])
def test_fused_adamw_against_the_jitted_reference(bf16_master):
    p, g, mu, nu, bf16 = _state(2, bf16_master)
    # unchunked, as the train step runs at these sizes: the chunked
    # update is held op by op above
    want = _run_ref(p, g, mu, nu, bf16, 3, jit=True, chunk_threshold=1 << 24)
    got = _run_port(p, g, mu, nu, bf16, 3, chunk_threshold=1 << 24)
    for i, (jt, tt) in enumerate(zip(want, got)):
        for k in sorted(p):
            a, b = _f32(jt[k]), tt[k].float().numpy()
            if i == 0 and bf16[k]:
                np.testing.assert_allclose(b, a, rtol=BF16_ULP, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=JIT_RTOL,
                    atol=JIT_ATOL_OF_MAX * np.abs(a).max(), err_msg=k)


@pytest.mark.parametrize("jit", [False, True])
def test_error_feedback_compress_equals_the_reference(jit):
    rng = np.random.default_rng(4)
    grads = {"w": rng.standard_normal((30, 7)).astype(np.float32),
             "b": (rng.standard_normal(7) * 1e-3).astype(np.float32),
             "z": np.zeros((4,), np.float32)}
    fn = jax.jit(jcomp.error_feedback_compress) if jit else \
        jcomp.error_feedback_compress
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jr = jcomp.init_residual(jg)
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    tr = tcomp.init_residual(tg)
    for _ in range(3):
        with _op_by_op(not jit):
            jc, jr = fn(jg, jr)
        tc, tr = tcomp.error_feedback_compress(tg, tr)
        for k in grads:
            atol = JIT_EF_ULPS * 2.0 ** -24 * np.abs(grads[k]).max() \
                if jit else 0.0
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=0, atol=atol)
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                       rtol=0, atol=atol)
    # a bf16 gradient comes back bf16, its residual fp32
    c, r = tcomp.error_feedback_compress({"w": tg["w"].bfloat16()},
                                         {"w": torch.zeros(30, 7)})
    assert c["w"].dtype == torch.bfloat16 and r["w"].dtype == torch.float32
    np.testing.assert_array_equal(
        tcomp.int8_compress_decompress(tg["w"]).numpy(),
        np.asarray(jcomp.int8_compress_decompress(jg["w"])))


def test_none_is_an_empty_subtree():
    t = {"a": torch.ones(2), "ef": None, "n": (None, torch.zeros(1))}
    assert [x.shape for x in topt.tree_leaves(t)] == [(2,), (1,)]
    out = topt.tree_map(lambda x: x + 1, t)
    assert out["ef"] is None and out["n"][0] is None
    assert out["n"][1].item() == 1.0
