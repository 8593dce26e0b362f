"""Port parity: the four fused CWS encode ops.

For each op the port's plain path (what a CPU tensor runs; the CUDA
kernels are held against the same plain path on the card by
``chip_smoke.py``) is compared with ``repro.kernels.ops`` run as the JAX
package's own tests run it on the CPU: the Pallas kernel body in
``pallas-interpret`` mode with tiny blocks (bn=4, bk=8, bd=8, so every
axis has a ragged tail), and the ``reference`` composition.  Stored
parameters come from ``repro.core.cws.make_cws_params`` through
``repro_torch.interop``; regen parameters from the same two key words.

Outputs are integers and must match exactly.  The one allowed exception:
``torch.log`` / ``log1p`` and XLA's differ by an ulp on some inputs, so a
(row, hash) may flip where the float64 recomputation of log a shows a
near tie between the two best dimensions or a value of
``log u / r + beta`` at a floor boundary; the helper checks that itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cws import make_cws_params
from repro.core.regen import regen_params
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import cws as tcws
from repro_torch.core import regen as tregen
from repro_torch.core.hashing import unpack_codes
from repro_torch.kernels import ops as tops

N, D, K = 7, 13, 19
BLOCKS = dict(bn=4, bk=8, bd=8)
KEY = np.asarray(jax.random.key_data(jax.random.PRNGKey(3)), np.uint32)
CASES = [("cws_encode", 4, 0), ("cws_encode", 4, 2),
         ("cws_encode_rng", 4, 0), ("cws_encode_rng", 4, 2)] + [
    (op, b_i, b_t) for op in ("cws_encode_packed", "cws_encode_rng_packed")
    for b_i, b_t in ((1, 0), (2, 0), (4, 0), (8, 0), (2, 2), (6, 2))]


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((N, D))).astype(np.float32)
    x *= rng.random((N, D)) < 0.5
    x[0] = 0.0
    x[4] = 0.0
    return x


def _stored():
    p = make_cws_params(jax.random.PRNGKey(1), D, K)
    return p, interop.cws_params(np.asarray(p.r), np.asarray(p.log_c),
                                 np.asarray(p.beta), device="cpu")


def _codes(out, packed, b_i, b_t):
    """Per-(row, hash) codes from either output format."""
    if packed:
        words = torch.from_numpy(np.asarray(out).view(np.int32).copy())
        return unpack_codes(words.view(torch.uint32), K,
                            b=b_i + b_t).numpy().astype(np.int64)
    return np.asarray(out, np.int64) - np.arange(K) * (1 << (b_i + b_t))


def assert_exact_or_near_tie(got, want, x, params, *, packed, b_i, b_t):
    """got == want, except where float64 shows a near tie or a floor
    boundary at the (row, hash) that differs."""
    gc, wc = _codes(got, packed, b_i, b_t), _codes(want, packed, b_i, b_t)
    r, lc, be = (np.asarray(a, np.float64) for a in params)
    for row, j in np.argwhere(gc != wc):
        pos = x[row] > 0
        lu = np.log(x[row][pos].astype(np.float64))
        z = lu / r[pos, j] + be[pos, j]
        la = lc[pos, j] - r[pos, j] * (np.floor(z) - be[pos, j] + 1.0)
        best = np.argsort(la)[:2]
        gap = la[best[1]] - la[best[0]] if len(best) > 1 else np.inf
        edge = np.abs(z[best] - np.round(z[best])).min()
        assert gap <= 1e-5 * max(1.0, abs(la[best[0]])) or edge <= 1e-5, (
            f"(row {row}, hash {j}) differs with no near tie "
            f"(gap {gap:.3g}, floor distance {edge:.3g})")


@pytest.mark.parametrize("impl", ["pallas-interpret", "reference"])
@pytest.mark.parametrize("op,b_i,b_t", CASES)
def test_encode_matches_reference(op, b_i, b_t, impl):
    x = _rows()
    packed = op.endswith("_packed")
    if "rng" in op:
        want = getattr(jops, op)(jnp.asarray(x), jnp.asarray(KEY), K,
                                 b_i=b_i, b_t=b_t, impl=impl, **BLOCKS)
        got = getattr(tops, op)(torch.from_numpy(x), KEY, K, b_i=b_i,
                                b_t=b_t)
        jp = regen_params(jnp.asarray(KEY), D, K)
    else:
        jp, tp = _stored()
        want = getattr(jops, op)(jnp.asarray(x), jp, b_i=b_i, b_t=b_t,
                                 impl=impl, **BLOCKS)
        got = getattr(tops, op)(torch.from_numpy(x), tp, b_i=b_i, b_t=b_t)
    want = np.asarray(want)
    assert got.dtype == (torch.uint32 if packed else torch.int32)
    assert tuple(got.shape) == want.shape
    assert_exact_or_near_tie(got.numpy(), want, x, (jp.r, jp.log_c, jp.beta),
                             packed=packed, b_i=b_i, b_t=b_t)
    # all-zero rows land in bucket 0 of every hash
    codes = _codes(got.numpy(), packed, b_i, b_t)
    assert (codes[[0, 4]] == 0).all()


def test_tie_helper_rejects_a_real_mismatch():
    """The tolerance above is not a blanket pass: a flipped index where
    the float64 recomputation shows no tie fails."""
    x = _rows()
    jp, tp = _stored()
    got = tops.cws_encode(torch.from_numpy(x), tp, b_i=4).numpy()
    bad = got.copy()
    bad[1, 3] += 1
    with pytest.raises(AssertionError, match="no near tie"):
        assert_exact_or_near_tie(bad, got, x, (jp.r, jp.log_c, jp.beta),
                                 packed=False, b_i=4, b_t=0)


def test_chunked_plain_is_block_invariant():
    """The chunked plain path equals the unchunked oracle at any chunking,
    and regen equals the oracle on the materialized counter params."""
    x = torch.from_numpy(_rows(1))
    _, tp = _stored()
    ref = tcws.cws_hash_reference(x, tp)
    for rb, hb in ((1, 1), (3, 5), (None, 128)):
        got = tcws.cws_hash(x, tp, row_block=rb, hash_block=hb)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    regen = tcws.cws_hash_regen(x, KEY, K, row_block=2, hash_block=7)
    oracle = tcws.cws_hash_reference(x, tregen.regen_params(KEY, D, K))
    for a, b in zip(regen, oracle):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (regen[0][0] == -1).all() and (regen[1][0] == 0).all()


def test_chunk_sizes_bound_temporaries():
    rb, hb = tcws.chunk_sizes(512, 65536, 1024)
    assert rb * 65536 * hb <= tcws._CHUNK_ELEMS
    assert tcws.chunk_sizes(5, 10, 3) == (5, 3)


def test_make_cws_params_distributions():
    g = torch.Generator().manual_seed(0)
    p = tcws.make_cws_params(g, 64, 256)
    assert p.r.shape == p.log_c.shape == p.beta.shape == (64, 256)
    # Gamma(2,1) has mean 2; U[0,1) mean 0.5 (16,384 draws each)
    assert abs(float(p.r.mean()) - 2.0) < 0.1
    assert abs(float(torch.exp(p.log_c).mean()) - 2.0) < 0.1
    assert 0.0 <= float(p.beta.min()) and float(p.beta.max()) < 1.0
    assert abs(float(p.beta.mean()) - 0.5) < 0.05
