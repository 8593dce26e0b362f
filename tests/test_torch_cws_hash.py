"""Port parity: the raw (i*, t*) CWS hash ops and the naive oracle.

The port's plain path (what a CPU tensor runs; ``chip_smoke.py`` holds
the CUDA kernels against the same plain path on the card) is compared
with ``repro.kernels.ops.cws_hash`` / ``cws_hash_rng`` run as the JAX
package's own tests run them on the CPU: the Pallas kernel body in
``pallas-interpret`` mode with tiny blocks (bn=4, bk=8, bd=8, so every
axis has a ragged tail), and the ``reference`` composition.  Stored
parameters come from ``repro.core.cws.make_cws_params`` through
``repro_torch.interop``; regen parameters from the same two key words.

Outputs are integers and must match exactly.  The one allowed exception,
as in ``test_torch_cws_encode.py``: ``torch.log`` / ``log1p`` and XLA's
differ by an ulp on some inputs, so a (row, hash) may differ where the
float64 recomputation of log a shows a near tie between the two best
dimensions or a value of ``log u / r + beta`` at a floor boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cws import CWSParams as JParams
from repro.core.cws import make_cws_params
from repro.core.regen import regen_params
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import cws_hash as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

N, D, K = 7, 13, 19
BLOCKS = dict(bn=4, bk=8, bd=8)
KEY = np.asarray(jax.random.key_data(jax.random.PRNGKey(3)), np.uint32)
CLIP = 2 ** 30


def _rows(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    x *= rng.random((n, d)) < 0.5
    x[0] = 0.0
    x[min(4, n - 1)] = 0.0
    return x


def _stored(d=D, k=K, seed=1):
    p = make_cws_params(jax.random.PRNGKey(seed), d, k)
    return p, interop.cws_params(np.asarray(p.r), np.asarray(p.log_c),
                                 np.asarray(p.beta), device="cpu")


def assert_raw_exact_or_near_tie(got, want, x, params):
    """(i*, t*) equal, except where float64 shows a near tie or a floor
    boundary at the (row, hash) that differs."""
    gi, gt = (np.asarray(a, np.int64) for a in got)
    wi, wt = (np.asarray(a, np.int64) for a in want)
    r, lc, be = (np.asarray(a, np.float64) for a in params)
    for row, j in np.argwhere((gi != wi) | (gt != wt)):
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
@pytest.mark.parametrize("op", ["cws_hash", "cws_hash_rng"])
def test_raw_hash_matches_reference(op, impl):
    x = _rows()
    if op == "cws_hash_rng":
        want = jops.cws_hash_rng(jnp.asarray(x), jnp.asarray(KEY), K,
                                 impl=impl, **BLOCKS)
        got = tops.cws_hash_rng(torch.from_numpy(x), KEY, K)
        jp = regen_params(jnp.asarray(KEY), D, K)
    else:
        jp, tp = _stored()
        want = jops.cws_hash(jnp.asarray(x), jp, impl=impl, **BLOCKS)
        got = tops.cws_hash(torch.from_numpy(x), tp)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape == (N, K)
    assert_raw_exact_or_near_tie([g.numpy() for g in got], want, x,
                                 (jp.r, jp.log_c, jp.beta))
    # all-zero rows keep the sentinel (-1, 0)
    assert (got[0][[0, 4]] == -1).all() and (got[1][[0, 4]] == 0).all()


@pytest.mark.parametrize("impl", ["pallas-interpret", "reference"])
def test_raw_hash_clips_tstar(impl):
    """Tiny r and extreme x push floor(log u / r + beta) past +-2^30: both
    packages clip t* there and keep i*."""
    d, k = 5, 12
    rng = np.random.default_rng(4)
    r = np.full((d, k), 1e-8, np.float32)
    r[:, ::3] = rng.uniform(0.5, 2.0, (d, 4)).astype(np.float32)
    log_c = rng.standard_normal((d, k)).astype(np.float32)
    beta = rng.random((d, k), dtype=np.float32)
    x = np.array([[1e30, 0.0, 3e25, 0.0, 1e28],
                  [1e-30, 2e-25, 0.0, 1e-28, 0.0],
                  [0.0] * 5], np.float32)
    jp = JParams(*(jnp.asarray(a) for a in (r, log_c, beta)))
    want = jops.cws_hash(jnp.asarray(x), jp, impl=impl, **BLOCKS)
    got = tops.cws_hash(torch.from_numpy(x),
                        interop.cws_params(r, log_c, beta, device="cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t = got[1].numpy()
    assert (t[0, 1::3] == CLIP).all() and (t[1, 1::3] == -CLIP).all()
    assert (got[0][2] == -1).all() and (t[2] == 0).all()


def test_naive_oracle_matches_reference_oracle():
    x = _rows(2)
    jp, tp = _stored(seed=5)
    want = jref.cws_hash_ref(jnp.asarray(x), jp.r, jp.log_c, jp.beta)
    got = tref.cws_hash_ref(torch.from_numpy(x), tp.r, tp.log_c, tp.beta)
    assert_raw_exact_or_near_tie([g.numpy() for g in got], want, x,
                                 (jp.r, jp.log_c, jp.beta))
    # and the chunked plain version equals the naive oracle exactly
    for g, o in zip(tkern.cws_hash_plain(torch.from_numpy(x), tp), got):
        torch.testing.assert_close(g, o, rtol=0, atol=0)


def test_empty_and_single_row():
    _, tp = _stored()
    i_s, t_s = tops.cws_hash(torch.zeros((0, D)), tp)
    assert i_s.shape == t_s.shape == (0, K)
    i_s, t_s = tops.cws_hash_rng(torch.from_numpy(_rows()[1:2]), KEY, K)
    assert i_s.shape == (1, K) and (i_s >= 0).all()
