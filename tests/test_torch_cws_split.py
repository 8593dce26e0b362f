"""The split body of the regenerated CWS kernels (rows 6 and 3), on the CPU.

``csrc/cws_regen_split.cu`` runs only on the card, where ``chip_smoke.py``
holds it bit for bit against the plain versions.  What it decides in Python
or in its reduction is checked here:

  (a) ``split_plan``'s properties: S in {1, 2, 4, 8}, no empty D range,
      128 rows a block where n >= 128, about two blocks per SM (more than
      half a wave of them, never more than one wave) wherever D allows it;
  (b) a plain-PyTorch emulation of the body's reduction (partial argmins
      over each cluster rank's contiguous D range and, inside a rank, over
      each d warp's dimensions of every 64-wide chunk; combined in warp and
      then rank order with the body's rule; then the raw and packed emits)
      against the port's plain versions, bit for bit, and against the JAX
      package's ``cws_hash_rng_pallas`` / ``cws_encode_rng_packed_pallas``
      in interpret mode;
  (c) the combine rule on hand-built partials.

Outputs are integers.  Against the port's plain versions they must match
exactly; against the JAX package the one exception of
``test_torch_cws_hash.py`` holds (``torch.log`` and XLA's may differ by an
ulp, so a (row, hash) may flip where float64 shows a near tie or a floor
boundary).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.regen import regen_params
from repro.kernels.cws_hash import (cws_encode_rng_packed_pallas,
                                    cws_hash_rng_pallas)
from repro_torch.core.cws import log_u
from repro_torch.core.hashing import encode, pack_codes
from repro_torch.core.regen import key_words, regen_tile
from repro_torch.kernels import cws_hash as K
from test_torch_cws_encode import assert_exact_or_near_tie
from test_torch_cws_hash import assert_raw_exact_or_near_tie

KEY = np.asarray(jax.random.key_data(jax.random.PRNGKey(5)), np.uint32)
K_HASHES = 19                  # not a multiple of the 32-hash tile
D_ODD = 45                     # divisible by none of S = 2, 4, 8
JAX_BLOCKS = dict(bn=4, bk=8, bd=8)
CLIP = 2.0 ** 30


def _rows(n, d, seed):
    """Sparse nonneg rows from numpy; row 1 (where present) all zero."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    x *= rng.random((n, d)) < 0.4
    if n > 1:
        x[1] = 0.0
    return x


# ---------------------------------------------------------------------------
# the emulation of the split body
# ---------------------------------------------------------------------------

def beats(la, i, best_la, best_i):
    """The body's combine rule (``cws_regen_split.cu:beats``): a smaller
    la, or an equal la at a smaller d, where the sentinel -1 compares as
    the largest d (uint32)."""
    return (la < best_la) | ((la == best_la) &
                             ((i & 0xFFFFFFFF) < (best_i & 0xFFFFFFFF)))


def _steps(x, key, k):
    """(la, tt) of every (row, d, hash), the body's ``cws::step`` in the
    reference's order; la = +inf where the entry is not positive."""
    k0, k1 = key_words(key)
    r, lc, be = regen_tile(k0, k1, 0, 0, x.shape[1], k)
    lu = log_u(torch.from_numpy(x))[:, :, None]
    tt = torch.floor(lu / r + be)
    la = lc - r * (tt - be + 1.0)
    return torch.where(torch.isfinite(lu), la, math.inf), tt


def _partial(la, tt, dims):
    """One thread's serial scan over ``dims`` (ascending, strict <):
    (la, i, t) per (row, hash), (+inf, -1, 0) where no entry is positive."""
    n, _, k = la.shape
    if len(dims) == 0:
        return (torch.full((n, k), math.inf), torch.full((n, k), -1),
                torch.zeros(n, k))
    idx = torch.as_tensor(dims)
    sub = la[:, idx]
    j = torch.argmin(sub, dim=1)              # the first minimum
    best = torch.gather(sub, 1, j[:, None])[:, 0]
    t = torch.gather(tt[:, idx], 1, j[:, None])[:, 0]
    i = torch.where(torch.isfinite(best), idx[j], -1)
    return best, i, torch.where(i >= 0, t, 0.0)


def _combine(parts):
    """Fold partials in order with ``beats``."""
    la, i, t = parts[0]
    for pla, pi, pt in parts[1:]:
        take = beats(pla, pi, la, i)
        la, i, t = (torch.where(take, pla, la), torch.where(take, pi, i),
                    torch.where(take, pt, t))
    return la, i, t


def split_emulate(x, key, plan: K.SplitPlan):
    """(i*, t*) as the split body computes them on ``plan``."""
    la, tt = _steps(x, key, plan.k)
    sub = K.SPLIT_CHUNK // plan.d_warps
    ranks = []
    for s in range(plan.splits):
        lo, hi = plan.d_range(s)
        warps = []
        for w in range(plan.d_warps):
            dims = [d for d0 in range(lo, hi, K.SPLIT_CHUNK)
                    for d in range(d0 + w * sub, min(d0 + (w + 1) * sub, hi))]
            warps.append(_partial(la, tt, dims))
        ranks.append(_combine(warps))
    _, i, t = _combine(ranks)
    t = torch.where(i >= 0, torch.clamp(t, -CLIP, CLIP), 0.0)
    return i.to(torch.int32), t.to(torch.int32)


def split_emulate_packed(x, key, plan, *, b_i, b_t=0):
    i, t = split_emulate(x, key, plan)
    return pack_codes(encode(i, t, b_i=b_i, b_t=b_t), b=b_i + b_t)


def _plan(n, d, k, splits):
    """``split_plan``'s tiles for (n, d, k) with the split forced."""
    return dataclasses.replace(K.split_plan(n, d, k, sms=1), splits=splits)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(n, d, k) for n in (1, 2, 3, 17, 64, 128, 129, 512, 4096)
               for d in (1, 20, 45, 256, 2000, 65536) for k in (19, 1024)]


@pytest.mark.parametrize("sms", [1, 114, 132])
def test_split_plan_properties(sms):
    for n, d, k in PLAN_SHAPES:
        p = K.split_plan(n, d, k, sms)
        assert p.splits in K.SPLIT_SIZES
        assert p.rows_per_thread in K.SPLIT_ROWS_PER_THREAD
        assert p.row_warps * p.d_warps == K.SPLIT_WARPS
        assert K.SPLIT_CHUNK % p.d_warps == 0
        ranges = [p.d_range(s) for s in range(p.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == d
        assert all(hi > lo for lo, hi in ranges), (n, d, k, ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert p.block_rows >= min(n, 128)
        if n >= 128:
            assert p.block_rows == 128
        # about two blocks per SM: more than half a wave of them, unless the
        # cluster is full or a further split leaves a rank less than a chunk
        wave = K.SPLIT_BLOCKS_PER_SM * sms
        room = (p.splits < K.SPLIT_SIZES[-1] and
                d // (2 * p.splits) >= K.SPLIT_CHUNK)
        assert 2 * p.blocks > wave or not room
        # and a split never pushes the grid past one wave
        if p.splits > 1:
            assert p.blocks <= wave


@pytest.mark.parametrize("shape,splits", [
    ((512, 256, 1024), 2), ((512, 65536, 1024), 2), ((2, 2000, 1024), 8),
    ((2, 986, 1024), 8), ((128, 256, 1024), 4), ((1, 256, 1024), 4),
    ((1024, 256, 1024), 1), ((2048, 64, 1024), 1), ((3, 100, 70), 1),
    ((2, 200, 70), 2), ((2, 300, 70), 4)])
def test_split_plan_on_h100(shape, splits):
    """The H100's 132 SMs: the splits ``chip_smoke.py`` relies on to cover
    S in {1, 2, 4, 8}."""
    assert K.split_plan(*shape, sms=132).splits == splits


def test_split_plan_regenerates_each_parameter_4_times_at_512_rows():
    p = K.split_plan(512, 256, 1024, sms=132)
    assert p.grid[1] == 4 and p.block_rows == 128


# ---------------------------------------------------------------------------
# (b) the emulated reduction vs the plain versions and the JAX kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_raw(n, d):
    x = _rows(n, d, seed=n)
    i, t = cws_hash_rng_pallas(jnp.asarray(x), jnp.asarray(KEY), K_HASHES,
                               interpret=True, **JAX_BLOCKS)
    return np.asarray(i), np.asarray(t)


@functools.lru_cache(maxsize=None)
def _jax_packed(n, d, b_i, b_t):
    x = _rows(n, d, seed=n)
    out = cws_encode_rng_packed_pallas(jnp.asarray(x), jnp.asarray(KEY),
                                       K_HASHES, b_i=b_i, b_t=b_t,
                                       interpret=True, **JAX_BLOCKS)
    return np.asarray(out).view(np.int32)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_emulation_raw_matches_plain_and_jax(n, splits):
    x = _rows(n, D_ODD, seed=n)
    plan = _plan(n, D_ODD, K_HASHES, splits)
    got = split_emulate(x, KEY, plan)
    want = K.cws_hash_rng_plain(torch.from_numpy(x), KEY, K_HASHES)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if n > 1:   # the all-zero row keeps the sentinel
        assert (got[0][1] == -1).all() and (got[1][1] == 0).all()
    jp = regen_params(jnp.asarray(KEY), D_ODD, K_HASHES)
    assert_raw_exact_or_near_tie([g.numpy() for g in got], _jax_raw(n, D_ODD),
                                 x, (jp.r, jp.log_c, jp.beta))


@pytest.mark.parametrize("b_i,b_t", [(1, 0), (2, 0), (4, 0), (8, 0), (2, 2)])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_emulation_packed_matches_plain_and_jax(n, b_i, b_t):
    x = _rows(n, D_ODD, seed=n)
    want = K.cws_encode_rng_packed_plain(torch.from_numpy(x), KEY, K_HASHES,
                                         b_i=b_i, b_t=b_t).view(torch.int32)
    for splits in K.SPLIT_SIZES:
        got = split_emulate_packed(x, KEY, _plan(n, D_ODD, K_HASHES, splits),
                                   b_i=b_i, b_t=b_t).view(torch.int32)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    jp = regen_params(jnp.asarray(KEY), D_ODD, K_HASHES)
    assert_exact_or_near_tie(got.numpy(), _jax_packed(n, D_ODD, b_i, b_t), x,
                             (jp.r, jp.log_c, jp.beta), packed=True,
                             b_i=b_i, b_t=b_t)


@pytest.mark.parametrize("shape", [(2, 300, 70), (17, 200, 40),
                                   (3, 130, 19)])
def test_split_emulation_on_the_chosen_plan(shape):
    """The plan ``split_plan`` picks for a small card (so small shapes
    split), with d warps > 1 and chunks of 64 inside each rank's range."""
    n, d, k = shape
    plan = K.split_plan(n, d, k, sms=4)
    assert plan.splits > 1 and plan.d_warps > 1
    x = _rows(n, d, seed=d)
    got = split_emulate(x, KEY, plan)
    want = K.cws_hash_rng_plain(torch.from_numpy(x), KEY, k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (c) the combine rule
# ---------------------------------------------------------------------------

def _t(*v, dtype=torch.float32):
    return torch.tensor(v, dtype=dtype)


@pytest.mark.parametrize("parts,want", [
    # equal la at different d: the smaller d, whichever comes first
    ([(1.5, 7, 3.0), (1.5, 2, 9.0)], (1.5, 2, 9.0)),
    ([(1.5, 2, 9.0), (1.5, 7, 3.0)], (1.5, 2, 9.0)),
    # a sentinel (+inf, -1) partial never wins, before or after a real one
    ([(math.inf, -1, 0.0), (0.25, 40, -2.0)], (0.25, 40, -2.0)),
    ([(0.25, 40, -2.0), (math.inf, -1, 0.0)], (0.25, 40, -2.0)),
    ([(math.inf, -1, 0.0), (math.inf, -1, 0.0)], (math.inf, -1, 0.0)),
    # -inf beats every finite la; two -inf: the smaller d
    ([(-3.0, 1, 1.0), (-math.inf, 9, 4.0)], (-math.inf, 9, 4.0)),
    ([(-math.inf, 9, 4.0), (-math.inf, 5, 2.0), (-1.0, 0, 0.0)],
     (-math.inf, 5, 2.0)),
    # strictly smaller la wins at a larger d
    ([(2.0, 0, 1.0), (1.0, 30, 5.0), (1.0, 31, 6.0)], (1.0, 30, 5.0)),
])
def test_combine_rule(parts, want):
    tensors = [(_t(la), _t(i, dtype=torch.int64), _t(t))
               for la, i, t in parts]
    la, i, t = _combine(tensors)
    assert (float(la[0]), int(i[0]), float(t[0])) == want


# ---------------------------------------------------------------------------
# the launchers' guards (no card needed: they refuse before any launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body", [None, "split", "pair"])
@pytest.mark.parametrize("launcher", ["cws_hash_rng_cuda",
                                      "cws_encode_rng_packed_cuda"])
def test_split_launchers_refuse_cpu_tensors(launcher, body):
    x = torch.from_numpy(_rows(2, 8, seed=0))
    kw = {} if launcher == "cws_hash_rng_cuda" else {"b_i": 2}
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(K, launcher)(x, KEY, 8, body=body, **kw)
    assert K.BODY_LAUNCHES == dict.fromkeys(K.BODY_LAUNCHES, 0)


def test_unknown_body_is_refused():
    x = torch.from_numpy(_rows(2, 8, seed=0))
    with pytest.raises(ValueError, match="body must be one of"):
        K.cws_hash_rng_cuda(x, KEY, 8, body="simt")
