"""The split body of the CWS kernels (rows 1-6), on the CPU.

``csrc/cws_split.cu`` runs only on the card, where ``chip_smoke.py``
holds it bit for bit against the plain versions.  What it decides in Python
or in its reduction is checked here:

  (a) ``split_plan``'s properties: S in {1, 2, 4, 8}, no empty D range,
      128 rows a block where n >= 128, about two blocks per SM (more than
      half a wave of them, never more than one wave) wherever D allows it;
      and the stored-parameter plan's shorter row tiles (room for S = 2,
      or no short last wave);
  (b) a plain-PyTorch emulation of the body's reduction (partial argmins
      over each cluster rank's contiguous D range and, inside a rank, over
      each d warp's dimensions of every 64-wide chunk; combined in warp and
      then rank order with the body's rule; then the raw, packed and index
      emits), on regenerated parameters and on stored ones (the JAX
      package's ``make_cws_params`` through ``repro_torch.interop``),
      against the port's plain versions, bit for bit, and against the JAX
      package's six kernels (``cws_hash_rng_pallas``, ``cws_hash_pallas``,
      ``cws_encode_rng_packed_pallas``, ``cws_encode_packed_pallas``,
      ``cws_encode_rng_pallas``, ``cws_encode_pallas``) in interpret mode;
  (c) the combine rule on hand-built partials;
  (d) the width of the stored tiles' copies, and the launchers' guards.

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

from repro.core.cws import make_cws_params
from repro.core.regen import regen_params
from repro.kernels.cws_hash import (cws_encode_packed_pallas,
                                    cws_encode_pallas, cws_encode_rng_pallas,
                                    cws_encode_rng_packed_pallas,
                                    cws_hash_pallas, cws_hash_rng_pallas)
from repro_torch import interop
from repro_torch.core.cws import CWSParams, log_u
from repro_torch.core.hashing import encode, feature_indices, pack_codes
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
    """The body's combine rule (``cws_split.cu:beats``): a smaller
    la, or an equal la at a smaller d, where the sentinel -1 compares as
    the largest d (uint32)."""
    return (la < best_la) | ((la == best_la) &
                             ((i & 0xFFFFFFFF) < (best_i & 0xFFFFFFFF)))


def _regen(key, d, k):
    """The (D, k) parameters (r, log c, beta) regenerated from ``key``."""
    k0, k1 = key_words(key)
    return regen_tile(k0, k1, 0, 0, d, k)


@functools.lru_cache(maxsize=None)
def _stored(d, k):
    """The JAX package's stored parameters, and the port's copy of them."""
    p = make_cws_params(jax.random.PRNGKey(7), d, k)
    return p, interop.cws_params(np.asarray(p.r), np.asarray(p.log_c),
                                 np.asarray(p.beta), device="cpu")


def _steps(x, params):
    """(la, tt) of every (row, d, hash), the body's ``cws::step`` in the
    reference's order on the (D, k) ``params`` (r, log c, beta); la = +inf
    where the entry is not positive."""
    r, lc, be = params
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


def split_emulate(x, params, plan: K.SplitPlan):
    """(i*, t*) as the split body computes them on ``plan`` from the (D, k)
    ``params`` (r, log c, beta): regenerated or stored alike, since both
    reach the walk as the same shared-memory tiles."""
    la, tt = _steps(x, params)
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


def split_emulate_packed(x, params, plan, *, b_i, b_t=0):
    i, t = split_emulate(x, params, plan)
    return pack_codes(encode(i, t, b_i=b_i, b_t=b_t), b=b_i + b_t)


def split_emulate_index(x, params, plan, *, b_i, b_t=0):
    """The index emit: hash h's bag h * 2^b + its code."""
    i, t = split_emulate(x, params, plan)
    return feature_indices(encode(i, t, b_i=b_i, b_t=b_t), b_i=b_i, b_t=b_t)


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


@pytest.mark.parametrize("sms", [1, 114, 132])
def test_stored_split_plan_properties(sms):
    """The stored plan: the regen plan's row tile, halved down to 8 rows
    while the grid keeps room for S = 2 in one wave, then the same split
    rule."""
    wave = K.SPLIT_BLOCKS_PER_SM * sms
    for n, d, k in PLAN_SHAPES:
        p = K.split_plan(n, d, k, sms, stored=True)
        regen = K.split_plan(n, d, k, sms)
        assert p.splits in K.SPLIT_SIZES
        assert p.rows_per_thread in K.SPLIT_ROWS_PER_THREAD
        assert p.row_warps * p.d_warps == K.SPLIT_WARPS
        assert all(hi > lo for lo, hi in map(p.d_range, range(p.splits)))
        assert min(n, K.SPLIT_STORED_MIN_ROWS) <= p.block_rows
        assert p.block_rows <= regen.block_rows
        tiles = p.blocks // p.splits
        if p.block_rows < regen.block_rows:
            # halved: room for S = 2, or the taller tile's grid ran past
            # one wave with its last wave less than half full
            per_thread, row_warps = K._row_tile(2 * p.block_rows)
            taller = dataclasses.replace(p, rows_per_thread=per_thread,
                                         row_warps=row_warps, splits=1)
            assert 2 * tiles <= wave or K.short_tail(taller.blocks, wave)
        if p.block_rows > K.SPLIT_STORED_MIN_ROWS:   # halving stopped
            per_thread, row_warps = K._row_tile(p.block_rows // 2)
            half = dataclasses.replace(p, rows_per_thread=per_thread,
                                       row_warps=row_warps, splits=1)
            assert 2 * half.blocks > wave
            assert not K.short_tail(tiles, wave)
        # the split rule on the chosen tiles
        room = (p.splits < K.SPLIT_SIZES[-1] and
                tiles * 2 * p.splits <= wave and
                d // (2 * p.splits) >= K.SPLIT_CHUNK)
        assert not room
        if p.splits > 1:
            assert p.blocks <= wave
        if n <= K.SPLIT_STORED_MIN_ROWS:   # nothing to halve
            assert p == regen


@pytest.mark.parametrize("shape,block_rows,splits", [
    ((512, 256, 1024), 128, 2), ((128, 256, 1024), 32, 2),
    ((32, 256, 1024), 8, 2), ((8, 256, 1024), 8, 4), ((1, 256, 1024), 1, 4),
    ((4, 3840, 512), 4, 8), ((1024, 256, 1024), 128, 1),
    ((512, 65536, 1024), 128, 2), ((37, 300, 70), 8, 4),
    ((2, 1000, 1024), 2, 8), ((1200, 256, 1024), 32, 1),
    ((64, 256, 1024), 16, 2), ((2, 2000, 1024), 2, 8),
    ((1500, 256, 1024), 64, 1), ((1600, 256, 1024), 128, 1),
    ((2048, 256, 1024), 128, 1)])
def test_stored_split_plan_on_h100(shape, block_rows, splits):
    """The H100's stored plans at the serving buckets, the LM head's
    (4, 3,840, 512), the kernel machine's row-5 launches (1,200 and 64
    rows: at 1,200 the 128-row tiles' 320 blocks would leave a last wave
    of 56 of 264 slots) and ``chip_smoke.py``'s parity and timing
    shapes; and both sides of ``short_tail``'s half-full wave past 1,024
    rows: at 1,500 rows 128-row tiles leave a last wave of 120 of 264
    slots (halved: 64-row tiles, a last wave of 240), at 1,600 one of 152
    (kept), at 2,048 one of 248 (kept)."""
    p = K.split_plan(*shape, sms=132, stored=True)
    assert (p.block_rows, p.splits) == (block_rows, splits)


# ---------------------------------------------------------------------------
# (b) the emulated reduction vs the plain versions and the JAX kernels
# ---------------------------------------------------------------------------

def _source(source, d, k):
    """(the (D, k) (r, log c, beta) the body walks, the JAX package's
    parameters, the port's ``CWSParams`` or None) for ``source``."""
    if source == "regen":
        return (_regen(KEY, d, k), regen_params(jnp.asarray(KEY), d, k),
                None)
    jp, tp = _stored(d, k)
    return (tp.r, tp.log_c, tp.beta), jp, tp


@functools.lru_cache(maxsize=None)
def _jax_raw(source, n, d):
    x = jnp.asarray(_rows(n, d, seed=n))
    if source == "regen":
        i, t = cws_hash_rng_pallas(x, jnp.asarray(KEY), K_HASHES,
                                   interpret=True, **JAX_BLOCKS)
    else:
        p, _ = _stored(d, K_HASHES)
        i, t = cws_hash_pallas(x, p.r, p.log_c, p.beta, interpret=True,
                               **JAX_BLOCKS)
    return np.asarray(i), np.asarray(t)


@functools.lru_cache(maxsize=None)
def _jax_packed(source, n, d, b_i, b_t):
    x = jnp.asarray(_rows(n, d, seed=n))
    if source == "regen":
        out = cws_encode_rng_packed_pallas(x, jnp.asarray(KEY), K_HASHES,
                                           b_i=b_i, b_t=b_t, interpret=True,
                                           **JAX_BLOCKS)
    else:
        p, _ = _stored(d, K_HASHES)
        out = cws_encode_packed_pallas(x, p.r, p.log_c, p.beta, b_i=b_i,
                                       b_t=b_t, interpret=True, **JAX_BLOCKS)
    return np.asarray(out).view(np.int32)


@pytest.mark.parametrize("source", ["regen", "stored"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_emulation_raw_matches_plain_and_jax(n, splits, source):
    """Rows 6 (regenerated) and 5 (stored): the raw emit."""
    x = _rows(n, D_ODD, seed=n)
    xt = torch.from_numpy(x)
    params, jp, tp = _source(source, D_ODD, K_HASHES)
    got = split_emulate(x, params, _plan(n, D_ODD, K_HASHES, splits))
    want = (K.cws_hash_rng_plain(xt, KEY, K_HASHES) if tp is None
            else K.cws_hash_plain(xt, tp))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if n > 1:   # the all-zero row keeps the sentinel
        assert (got[0][1] == -1).all() and (got[1][1] == 0).all()
    assert_raw_exact_or_near_tie([g.numpy() for g in got],
                                 _jax_raw(source, n, D_ODD), x,
                                 (jp.r, jp.log_c, jp.beta))


@pytest.mark.parametrize("source", ["regen", "stored"])
@pytest.mark.parametrize("b_i,b_t", [(1, 0), (2, 0), (4, 0), (8, 0), (2, 2)])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_emulation_packed_matches_plain_and_jax(n, b_i, b_t, source):
    """Rows 3 (regenerated) and 4 (stored): the packed emit on every S."""
    x = _rows(n, D_ODD, seed=n)
    xt = torch.from_numpy(x)
    params, jp, tp = _source(source, D_ODD, K_HASHES)
    want = (K.cws_encode_rng_packed_plain(xt, KEY, K_HASHES, b_i=b_i,
                                          b_t=b_t) if tp is None
            else K.cws_encode_packed_plain(xt, tp, b_i=b_i, b_t=b_t))
    want = want.view(torch.int32)
    for splits in K.SPLIT_SIZES:
        got = split_emulate_packed(x, params,
                                   _plan(n, D_ODD, K_HASHES, splits),
                                   b_i=b_i, b_t=b_t).view(torch.int32)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert_exact_or_near_tie(got.numpy(),
                             _jax_packed(source, n, D_ODD, b_i, b_t), x,
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
    got = split_emulate(x, _regen(KEY, d, k), plan)
    want = K.cws_hash_rng_plain(torch.from_numpy(x), KEY, k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _jax_index(source, n, d, b_i, b_t):
    x = jnp.asarray(_rows(n, d, seed=n))
    if source == "regen":
        out = cws_encode_rng_pallas(x, jnp.asarray(KEY), K_HASHES, b_i=b_i,
                                    b_t=b_t, interpret=True, **JAX_BLOCKS)
    else:
        p, _ = _stored(d, K_HASHES)
        out = cws_encode_pallas(x, p.r, p.log_c, p.beta, b_i=b_i, b_t=b_t,
                                interpret=True, **JAX_BLOCKS)
    return np.asarray(out)


@pytest.mark.parametrize("b_i,b_t", [(4, 0), (4, 2), (8, 0)])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("source", ["regen", "stored"])
def test_split_emulation_index_matches_plain_and_jax(source, n, b_i, b_t):
    """Rows 1 (regenerated) and 2 (stored): the index emit on every S."""
    x = _rows(n, D_ODD, seed=n)
    xt = torch.from_numpy(x)
    params, jp, tp = _source(source, D_ODD, K_HASHES)
    want = (K.cws_encode_rng_plain(xt, KEY, K_HASHES, b_i=b_i, b_t=b_t)
            if tp is None else K.cws_encode_plain(xt, tp, b_i=b_i, b_t=b_t))
    for splits in K.SPLIT_SIZES:
        got = split_emulate_index(x, params, _plan(n, D_ODD, K_HASHES, splits),
                                  b_i=b_i, b_t=b_t)
        assert got.dtype == want.dtype == torch.int32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if n > 1:   # the all-zero row lands in every hash's bucket 0
        bag = torch.arange(K_HASHES, dtype=torch.int32) * (1 << (b_i + b_t))
        assert torch.equal(got[1], bag)
    assert_exact_or_near_tie(got.numpy(), _jax_index(source, n, D_ODD, b_i,
                                                     b_t), x,
                             (jp.r, jp.log_c, jp.beta), packed=False,
                             b_i=b_i, b_t=b_t)


@pytest.mark.parametrize("shape", [(2, 300, 70), (17, 200, 40),
                                   (3, 130, 19)])
def test_split_emulation_stored_index_on_the_chosen_plan(shape):
    """Row 2 on its stored plan for a small card (splits and d warps > 1;
    at 17 rows a halved row tile), its tiles cut at the ranks' ragged
    chunk ends."""
    n, d, k = shape
    plan = K.split_plan(n, d, k, sms=4, stored=True)
    assert plan.splits > 1 and plan.d_warps > 1
    x = _rows(n, d, seed=d)
    _, tp = _stored(d, k)
    got = split_emulate_index(x, (tp.r, tp.log_c, tp.beta), plan, b_i=4,
                              b_t=2)
    want = K.cws_encode_plain(torch.from_numpy(x), tp, b_i=4, b_t=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 300, 70), (17, 200, 40),
                                   (3, 130, 19)])
def test_split_emulation_stored_raw_and_packed_on_the_chosen_plan(shape):
    """Rows 5 and 4 on the stored plan for a small card, as row 2 above:
    the raw emit, and the packed emit at b = 2 + 2 (k = 70 and 19 end in a
    part-filled word)."""
    n, d, k = shape
    plan = K.split_plan(n, d, k, sms=4, stored=True)
    assert plan.splits > 1 and plan.d_warps > 1
    x = _rows(n, d, seed=d)
    xt = torch.from_numpy(x)
    _, tp = _stored(d, k)
    params = (tp.r, tp.log_c, tp.beta)
    for g, w in zip(split_emulate(x, params, plan), K.cws_hash_plain(xt, tp)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got = split_emulate_packed(x, params, plan, b_i=2, b_t=2)
    want = K.cws_encode_packed_plain(xt, tp, b_i=2, b_t=2)
    torch.testing.assert_close(got.view(torch.int32), want.view(torch.int32),
                               rtol=0, atol=0)


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
# (d) the stored tiles' copy width, and the launchers' guards (no card
# needed: they refuse before any launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,offset,width", [
    (1024, 0, 16), (1000, 0, 16), (512, 0, 16), (70, 0, 4), (19, 0, 4),
    (1024, 1, 4), (1024, 4, 16)])
def test_stored_copy_bytes(k, offset, width):
    """16-byte copies where k % 4 == 0 and every matrix starts on a
    16-byte boundary (``offset`` floats into its storage), else 4-byte."""
    d = 3
    mats = [torch.ones(offset + d * k)[offset:].view(d, k) for _ in range(3)]
    assert K.stored_copy_bytes(CWSParams(*mats)) == width


LAUNCHERS = ["cws_hash_rng_cuda", "cws_encode_rng_packed_cuda",
             "cws_encode_rng_cuda", "cws_encode_cuda",
             "cws_encode_packed_cuda", "cws_hash_cuda"]


def _launch_args(launcher, d):
    """(positional, keyword) arguments of ``launcher`` after x."""
    kw = {} if launcher.startswith("cws_hash") else {"b_i": 2}
    if "rng" in launcher:
        return (KEY, 8), kw
    return (CWSParams(*(torch.rand(d, 8) + 0.5 for _ in range(3))),), kw


@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_split_launchers_refuse_cpu_tensors(launcher):
    K.reset_launches()
    x = torch.from_numpy(_rows(2, 8, seed=0))
    args, kw = _launch_args(launcher, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(K, launcher)(x, *args, **kw)
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
