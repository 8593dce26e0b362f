"""The min-sum Gram kernel's plan and summation order (row 7), on the CPU.

``csrc/minmax_gram.cu`` runs only on the card, where ``chip_smoke.py``
holds it against the plain versions.  What it decides in Python, and the
order in which it adds, are checked here:

  (a) ``gram_plan``'s properties: every (tile, 32-d chunk) covered by
      exactly one unit, each tile's slices contiguous and ascending,
      S a power of two no larger than the chunks, no more blocks than the
      tile's occupancy lets every SM hold at once, and every block's work
      within one unit of the mean; the small-output mode exactly where
      m * n < 256;
  (b) its choices on 132 SMs (the H100) at the main paths' and the timing
      shapes and at m, n, D in {63, 64, 65};
  (c) an emulation of the kernel's arithmetic in numpy float32: each
      slice's sum over its d in ascending order from 0, the slices added
      in slice order by the second pass (tiled mode), or each thread's
      strided partial and
      the shared-memory tree (small mode), held for every plan at the test
      shapes, forced S in {1, 2, 4, 8} and the small mode, within
      2·D·2^-24·S of the JAX package's Pallas kernel in interpret mode and
      of the port's plain version;
  (d) ``tma_rows``: the zero pad to an aligned width leaves every sum the
      kernel's order takes bit for bit as it was.

Tolerance: every term is nonnegative, and two fp32 sums of the same D
terms in other orders differ by at most about 2·D·2^-24 of the sum.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minmax_gram import min_sum_pallas
from repro_torch.kernels import minmax_gram as G

U = 2.0 ** -24
H100_SMS = 132
JAX_BLOCKS = dict(bm=16, bn=16, bd=64)


def _rows(rng, r, d, zero_rows=()):
    a = (np.abs(rng.standard_normal((r, d))) *
         np.exp(rng.standard_normal((r, d)))).astype(np.float32)
    a *= rng.random((r, d)) < 0.5
    for z in zero_rows:
        a[z] = 0.0
    return a


# (m, n, D, zero rows of x, zero rows of y): a ragged last chunk (300), D %
# 4 != 0 (1,999, 65), the estimator's (1, 1, D), D below one chunk, a
# square with both tiles' edges
SHAPES = [(37, 29, 300, (0, 17), (5,)), (5, 7, 1999, (2,), ()),
          (1, 1, 2000, (), ()), (19, 13, 23, (3,), (0,)),
          (20, 70, 65, (), (69,)), (3, 130, 257, (1,), ())]


@functools.lru_cache(maxsize=None)
def _case(i):
    m, n, d, zx, zy = SHAPES[i]
    rng = np.random.default_rng(100 + i)
    x, y = _rows(rng, m, d, zx), _rows(rng, n, d, zy)
    want = np.asarray(min_sum_pallas(jnp.asarray(x), jnp.asarray(y),
                                     interpret=True, **JAX_BLOCKS))
    return x, y, want


def emulate(plan, x, y):
    """The kernel's sums on ``plan``, in numpy float32, add for add."""
    m, d = x.shape
    n = y.shape[0]
    if plan.small:
        t = G.GRAM_SMALL_THREADS
        part = np.zeros((m, n, t), np.float32)
        for k0 in range(0, d, t):   # thread t adds d = t, t + 256, ...
            w = min(t, d - k0)
            part[:, :, :w] = part[:, :, :w] + np.minimum(
                x[:, None, k0:k0 + w], y[None, :, k0:k0 + w])
        h = t // 2
        while h:                    # the tree: t += t + h, h = 128 ... 1
            part[:, :, :h] = part[:, :, :h] + part[:, :, h:2 * h]
            h //= 2
        return part[:, :, 0]
    partials = []
    for s in range(plan.splits):
        lo, hi = plan.chunk_range(s)
        acc = np.zeros((m, n), np.float32)
        for k in range(lo * G.GRAM_CHUNK, min(hi * G.GRAM_CHUNK, d)):
            acc = acc + np.minimum(x[:, k][:, None], y[:, k][None, :])
        partials.append(acc)
    total = partials[0]
    for p in partials[1:]:          # slice order, slice 0 first
        total = total + p
    return total


def assert_within(got, want, d):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 2 * d * U * np.abs(want) + 1e-30
    assert (np.abs(got - want) <= bound).all(), \
        float((np.abs(got - want) / bound).max())


def _plans(i):
    """Every plan kind that applies at shape ``i``: the chosen plan, each
    forced S (both tiles), and the small-output mode."""
    m, n, d = SHAPES[i][:3]
    chunks = -(-d // G.GRAM_CHUNK)
    kinds = [("chosen", {}), ("small", {"small": True})]
    kinds += [(f"S{s}/{t[0]}x{t[1]}", {"splits": s, "tile": t})
              for s in G.GRAM_SPLITS if s <= chunks for t in G.GRAM_TILES]
    return [(i, name, kw) for name, kw in kinds]


PLAN_CASES = [c for i in range(len(SHAPES)) for c in _plans(i)]


# ---------------------------------------------------------------------------
# (a) properties
# ---------------------------------------------------------------------------

PROPERTY_SHAPES = [(1200, 1200, 256), (800, 1200, 256), (12000, 12000, 784),
                   (1, 1, 2000), (37, 29, 300), (63, 65, 64), (300, 2, 33),
                   (129, 257, 1000), (2, 1200, 256), (16, 16, 8192)]


@pytest.mark.parametrize("sms", [8, 114, H100_SMS])
@pytest.mark.parametrize("shape", PROPERTY_SHAPES)
def test_gram_plan_properties(shape, sms):
    m, n, d = shape
    plan = G.gram_plan(m, n, d, sms)
    assert plan.small == (m * n < G.GRAM_SMALL_OUTPUTS)
    if plan.small:
        assert (plan.blocks, plan.units, plan.splits) == (m * n, m * n, 1)
        return
    assert plan.tile in G.GRAM_TILES
    assert plan.splits in G.GRAM_SPLITS and plan.splits <= plan.chunks
    assert plan.blocks == min(plan.units, G.GRAM_OCCUPANCY[plan.tile] * sms)
    # every (tile, chunk) exactly once; a tile's slices contiguous and
    # ascending, each at least one chunk
    seen = {}
    for u in range(plan.units):
        tm, tn, s = plan.unit(u)
        assert 0 <= tm < plan.tiles_m and 0 <= tn < plan.tiles_n
        seen.setdefault((tm, tn), []).append((s, plan.chunk_range(s)))
    assert len(seen) == plan.tiles
    for slices in seen.values():
        assert [s for s, _ in slices] == list(range(plan.splits))
        lo = 0
        for _, (a, b) in slices:
            assert a == lo and b > a
            lo = b
        assert lo == plan.chunks
    # each block's triples within one unit of the mean
    work = [sum(plan.unit_triples(u) for u in plan.block_units(b))
            for b in range(plan.blocks)]
    assert sum(len(plan.block_units(b)) for b in range(plan.blocks)) == \
        plan.units
    biggest = max(plan.unit_triples(u) for u in range(plan.units))
    mean = sum(work) / len(work)
    assert max(work) - mean <= biggest and mean - min(work) <= biggest


def test_forced_plans_are_checked():
    with pytest.raises(ValueError, match="slices"):
        G.gram_plan(64, 64, 64, H100_SMS, splits=4)     # 2 chunks
    with pytest.raises(ValueError, match="slices"):
        G.gram_plan(64, 64, 640, H100_SMS, splits=3)
    with pytest.raises(ValueError, match="tile"):
        G.gram_plan(64, 64, 640, H100_SMS, tile=(64, 128))
    with pytest.raises(ValueError, match="empty"):
        G.gram_plan(0, 64, 64, H100_SMS)
    forced = G.gram_plan(800, 1200, 256, H100_SMS, tile=(128, 128), splits=8)
    assert (forced.tile, forced.splits, forced.units) == ((128, 128), 8, 560)
    assert forced.blocks == H100_SMS
    assert G.gram_plan(800, 1200, 256, H100_SMS, small=True).blocks == \
        800 * 1200


# ---------------------------------------------------------------------------
# (b) the H100's plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    # the kernel machine's train and test Grams: 361 and 247 tiles of 64 x
    # 64, all resident at once (three blocks an SM), at most 3 and 2 an SM
    ((1200, 1200, 256), ((64, 64), 1, 361, False)),
    ((800, 1200, 256), ((64, 64), 1, 247, False)),
    # the timing shape: 8,836 tiles of 128 x 128, 66.9 a block
    ((12000, 12000, 784), ((128, 128), 1, 132, False)),
    # the estimator's one pair, and the small mode's edge at 256 outputs
    ((1, 1, 2000), ((0, 0), 1, 1, True)),
    ((1, 1, 1999), ((0, 0), 1, 1, True)),
    ((16, 15, 300), ((0, 0), 1, 240, True)),
    ((16, 16, 300), ((64, 64), 8, 8, False)),
    # a long D over one tile: every slice on its own SM
    ((64, 64, 65536), ((64, 64), 8, 8, False)),
])
def test_gram_plan_on_h100(shape, want):
    plan = G.gram_plan(*shape, H100_SMS)
    assert (plan.tile, plan.splits, plan.blocks, plan.small) == want


def test_gram_plan_at_block_edges_on_h100():
    """m, n, D in {63, 64, 65}: 64 x 64 tiles, one or two in each
    dimension, a block each, D in two or three chunks in one slice."""
    for m in (63, 64, 65):
        for n in (63, 64, 65):
            for d in (63, 64, 65):
                plan = G.gram_plan(m, n, d, H100_SMS)
                tiles = (1 + (m > 64)) * (1 + (n > 64))
                assert (plan.tile, plan.splits, plan.blocks) == \
                    ((64, 64), 1, tiles), (m, n, d)
                assert plan.chunk_range(0) == (0, 2 if d <= 64 else 3)


# ---------------------------------------------------------------------------
# (c) the kernel's order of summation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i,kind,forced", PLAN_CASES,
                         ids=[f"{SHAPES[i][:3]}-{k}" for i, k, _ in PLAN_CASES])
def test_emulated_order_matches_pallas_and_plain(i, kind, forced):
    x, y, want = _case(i)
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    plan = G.gram_plan(m, n, d, H100_SMS, **forced)
    got = emulate(plan, x, y)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert_within(got, want, d)
    plain = G.min_sum_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert_within(got, plain.numpy(), d)
    # an all-zero row sums to exactly 0
    for z in SHAPES[i][3]:
        assert (got[z] == 0).all()


def test_emulated_slices_combine_in_order():
    """Slices added in slice order, not in the order units finish: a case
    where the order decides the last bit."""
    x = np.array([[1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24] + [0.0] * 124],
                 np.float32)
    x = np.repeat(x, 32, axis=1)[:, :128]   # four 32-d chunks
    plan = G.gram_plan(1, 300, 128, H100_SMS, tile=(64, 64), splits=4)
    got = emulate(plan, x, x)[0, 0]
    parts = [np.float32(x[0, 32 * s:32 * s + 32].astype(np.float64).sum())
             for s in range(4)]
    want = np.float32(np.float32(np.float32(parts[0] + parts[1]) + parts[2])
                      + parts[3])
    assert got == want


# ---------------------------------------------------------------------------
# (d) the aligned copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,offset,copied", [(256, 0, False), (300, 0, False),
                                              (1999, 0, True), (65, 0, True),
                                              (256, 1, True)])
def test_tma_rows_pad_is_exact(d, offset, copied):
    rows = _rows(np.random.default_rng(d + offset), 9, d)
    t = torch.from_numpy(rows)
    if offset:   # a view one float past an aligned base
        flat = torch.zeros(9 * d + offset)
        flat[offset:] = t.ravel()
        t = flat[offset:].view(9, d)
    padded, ld = G.tma_rows(t)
    assert (padded is not t) == copied
    assert ld == -(-d // 4) * 4 and padded.data_ptr() % 16 == 0
    assert torch.equal(padded[:, :d], t) and not padded[:, d:].any()
    # the kernel's order over the padded width gives the same bits
    a, b = padded[:5].numpy(), padded[5:].numpy()
    for plan in (G.gram_plan(5, 4, d, H100_SMS, small=True),
                 G.gram_plan(5, 4, d, H100_SMS, tile=(64, 64), splits=1)):
        assert np.array_equal(emulate(dataclasses.replace(plan, d=ld), a, b),
                              emulate(plan, rows[:5], rows[5:]))
