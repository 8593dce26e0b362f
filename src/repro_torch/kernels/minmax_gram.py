"""The min-sum Gram kernel: CUDA launcher beside its plain version.

Port of ``repro/kernels/minmax_gram.py``.  ``S[m, n] = sum_d min(x[m, d],
y[n, d])`` is the kernel (``csrc/minmax_gram.cu``); the min-max Gram

    K = S / max(sum x + sum y - S, 1e-30)      (nonnegative x, y)

follows from it in PyTorch, as the reference also computes it outside its
Pallas kernel.  ``min_sum_plain`` / ``minmax_gram_plain`` are the
definitions the kernel is held to (chunked over rows so the (rows, n, D)
temporary stays bounded); the ``_cuda`` launchers check their inputs,
allocate with ``torch.empty``, launch on the current stream, raise on a
launch error and bump ``LAUNCHES["min_sum"]``.  ``repro_torch.kernels.ops``
chooses between the two by the tensors' device; a launcher never falls
back to the plain version.

``gram_plan`` decides how the kernel covers an (m, n, D) problem on a
card's SMs: 128 x 128, 128 x 64 or 64 x 64 output tiles, D cut into S
contiguous slices (added in slice order by a second pass), walked by
persistent blocks, as many an SM as the tile's registers and shared
memory allow (one, two, three); or, where m * n cannot fill one tile's
threads, a small-output mode that splits each output's D over the threads
of one block.  The tiled
mode reads x and y by TMA, which needs 16-byte-aligned bases and row
strides: where D % 4 != 0 or a base is misaligned, ``tma_rows`` copies the
rows into a zero-padded buffer of width ceil(D / 4) * 4 (exact: every
padded d adds min(0, 0) = 0).  That is the only copy the launcher makes
of inputs that are already contiguous fp32; plans with S > 1 also take an
(S, m, n) workspace of partial sums.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import minmax_gram_library

LAUNCHES = {"min_sum": 0}

# Elements of one (rows, n, D) temporary in the plain version (128 MiB).
_CHUNK_ELEMS = 1 << 25
_INT_MAX = 2 ** 31 - 1

# The kernel's constants (csrc/minmax_gram.cu)
GRAM_TILES = ((128, 128), (128, 64), (64, 64))   # (rows of x, rows of y)
# blocks of each tile an SM holds at once (its launch bound: registers and
# shared memory)
GRAM_OCCUPANCY = {(128, 128): 1, (128, 64): 2, (64, 64): 3}
GRAM_CHUNK = 32                 # dimensions per TMA stage
GRAM_SPLITS = (1, 2, 4, 8)      # slices of D a plan may take
GRAM_SMALL_THREADS = 256        # threads splitting one output's D (small mode)
# Below this many outputs the small-output mode takes over: a tile's 256
# consumer threads could not each hold one output.
GRAM_SMALL_OUTPUTS = 256
# The plan's cost model, in SM cycles of an H100: (m, n, d) triples an SM
# computes a cycle on each tile at its occupancy (read on an H100 80GB HBM3
# at (12,000, 12,000, 784); 64 is the issue bound of two instructions a
# triple), a unit's fixed cycles (its first stage and its stores), and the
# combine pass of S > 1 (its bytes at the card's rate, and its launch).
GRAM_RATE = {(128, 128): 51.3, (128, 64): 46.7, (64, 64): 48.4}
GRAM_UNIT_CYCLES = 2000
GRAM_PASS_BYTES_PER_CYCLE = 1200
GRAM_PASS_CYCLES = 3000


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GramPlan:
    """How the kernel covers S (m, n) from D dimensions.  Tiled mode:
    units (tile, slice) in the order tile * splits + slice, tiles
    row-major, walked by ``blocks`` persistent blocks, block b taking
    units b, b + blocks, ...; slice s sums the 32-d chunks
    ``chunk_range(s)``, and with S > 1 a second pass adds the slices in
    order.  Small mode (``small``): one block an output, its D split over
    256 threads."""

    m: int
    n: int
    d: int
    tile: tuple       # (rows of x, rows of y) of a tile; (0, 0) in small mode
    splits: int
    blocks: int
    small: bool = False

    @property
    def chunks(self) -> int:
        return -(-self.d // GRAM_CHUNK)

    @property
    def tiles_m(self) -> int:
        return -(-self.m // self.tile[0])

    @property
    def tiles_n(self) -> int:
        return -(-self.n // self.tile[1])

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def units(self) -> int:
        return self.m * self.n if self.small else self.tiles * self.splits

    def chunk_range(self, s: int):
        """[lo, hi) of the 32-d chunks slice ``s`` sums."""
        return (self.chunks * s // self.splits,
                self.chunks * (s + 1) // self.splits)

    def unit(self, u: int):
        """(tile row, tile column, slice) of tiled unit ``u``."""
        tile, s = divmod(u, self.splits)
        tm, tn = divmod(tile, self.tiles_n)
        return tm, tn, s

    def block_units(self, b: int) -> range:
        return range(b, self.units, self.blocks)

    def unit_triples(self, u: int) -> int:
        """(m, n, d) triples unit ``u`` computes, padding included (a
        tile's rows past m or n are zeros, but computed; d past D in the
        last chunk is skipped in groups of four)."""
        if self.small:
            return self.d
        lo, hi = self.chunk_range(self.unit(u)[2])
        dims = min(hi * GRAM_CHUNK, -(-self.d // 4) * 4) - lo * GRAM_CHUNK
        return self.tile[0] * self.tile[1] * max(dims, 0)


def _tiled(m, n, d, tile, splits, sms) -> GramPlan:
    plan = GramPlan(m, n, d, tile, splits, 1)
    if plan.units > _INT_MAX:
        raise ValueError(f"min-sum ({m}, {n}, {d}) has more units than "
                         f"int32 holds")
    return dataclasses.replace(
        plan, blocks=min(plan.units, GRAM_OCCUPANCY[tile] * sms))


def _cycles(plan: GramPlan, sms: int) -> float:
    """The plan's modelled SM cycles: the busiest SM's units (ceil(units /
    SMs), each at its longest slice, at its tile's rate, plus its fixed
    cycles), then the combine pass where S > 1."""
    longest = -(-plan.chunks // plan.splits) * GRAM_CHUNK
    unit = (plan.tile[0] * plan.tile[1] * longest / GRAM_RATE[plan.tile]
            + GRAM_UNIT_CYCLES)
    cycles = -(-plan.units // sms) * unit
    if plan.splits > 1:
        cycles += ((plan.splits + 1) * plan.m * plan.n * 4
                   / GRAM_PASS_BYTES_PER_CYCLE + GRAM_PASS_CYCLES)
    return cycles


def gram_plan(m: int, n: int, d: int, sms: int, *, tile: tuple | None = None,
              splits: int | None = None, small: bool | None = None,
              op: str | None = None) -> GramPlan:
    """The kernel's plan for x (m, D), y (n, D) on a card with ``sms``
    SMs.  Small mode where m * n < ``GRAM_SMALL_OUTPUTS``.  Otherwise the
    tile and the number of slices S (a power of two, every slice at least
    one 32-d chunk) with the fewest modelled cycles (``_cycles``); ties go
    to fewer slices, then to the larger tile.  The grid is min(units,
    occupancy x sms) blocks.  ``tile``, ``splits`` and ``small`` force a
    choice (the tests' and the chip check's forced plans); a forced S may
    not exceed the chunks of D.  Plans are cached: the search costs more
    host time than a small Gram's launch.

    ``op`` (``"min_sum"``): where nothing is forced and the plan table
    has an entry at (m, D, n), that entry's choice, forced as above (so
    an entry this shape cannot take raises)."""
    if op is not None and tile is None and splits is None and small is None:
        from repro_torch.kernels import registry  # it imports this module
        entry = registry.plan_entry(op, m, d, n)
        if entry is not None:
            if entry["small"]:
                return _gram_plan(m, n, d, sms, None, None, True)
            return _gram_plan(m, n, d, sms, entry["tile"], entry["splits"],
                              False)
    return _gram_plan(m, n, d, sms, tile, splits, small)


@functools.lru_cache(maxsize=1024)
def _gram_plan(m: int, n: int, d: int, sms: int, tile, splits,
               small) -> GramPlan:
    if min(m, n) <= 0 or d <= 0:
        raise ValueError(f"min-sum plan for an empty problem ({m}, {n}, "
                         f"{d})")
    if small is None:
        small = tile is None and splits is None and m * n < \
            GRAM_SMALL_OUTPUTS
    if small:
        return GramPlan(m, n, d, (0, 0), 1, m * n, small=True)
    chunks = -(-d // GRAM_CHUNK)
    if splits is not None and (splits not in GRAM_SPLITS or splits > chunks):
        raise ValueError(f"S = {splits} slices for {chunks} chunks of D; S "
                         f"is one of {GRAM_SPLITS} and at most the chunks")
    if tile is not None and tile not in GRAM_TILES:
        raise ValueError(f"tile must be one of {GRAM_TILES}")
    best = None
    for s in (GRAM_SPLITS if splits is None else (splits,)):
        if s > chunks:
            break
        for t in (GRAM_TILES if tile is None else (tile,)):
            plan = _tiled(m, n, d, t, s, sms)
            if best is None or _cycles(plan, sms) < _cycles(best, sms):
                best = plan
    return best


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def min_sum_plain(x, y):
    """x (m, D), y (n, D) -> (m, n) float32 sums of elementwise minima."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rb = max(1, _CHUNK_ELEMS // max(n * d, 1))
    for r0 in range(0, m, rb):
        out[r0:r0 + rb] = torch.minimum(x[r0:r0 + rb, None, :],
                                        y[None, :, :]).sum(-1)
    return out


def minmax_gram_plain(x, y):
    """Min-max Gram (m, n) of the nonnegative parts of x (m, D), y (n, D)."""
    x, y = _nonneg(x), _nonneg(y)
    return _minmax_epilogue(x, y, min_sum_plain(x, y))


def min_sum_meta(x, y):
    """The output's shape and dtype on ``meta`` tensors, no arithmetic."""
    return torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32,
                       device=x.device)


minmax_gram_meta = min_sum_meta


def _nonneg(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.to(torch.float32), 0.0)


def _minmax_epilogue(x, y, mins):
    maxs = x.sum(-1)[:, None] + y.sum(-1)[None, :] - mins
    return mins / torch.clamp_min(maxs, 1e-30)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def tma_rows(t: torch.Tensor):
    """(rows, row stride in floats) that TMA can read: ``t`` itself where
    its base is 16-byte aligned and D % 4 == 0, else a copy zero-padded to
    ceil(D / 4) * 4 columns."""
    rows, d = t.shape
    if d % 4 == 0 and t.data_ptr() % 16 == 0:
        return t, d
    padded = t.new_zeros((rows, -(-d // 4) * 4))
    padded[:, :d] = t
    return padded, padded.shape[1]


def _check(x, y):
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"the CUDA min-sum kernel takes CUDA tensors; "
                             f"{name} is not one")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D (rows, D); got "
                             f"{tuple(t.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"x has D = {x.shape[1]} but y has D = "
                         f"{y.shape[1]}")
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if max(x.shape + y.shape) > _INT_MAX or x.shape[0] * y.shape[0] > _INT_MAX:
        raise ValueError("min-sum shapes exceed int32")
    return x, y


def min_sum_cuda(x, y, *, plan: GramPlan | None = None):
    """Min-sum Gram kernel (replaces ``_min_sum_pallas``) on ``gram_plan``'s
    plan for x's card, or on ``plan`` when given (it must be a plan for
    this (m, n, D))."""
    x, y = _check(x, y)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or d == 0:
        return out.zero_()
    if plan is None:
        index = x.device.index
        plan = gram_plan(m, n, d, sm_count(
            torch.cuda.current_device() if index is None else index),
            op="min_sum")
    elif (plan.m, plan.n, plan.d) != (m, n, d):
        raise ValueError(f"plan for (m, n, D) = {(plan.m, plan.n, plan.d)} "
                         f"given for {(m, n, d)}")
    ldx = ldy = d
    if not plan.small:
        (x, ldx), (y, ldy) = tma_rows(x), tma_rows(y)
    partials = None
    if plan.splits > 1:   # slice s's partial S at plane s
        partials = torch.empty((plan.splits, m, n), dtype=torch.float32,
                               device=x.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = minmax_gram_library().lib.min_sum_launch(
            x.data_ptr(), y.data_ptr(), m, n, d, ldx, ldy, *plan.tile,
            plan.splits, plan.blocks, int(plan.small),
            None if partials is None else partials.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"min_sum kernel launch failed on {plan}: "
                           f"cudaError {rc}")
    LAUNCHES["min_sum"] += 1
    return out


def minmax_gram_cuda(x, y, *, plan: GramPlan | None = None):
    """Min-max Gram: the min-sum kernel, then the epilogue in PyTorch
    (replaces ``_minmax_gram_pallas``)."""
    x, y = _check(x, y)
    x, y = _nonneg(x), _nonneg(y)
    return _minmax_epilogue(x, y, min_sum_cuda(x, y, plan=plan))
