"""Output coverage: every output element written by exactly one block
(the counterpart of ``repro.analysis.coverage``).

The reference evaluates each Pallas BlockSpec index map over its grid.
The port's kernels compute which outputs a block writes in C++, so each
kernel's write arithmetic is mirrored here from its source, block by
block and cell by cell, and evaluated over the plan's whole grid:

  * rows 1-6 (``csrc/cws_split.cu``): the cluster's rank 0 writes its
    (row tile, hash tile)'s cells ``row0 + c / 32, h0 + c % 32`` that lie
    inside (n, k), or for the packed emit the tile's words ``h0 / cpw +
    wi``; the ranks' D ranges must partition D;
  * row 7 (``csrc/minmax_gram.cu``): a persistent block takes units b, b
    + blocks, ...; a unit's consumer threads write rows ``tm BM + wm 4 RM
    + lm + 4 i`` and columns ``tn BN + wn 8 RN + ln + 8 j`` of its slice's
    plane; the slices' chunk ranges partition D's chunks, and the combine
    pass's grid-stride loop covers each output once; the small mode one
    block an output;
  * rows 8-9 (``csrc/flash_attention*.cu``): ``FlashPlan.block_writes``,
    the (batch, head, rows) of each block's consumers, all D columns.

Ragged shapes are the point: n not a multiple of the row tile, k not of
the hash tile, D not of the chunk nor of 4, Sq not of 64.  That the
mirrors match the kernels is checked on the card: each row is launched at
such a shape into an output between guard bands (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from repro_torch.core.hashing import PACKED_BITS
from repro_torch.kernels import cws_hash, registry
from .report import Finding

__all__ = ["audit_coverage", "audit_plan_coverage", "split_counts",
           "gram_counts", "flash_counts", "check_counts", "RAGGED_SHAPES"]

# n x D x k (CWS), m x D x n (min_sum), (b, sq, h, g, d) (flash)
RAGGED_SHAPES = {
    "cws": (77, 150, 70), "min_sum": (150, 99, 90),
    "flash": ((2, 100, 8, 2), (1, 100, 4, 4), (1, 100, 6, 2)),
}
FLASH_COVER_DIMS = (40, 64, 100, 128, 192, 256)
_BK = cws_hash.SPLIT_HASH_TILE


def check_counts(counts: np.ndarray, what: str, target: str
                 ) -> List[Finding]:
    """Findings for the elements of ``counts`` written other than once."""
    out = []
    twice = np.argwhere(counts > 1)
    never = np.argwhere(counts == 0)
    if len(twice):
        out.append(Finding(
            check="coverage", target=target,
            message=(f"{what}: {len(twice)} output element(s) written more "
                     f"than once (first {twice[:3].tolist()}): a later "
                     f"block overwrites an earlier one's result"),
            details={"doubled": twice[:16].tolist()}))
    if len(never):
        out.append(Finding(
            check="coverage", target=target,
            message=(f"{what}: {len(never)} output element(s) never written "
                     f"(first {never[:3].tolist()}): they ship whatever the "
                     f"allocation held"),
            details={"missing": never[:16].tolist()}))
    return out


def split_counts(plan, *, packed_bits: int = 0) -> np.ndarray:
    """Writes per output element of the split body on ``plan``: (n, k)
    for the index and raw emits, (n, words) for the packed emit of
    ``packed_bits`` bits a code."""
    n, k = plan.n, plan.k
    bn = plan.block_rows
    gx, gy, gz = plan.grid
    if packed_bits:
        cpw = 32 // packed_bits
        cols = -(-k // cpw)
        words = _BK // cpw
    else:
        cols = k
    counts = np.zeros((n, cols), np.int64)
    for bz in range(gz):
        if bz % plan.splits:          # ranks 1..S-1 write nothing
            continue
        for by in range(gy):
            row0 = by * bn
            for bx in range(gx):
                h0 = bx * _BK
                if packed_bits:
                    e = np.arange(bn * words)
                    rows, w = row0 + e // words, h0 // cpw + e % words
                    ok = (rows < n) & (w < cols)
                else:
                    c = np.arange(bn * _BK)
                    rows, w = row0 + c // _BK, h0 + c % _BK
                    ok = (rows < n) & (w < k)
                np.add.at(counts, (rows[ok], w[ok]), 1)
    return counts


def split_d_counts(plan) -> np.ndarray:
    """Ranks reducing each d of D (``SplitPlan.d_range``)."""
    counts = np.zeros(plan.d, np.int64)
    for s in range(plan.splits):
        lo, hi = plan.d_range(s)
        counts[lo:hi] += 1
    return counts


def gram_counts(plan):
    """(writes per (slice, m, n) of the tiled kernel or per output of the
    small kernel, the combine pass's writes per output or None, the
    slices' cover of D's chunks or None) of the Gram on ``plan``."""
    m, n = plan.m, plan.n
    if plan.small:
        counts = np.zeros(m * n, np.int64)
        counts[np.arange(plan.blocks)[np.arange(plan.blocks) < m * n]] += 1
        return counts.reshape(1, m, n), None, None
    rm, rn, wm, wn = registry.GRAM_TILE_SHAPES[plan.tile]
    bm, bnn = plan.tile
    planes = plan.splits
    counts = np.zeros((planes, m, n), np.int64)
    # a tile's (row, column) offsets over its consumer threads
    w_m, w_n, l_m, l_n, i, j = np.meshgrid(
        np.arange(wm), np.arange(wn), np.arange(4), np.arange(8),
        np.arange(rm), np.arange(rn), indexing="ij")
    r_off = (w_m * 4 * rm + l_m + 4 * i).ravel()
    c_off = (w_n * 8 * rn + l_n + 8 * j).ravel()
    for b in range(plan.blocks):
        for u in plan.block_units(b):
            tm, tn, s = plan.unit(u)
            rows, cols = tm * bm + r_off, tn * bnn + c_off
            ok = (rows < m) & (cols < n)
            np.add.at(counts, (s if planes > 1 else 0, rows[ok], cols[ok]),
                      1)
    chunks = np.zeros(plan.chunks, np.int64)
    for s in range(plan.splits):
        lo, hi = plan.chunk_range(s)
        chunks[lo:hi] += 1
    combine = None
    if plan.splits > 1:
        plane = m * n
        threads = 256
        grid = min(4096, -(-plane // threads))
        combine = np.zeros(plane, np.int64)
        e = np.arange(grid * threads)
        while len(e):
            e = e[e < plane]
            combine[e] += 1
            e = e + grid * threads
        combine = combine.reshape(m, n)
    return counts, combine, chunks


def flash_counts(plan) -> np.ndarray:
    """Writes per (batch, row, head) of rows 8-9 on ``plan``; -1 where a
    block writes fewer than D columns of a row."""
    counts = np.zeros((plan.b, plan.sq, plan.h), np.int64)
    gx, gy, gz = plan.grid
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                for bi, head, lo, hi, cols in plan.block_writes(bx, by, bz):
                    counts[bi, lo:hi, head] += 1 if cols == plan.d else -1000
    return counts


def audit_plan_coverage(fam: str, plan, *, target: str = "",
                        packed_bits: int = 0) -> List[Finding]:
    """The coverage findings of one plan of ``fam``."""
    target = target or fam
    what = f"plan {plan}"
    if fam in registry.CWS_FAMILIES:
        out = check_counts(split_counts(plan, packed_bits=packed_bits),
                           what + (f", {packed_bits}-bit codes"
                                   if packed_bits else ""), target)
        return out + check_counts(split_d_counts(plan),
                                  what + ": D over the cluster's ranks",
                                  target)
    if fam == "min_sum":
        counts, combine, chunks = gram_counts(plan)
        out = check_counts(counts, what, target)
        if combine is not None:
            out += check_counts(combine, what + ": the combine pass", target)
        if chunks is not None:
            out += check_counts(chunks, what + ": D's chunks over the slices",
                                target)
        return out
    if fam in registry.FLASH_FAMILIES:
        counts = flash_counts(plan)
        if (counts < 0).any():
            return [Finding(check="coverage", target=target, message=(
                f"{what}: a block writes fewer than D = {plan.d} columns "
                f"of its rows: the body's columns a thread do not cover "
                f"the head dim"))]
        return check_counts(counts, what, target)
    return [Finding(check="coverage", target=target, message=(
        f"family {fam!r} has no write mirror in analysis/coverage.py"))]


def coverage_plans(fam: str, sms: int = registry.H100_SMS):
    """(plan, packed bits) pairs audited for ``fam``: every candidate and
    the heuristic's choice at the family's ragged shape(s)."""
    if fam in registry.FLASH_FAMILIES:
        shapes = [s + (d,) for s in RAGGED_SHAPES["flash"]
                  for d in FLASH_COVER_DIMS]
    else:
        shapes = [RAGGED_SHAPES["min_sum" if fam == "min_sum" else "cws"]]
    bits = PACKED_BITS if fam in ("cws_packed", "cws_rng_packed") else (0,)
    out = []
    for shape in shapes:
        plans = [registry.plan_of(fam, shape, c, sms)
                 for c in registry.plan_candidates(fam, shape)]
        plans.append(registry.plan_of(fam, shape, None, sms))
        out += [(p, b) for p in dict.fromkeys(plans) for b in bits]
    return out


def audit_coverage(families: Optional[Iterable[str]] = None,
                   stats: Optional[dict] = None) -> List[Finding]:
    from .smem import model_families
    findings: List[Finding] = []
    for fam in (families or model_families()):
        plans = coverage_plans(fam)
        for plan, bits in plans:
            findings.extend(audit_plan_coverage(fam, plan,
                                                packed_bits=bits))
        if stats is not None:
            stats[fam] = {"n_plans": len(plans)}
    return findings
