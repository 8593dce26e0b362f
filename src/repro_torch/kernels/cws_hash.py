"""The six CWS kernels: CUDA launchers beside their plain versions.

For each TPU kernel of ``repro/kernels/cws_hash.py`` (the four fused
encodes of the serving path and the two raw (i*, t*) hashes of the
kernel-machine and estimator paths) this module holds

  * the plain PyTorch version, the definition the kernel is held to: the
    chunked ``cws_hash`` / ``cws_hash_regen`` for the raw hashes, and the
    staged composition ``encode -> feature_indices`` (or ``pack_codes``)
    over them for the encodes;
  * the launcher of the hand-written CUDA kernel, which checks its
    inputs, allocates the output with ``torch.empty``, launches on the
    current stream and raises on a launch error;
  * a launch counter in ``LAUNCHES``, bumped once per kernel launch.

Every row runs on ``csrc/cws_split.cu``: rows tiled in registers, D split
across a thread-block cluster, on the plan ``split_plan`` makes; the
stored-parameter rows 2, 4 and 5 on its ``stored=True`` plan, their
parameter tiles copied in with ``cp.async``, 16 or 4 bytes a copy as
``stored_copy_bytes`` says.

``repro_torch.kernels.ops`` chooses between kernel and plain version by the
tensor's device; a launcher never falls back to the plain version.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cws import CWSParams, cws_hash, cws_hash_regen
from repro_torch.core.hashing import (check_packed_bits, encode,
                                      feature_indices, pack_codes,
                                      packed_width)
from repro_torch.core.regen import key_words
from repro_torch.device import sm_count
from repro_torch.kernels.build import cws_split_library

# Launches per kernel since the last reset_launches(): how a run shows
# that it really went through the kernels.
LAUNCHES = {"cws_encode": 0, "cws_encode_rng": 0, "cws_encode_packed": 0,
            "cws_encode_rng_packed": 0, "cws_hash": 0, "cws_hash_rng": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the split body's plan
# ---------------------------------------------------------------------------

# The split body's constants (csrc/cws_split.cu)
SPLIT_HASH_TILE = 32                   # hashes per block, one per lane
SPLIT_WARPS = 16                       # warps per block
SPLIT_CHUNK = 64                       # dimensions per shared-memory chunk
SPLIT_ROWS_PER_THREAD = (1, 2, 4, 8)   # its instantiations
SPLIT_SIZES = (1, 2, 4, 8)             # CTAs per cluster
SPLIT_ROW_WARPS = (1, 2, 4, 8, 16)     # row warps a block may take
SPLIT_BLOCKS_PER_SM = 2                # resident blocks an SM holds
# the least rows a stored-parameter block is cut to: below it the tiles'
# loads and the block's fixed costs outweigh its rows' steps
SPLIT_STORED_MIN_ROWS = 8


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the split body covers an (n, D, k) problem: blocks of
    ``row_warps`` x ``d_warps`` warps, each thread holding
    ``rows_per_thread`` rows of one hash (a block: 32 hashes);
    ``splits`` CTAs a cluster, rank s reducing D's range
    ``d_range(s)``."""

    n: int
    d: int
    k: int
    rows_per_thread: int
    row_warps: int
    splits: int

    @property
    def block_rows(self) -> int:
        return self.rows_per_thread * self.row_warps

    @property
    def d_warps(self) -> int:
        return SPLIT_WARPS // self.row_warps

    @property
    def grid(self):
        """(hash tiles, row tiles, splits)."""
        return (-(-self.k // SPLIT_HASH_TILE), -(-self.n // self.block_rows),
                self.splits)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    def d_range(self, rank: int):
        """[lo, hi) of D that cluster rank ``rank`` reduces."""
        return (self.d * rank // self.splits,
                self.d * (rank + 1) // self.splits)


def _row_tile(rows: int):
    """(rows per thread, row warps): the fewest row warps, then rows per
    thread, that cover ``rows`` up to 16 x 8 = 128 rows a block."""
    row_warps, top = 1, SPLIT_ROWS_PER_THREAD[-1]
    while row_warps < SPLIT_WARPS and row_warps * top < rows:
        row_warps *= 2
    per_thread = SPLIT_ROWS_PER_THREAD[0]
    while per_thread < top and row_warps * per_thread < rows:
        per_thread *= 2
    return per_thread, row_warps


def short_tail(blocks: int, wave: int) -> bool:
    """A grid of ``blocks`` past one ``wave`` whose last wave is less
    than half full: that wave costs a whole block time for a few SMs."""
    return blocks > wave and 0 < blocks % wave < wave / 2


def check_plan_fields(rows_per_thread: int, row_warps: int,
                      splits: int) -> None:
    """Raise unless the split body has an instantiation of these fields:
    rows per thread in ``SPLIT_ROWS_PER_THREAD``, a power of two of row
    warps up to ``SPLIT_WARPS``, splits in ``SPLIT_SIZES``."""
    if (rows_per_thread not in SPLIT_ROWS_PER_THREAD
            or row_warps not in SPLIT_ROW_WARPS or splits not in SPLIT_SIZES):
        raise ValueError(
            f"split plan (rows per thread {rows_per_thread}, row warps "
            f"{row_warps}, splits {splits}): rows per thread one of "
            f"{SPLIT_ROWS_PER_THREAD}, row warps one of {SPLIT_ROW_WARPS}, "
            f"splits one of {SPLIT_SIZES}")


def check_plan(plan: SplitPlan) -> SplitPlan:
    """``plan`` if the split body can launch it at its shape (the
    launcher's own checks: D of at least one dimension a rank, at most
    65,535 row tiles), else raise."""
    check_plan_fields(plan.rows_per_thread, plan.row_warps, plan.splits)
    if plan.splits > 1 and plan.d < plan.splits:
        raise ValueError(f"{plan}: {plan.splits} ranks for D = {plan.d}")
    if plan.grid[1] > 65535:
        raise ValueError(f"{plan}: {plan.grid[1]} row tiles, more than "
                         f"the grid's 65,535")
    return plan


def table_plan(op: str, n: int, d: int, k: int):
    """The plan table's plan for ``op`` at (n, D, k), checked for the
    shape, or None where the table has no entry."""
    from repro_torch.kernels import registry   # registry imports this module
    entry = registry.plan_entry(op, n, d, k)
    if entry is None:
        return None
    return check_plan(SplitPlan(n, d, k, **entry))


def split_plan(n: int, d: int, k: int, sms: int, *,
               stored: bool = False, op: str | None = None) -> SplitPlan:
    """The split body's tiles for x (n, D) and k hashes on a card with
    ``sms`` SMs.  Row warps and rows per thread: the fewest of each, in
    that order, that cover n up to 16 x 8 = 128 rows a block (so at
    n >= 128 a block holds 128 rows and a parameter is regenerated once per
    128 rows); the warps left over split each chunk of D.  Splits: the
    most CTAs a cluster that keep the grid within one wave of
    ``SPLIT_BLOCKS_PER_SM`` blocks per SM, as long as every rank keeps a
    whole chunk of D (a rank with less pays the block's fixed costs, the
    staging barriers and the combine, for a fraction of a chunk's work).

    ``stored`` (parameters loaded, not regenerated: no cost to amortize
    over a tall row tile): before the split, the row tile halves, down to
    ``SPLIT_STORED_MIN_ROWS`` rows, while the grid keeps room for two CTAs
    a cluster within the wave, or while it runs past one wave with its
    last wave less than half full (``short_tail``: at 1,200 rows on 132
    SMs, 128-row tiles make 320 blocks, 1.21 waves).

    ``op`` (a CWS op or family): where the plan table has an entry for
    it at this shape, that entry's plan instead, raising if it cannot
    launch here."""
    if op is not None:
        tuned = table_plan(op, n, d, k)
        if tuned is not None:
            return tuned
    plan = SplitPlan(n, d, k, *_row_tile(n), 1)
    wave = SPLIT_BLOCKS_PER_SM * sms
    while stored and plan.block_rows > SPLIT_STORED_MIN_ROWS:
        rows, row_warps = _row_tile(plan.block_rows // 2)
        half = dataclasses.replace(plan, rows_per_thread=rows,
                                   row_warps=row_warps)
        if 2 * half.blocks > wave and not short_tail(plan.blocks, wave):
            break
        plan = half
    tiles = plan.blocks
    splits = 1
    while (splits < SPLIT_SIZES[-1] and tiles * 2 * splits <= wave
           and d // (2 * splits) >= SPLIT_CHUNK):
        splits *= 2
    return dataclasses.replace(plan, splits=splits)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def cws_hash_plain(x, params: CWSParams):
    """x (n, D) nonneg -> (i*, t*) each (n, k) int32; t* clipped to
    +-2^30, an all-zero row gives (-1, 0)."""
    return cws_hash(x, params)


def cws_hash_rng_plain(x, key, num_hashes: int):
    """As ``cws_hash_plain`` with parameters regenerated from ``key``."""
    return cws_hash_regen(x, key, num_hashes)


def cws_encode_plain(x, params: CWSParams, *, b_i: int, b_t: int = 0):
    """x (n, D) nonneg -> (n, k) int32 embedding-bag indices."""
    i_star, t_star = cws_hash(x, params)
    codes = encode(i_star, t_star, b_i=b_i, b_t=b_t)
    return feature_indices(codes, b_i=b_i, b_t=b_t)


def cws_encode_rng_plain(x, key, num_hashes: int, *, b_i: int, b_t: int = 0):
    """As ``cws_encode_plain`` with parameters regenerated from ``key``."""
    i_star, t_star = cws_hash_regen(x, key, num_hashes)
    codes = encode(i_star, t_star, b_i=b_i, b_t=b_t)
    return feature_indices(codes, b_i=b_i, b_t=b_t)


def cws_encode_packed_plain(x, params: CWSParams, *, b_i: int, b_t: int = 0):
    """x (n, D) nonneg -> (n, ceil(k*b/32)) uint32 packed codes."""
    i_star, t_star = cws_hash(x, params)
    return pack_codes(encode(i_star, t_star, b_i=b_i, b_t=b_t), b=b_i + b_t)


def cws_encode_rng_packed_plain(x, key, num_hashes: int, *, b_i: int,
                                b_t: int = 0):
    i_star, t_star = cws_hash_regen(x, key, num_hashes)
    return pack_codes(encode(i_star, t_star, b_i=b_i, b_t=b_t), b=b_i + b_t)


# ---------------------------------------------------------------------------
# meta route: the outputs' shapes and dtypes, no arithmetic (the dry run and
# the contract audits of ``repro_torch.analysis``)
# ---------------------------------------------------------------------------

def _meta_out(x, k: int, cols: int | None = None, dtype=torch.int32):
    return torch.empty((x.shape[0], k if cols is None else cols),
                       dtype=dtype, device=x.device)


def cws_hash_meta(x, params: CWSParams):
    return _meta_out(x, params.num_hashes), _meta_out(x, params.num_hashes)


def cws_hash_rng_meta(x, key, num_hashes: int):
    return _meta_out(x, num_hashes), _meta_out(x, num_hashes)


def cws_encode_meta(x, params: CWSParams, *, b_i: int, b_t: int = 0):
    return _meta_out(x, params.num_hashes)


def cws_encode_rng_meta(x, key, num_hashes: int, *, b_i: int, b_t: int = 0):
    return _meta_out(x, num_hashes)


def cws_encode_packed_meta(x, params: CWSParams, *, b_i: int, b_t: int = 0):
    return _meta_out(x, 0, packed_width(params.num_hashes, b_i + b_t),
                     torch.uint32)


def cws_encode_rng_packed_meta(x, key, num_hashes: int, *, b_i: int,
                               b_t: int = 0):
    return _meta_out(x, 0, packed_width(num_hashes, b_i + b_t), torch.uint32)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_INT_MAX = 2 ** 31 - 1


def _check_x(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("the CUDA CWS kernels take a CUDA tensor x")
    if x.ndim != 2:
        raise ValueError(f"x must be (n, D); got {tuple(x.shape)}")
    x = x.to(torch.float32)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major (n, D))")
    if max(x.shape) > _INT_MAX:
        raise ValueError(f"x shape {tuple(x.shape)} exceeds int32")
    return x


def _check_params(x: torch.Tensor, params: CWSParams) -> None:
    for name in ("r", "log_c", "beta"):
        m = getattr(params, name)
        if m.device != x.device or m.dtype != torch.float32:
            raise ValueError(f"params.{name} must be float32 on {x.device}; "
                             f"got {m.dtype} on {m.device}")
        if m.shape != params.r.shape or not m.is_contiguous():
            raise ValueError(f"params.{name} must be a contiguous (D, k) "
                             f"matrix like r {tuple(params.r.shape)}")
    if params.dim != x.shape[1]:
        raise ValueError(f"x has D = {x.shape[1]} but params have "
                         f"D = {params.dim}")


def _check_bits(b_i: int, b_t: int, packed: bool) -> None:
    if b_i < 0 or b_t < 0 or b_i + b_t > 30:
        raise ValueError(f"need 0 <= b_i, b_t and b_i + b_t <= 30; got "
                         f"b_i = {b_i}, b_t = {b_t}")
    if packed:
        if b_i < 1:
            raise ValueError("packed codes need b_i >= 1")
        check_packed_bits(b_i + b_t)


def _launch(name: str, fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def _lib():
    return cws_split_library().lib


def _plan_args(x: torch.Tensor, k: int, op: str, *, stored: bool = False,
               plan: SplitPlan | None = None):
    """The split body's (rows per thread, row warps, splits) for x and k:
    ``plan`` if given (it must be a legal plan for this (n, D, k)), else
    ``split_plan``'s for ``op`` on x's card."""
    n, d = x.shape
    if plan is None:
        index = x.device.index
        plan = split_plan(n, d, k, sm_count(
            torch.cuda.current_device() if index is None else index),
            stored=stored, op=op)
    elif (plan.n, plan.d, plan.k) != (n, d, k):
        raise ValueError(f"plan for (n, D, k) = {(plan.n, plan.d, plan.k)} "
                         f"given for {(n, d, k)}")
    else:
        check_plan(plan)
    return plan.rows_per_thread, plan.row_warps, plan.splits


def stored_copy_bytes(params: CWSParams) -> int:
    """The width of the split body's copies of stored parameter tiles: 16
    bytes (four hashes) where k % 4 == 0 and r, log c and beta start on
    16-byte boundaries, else 4."""
    aligned = all(getattr(params, name).data_ptr() % 16 == 0
                  for name in ("r", "log_c", "beta"))
    return 16 if params.num_hashes % 4 == 0 and aligned else 4


def _stored_ptrs(x, params: CWSParams):
    return (x.data_ptr(), params.r.data_ptr(), params.log_c.data_ptr(),
            params.beta.data_ptr())


def cws_encode_cuda(x, params: CWSParams, *, b_i: int, b_t: int = 0,
                    plan: SplitPlan | None = None):
    """Stored-parameter encode kernel (replaces ``cws_encode_pallas``) on
    ``split_plan(..., stored=True)``'s tiles, or ``plan``'s when given (the
    timing comparison of two plans)."""
    x = _check_x(x)
    _check_params(x, params)
    _check_bits(b_i, b_t, packed=False)
    n, d = x.shape
    k = params.num_hashes
    out = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n == 0 or k == 0:
        return out
    return _launch("cws_encode", _lib().cws_split_stored_index_launch, out,
                   *_stored_ptrs(x, params), n, d, k, b_i, b_t,
                   *_plan_args(x, k, "cws_encode", stored=True, plan=plan),
                   stored_copy_bytes(params), out.data_ptr())


def cws_encode_rng_cuda(x, key, num_hashes: int, *, b_i: int, b_t: int = 0,
                        plan: SplitPlan | None = None):
    """Regenerated-parameter encode kernel (replaces
    ``cws_encode_rng_pallas``): the only input in device memory is x.
    ``plan`` forces a plan (the autotune sweep's candidates)."""
    x = _check_x(x)
    _check_bits(b_i, b_t, packed=False)
    k0, k1 = key_words(key)
    n, d = x.shape
    out = torch.empty((n, num_hashes), dtype=torch.int32, device=x.device)
    if n == 0 or num_hashes == 0:
        return out
    return _launch("cws_encode_rng", _lib().cws_split_index_launch, out,
                   x.data_ptr(), k0, k1, n, d, num_hashes, b_i, b_t,
                   *_plan_args(x, num_hashes, "cws_encode_rng", plan=plan),
                   out.data_ptr())


def cws_encode_packed_cuda(x, params: CWSParams, *, b_i: int, b_t: int = 0,
                           plan: SplitPlan | None = None):
    """Stored-parameter encode with packed emit (replaces
    ``cws_encode_packed_pallas``) on ``split_plan(..., stored=True)``'s
    tiles, or ``plan``'s."""
    x = _check_x(x)
    _check_params(x, params)
    _check_bits(b_i, b_t, packed=True)
    n, d = x.shape
    k = params.num_hashes
    words = packed_width(k, b_i + b_t)
    out = torch.empty((n, words), dtype=torch.uint32, device=x.device)
    if n == 0 or k == 0:
        return out
    return _launch("cws_encode_packed", _lib().cws_split_stored_packed_launch,
                   out, *_stored_ptrs(x, params), n, d, k, b_i, b_t,
                   *_plan_args(x, k, "cws_encode_packed", stored=True,
                               plan=plan),
                   stored_copy_bytes(params), out.data_ptr(), words)


def cws_encode_rng_packed_cuda(x, key, num_hashes: int, *, b_i: int,
                               b_t: int = 0, plan: SplitPlan | None = None):
    """Regenerated-parameter encode with packed emit (replaces
    ``cws_encode_rng_packed_pallas``); ``plan`` forces a plan."""
    x = _check_x(x)
    _check_bits(b_i, b_t, packed=True)
    k0, k1 = key_words(key)
    n, d = x.shape
    words = packed_width(num_hashes, b_i + b_t)
    out = torch.empty((n, words), dtype=torch.uint32, device=x.device)
    if n == 0 or num_hashes == 0:
        return out
    return _launch("cws_encode_rng_packed",
                   _lib().cws_regen_split_packed_launch, out, x.data_ptr(),
                   k0, k1, n, d, num_hashes, b_i, b_t,
                   *_plan_args(x, num_hashes, "cws_encode_rng_packed",
                               plan=plan),
                   out.data_ptr(), words)


def cws_hash_cuda(x, params: CWSParams, *, plan: SplitPlan | None = None):
    """Stored-parameter raw hash kernel (replaces ``cws_hash_pallas``):
    x (n, D) -> (i*, t*) each (n, k) int32, on ``split_plan(...,
    stored=True)``'s tiles, or ``plan``'s."""
    x = _check_x(x)
    _check_params(x, params)
    n, d = x.shape
    k = params.num_hashes
    i_star = torch.empty((n, k), dtype=torch.int32, device=x.device)
    t_star = torch.empty_like(i_star)
    if n == 0 or k == 0:
        return i_star, t_star
    _launch("cws_hash", _lib().cws_split_stored_hash_launch, i_star,
            *_stored_ptrs(x, params), n, d, k,
            *_plan_args(x, k, "cws_hash", stored=True, plan=plan),
            stored_copy_bytes(params), i_star.data_ptr(), t_star.data_ptr())
    return i_star, t_star


def cws_hash_rng_cuda(x, key, num_hashes: int):
    """Regenerated-parameter raw hash kernel (replaces
    ``cws_hash_rng_pallas``): the only input in device memory is x."""
    x = _check_x(x)
    k0, k1 = key_words(key)
    n, d = x.shape
    i_star = torch.empty((n, num_hashes), dtype=torch.int32, device=x.device)
    t_star = torch.empty_like(i_star)
    if n == 0 or num_hashes == 0:
        return i_star, t_star
    _launch("cws_hash_rng", _lib().cws_regen_split_hash_launch, i_star,
            x.data_ptr(), k0, k1, n, d, num_hashes,
            *_plan_args(x, num_hashes, "cws_hash_rng"), i_star.data_ptr(),
            t_star.data_ptr())
    return i_star, t_star
