"""The six CWS kernels: CUDA launchers beside their plain versions.

For each TPU kernel of ``repro/kernels/cws_hash.py`` (the four fused
encodes of the serving path and the two raw (i*, t*) hashes of the
estimator path) this module holds

  * the plain PyTorch version, the definition the kernel is held to: the
    chunked ``cws_hash`` / ``cws_hash_regen`` for the raw hashes, and the
    staged composition ``encode -> feature_indices`` (or ``pack_codes``)
    over them for the encodes;
  * the launcher of the hand-written CUDA kernel, which checks its
    inputs, allocates the output with ``torch.empty``, launches on the
    current stream and raises on a launch error;
  * a launch counter in ``LAUNCHES``, bumped once per kernel launch, and
    one by device body in ``BODY_LAUNCHES``.

Two device bodies serve them.  The regenerated raw hash (row 6) and the
regenerated packed encode (row 3) run on ``csrc/cws_regen_split.cu``
("split": rows tiled in registers, D split across a thread-block
cluster, on the plan ``split_plan`` makes); the other four on
``csrc/cws_encode.cu`` ("pair": one thread per (row, hash)).  Rows 6 and 3
reach the pair body only when a caller asks for it (``body="pair"``, the
timing comparison of the two bodies).

``repro_torch.kernels.ops`` chooses between kernel and plain version by the
tensor's device; a launcher never falls back to the plain version or to
the other body.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.cws import CWSParams, cws_hash, cws_hash_regen
from repro_torch.core.hashing import (check_packed_bits, encode,
                                      feature_indices, pack_codes,
                                      packed_width)
from repro_torch.core.regen import key_words
from repro_torch.kernels.build import (cws_encode_library,
                                      cws_regen_split_library)

# Launches per kernel, and per device body, since the last
# reset_launches(): how a run shows that it really went through the kernels.
LAUNCHES = {"cws_encode": 0, "cws_encode_rng": 0, "cws_encode_packed": 0,
            "cws_encode_rng_packed": 0, "cws_hash": 0, "cws_hash_rng": 0}
BODY_LAUNCHES = {"split": 0, "pair": 0}
# the kernels the split body serves
SPLIT_KERNELS = ("cws_hash_rng", "cws_encode_rng_packed")


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# the split body's plan
# ---------------------------------------------------------------------------

# The split body's constants (csrc/cws_regen_split.cu)
SPLIT_HASH_TILE = 32                   # hashes per block, one per lane
SPLIT_WARPS = 16                       # warps per block
SPLIT_CHUNK = 64                       # dimensions per shared-memory chunk
SPLIT_ROWS_PER_THREAD = (1, 2, 4, 8)   # its instantiations
SPLIT_SIZES = (1, 2, 4, 8)             # CTAs per cluster
SPLIT_BLOCKS_PER_SM = 2                # resident blocks an SM holds


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


def split_plan(n: int, d: int, k: int, sms: int) -> SplitPlan:
    """The split body's tiles for x (n, D) and k hashes on a card with
    ``sms`` SMs.  Row warps and rows per thread: the fewest of each, in
    that order, that cover n up to 16 x 8 = 128 rows a block (so at
    n >= 128 a block holds 128 rows and a parameter is regenerated once per
    128 rows); the warps left over split each chunk of D.  Splits: the
    most CTAs a cluster that keep the grid within one wave of
    ``SPLIT_BLOCKS_PER_SM`` blocks per SM, as long as every rank keeps a
    whole chunk of D (a rank with less pays the block's fixed costs, the
    staging barriers and the combine, for a fraction of a chunk's work)."""
    row_warps, top = 1, SPLIT_ROWS_PER_THREAD[-1]
    while row_warps < SPLIT_WARPS and row_warps * top < n:
        row_warps *= 2
    rows = SPLIT_ROWS_PER_THREAD[0]
    while rows < top and row_warps * rows < n:
        rows *= 2
    plan = SplitPlan(n, d, k, rows, row_warps, 1)
    tiles = plan.blocks
    splits = 1
    while (splits < SPLIT_SIZES[-1]
           and tiles * 2 * splits <= SPLIT_BLOCKS_PER_SM * sms
           and d // (2 * splits) >= SPLIT_CHUNK):
        splits *= 2
    return dataclasses.replace(plan, splits=splits)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _launch(name: str, fn, out: torch.Tensor, *args,
            body: str = "pair") -> torch.Tensor:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({body} body): "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
    BODY_LAUNCHES[body] += 1
    return out


def _lib():
    return cws_encode_library().lib


def _split_body(body) -> str:
    body = "split" if body is None else body
    if body not in BODY_LAUNCHES:
        raise ValueError(f"body must be one of {tuple(BODY_LAUNCHES)}; got "
                         f"{body!r}")
    return body


def _plan_args(x: torch.Tensor, k: int):
    n, d = x.shape
    index = x.device.index
    plan = split_plan(n, d, k, sm_count(
        torch.cuda.current_device() if index is None else index))
    return plan.rows_per_thread, plan.row_warps, plan.splits


def cws_encode_cuda(x, params: CWSParams, *, b_i: int, b_t: int = 0):
    """Stored-parameter encode kernel (replaces ``cws_encode_pallas``)."""
    x = _check_x(x)
    _check_params(x, params)
    _check_bits(b_i, b_t, packed=False)
    n, d = x.shape
    k = params.num_hashes
    out = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n == 0 or k == 0:
        return out
    return _launch("cws_encode", _lib().cws_encode_launch, out,
                   x.data_ptr(), params.r.data_ptr(),
                   params.log_c.data_ptr(), params.beta.data_ptr(),
                   n, d, k, b_i, b_t, out.data_ptr())


def cws_encode_rng_cuda(x, key, num_hashes: int, *, b_i: int, b_t: int = 0):
    """Regenerated-parameter encode kernel (replaces
    ``cws_encode_rng_pallas``): the only input in device memory is x."""
    x = _check_x(x)
    _check_bits(b_i, b_t, packed=False)
    k0, k1 = key_words(key)
    n, d = x.shape
    out = torch.empty((n, num_hashes), dtype=torch.int32, device=x.device)
    if n == 0 or num_hashes == 0:
        return out
    return _launch("cws_encode_rng", _lib().cws_encode_rng_launch, out,
                   x.data_ptr(), k0, k1, n, d, num_hashes, b_i, b_t,
                   out.data_ptr())


def cws_encode_packed_cuda(x, params: CWSParams, *, b_i: int, b_t: int = 0):
    """Stored-parameter encode with packed emit (replaces
    ``cws_encode_packed_pallas``)."""
    x = _check_x(x)
    _check_params(x, params)
    _check_bits(b_i, b_t, packed=True)
    n, d = x.shape
    k = params.num_hashes
    words = packed_width(k, b_i + b_t)
    out = torch.empty((n, words), dtype=torch.uint32, device=x.device)
    if n == 0 or k == 0:
        return out
    return _launch("cws_encode_packed", _lib().cws_encode_packed_launch, out,
                   x.data_ptr(), params.r.data_ptr(),
                   params.log_c.data_ptr(), params.beta.data_ptr(),
                   n, d, k, b_i, b_t, out.data_ptr(), words)


def cws_encode_rng_packed_cuda(x, key, num_hashes: int, *, b_i: int,
                               b_t: int = 0, body: str | None = None):
    """Regenerated-parameter encode with packed emit (replaces
    ``cws_encode_rng_packed_pallas``) on the split body, or on ``body``
    when given (the timing comparison of the two bodies)."""
    body = _split_body(body)
    x = _check_x(x)
    _check_bits(b_i, b_t, packed=True)
    k0, k1 = key_words(key)
    n, d = x.shape
    words = packed_width(num_hashes, b_i + b_t)
    out = torch.empty((n, words), dtype=torch.uint32, device=x.device)
    if n == 0 or num_hashes == 0:
        return out
    if body == "pair":
        return _launch("cws_encode_rng_packed",
                       _lib().cws_encode_rng_packed_launch, out,
                       x.data_ptr(), k0, k1, n, d, num_hashes, b_i, b_t,
                       out.data_ptr(), words)
    return _launch("cws_encode_rng_packed",
                   cws_regen_split_library().lib.cws_regen_split_packed_launch,
                   out, x.data_ptr(), k0, k1, n, d, num_hashes, b_i, b_t,
                   *_plan_args(x, num_hashes), out.data_ptr(), words,
                   body=body)


def cws_hash_cuda(x, params: CWSParams):
    """Stored-parameter raw hash kernel (replaces ``cws_hash_pallas``):
    x (n, D) -> (i*, t*) each (n, k) int32."""
    x = _check_x(x)
    _check_params(x, params)
    n, d = x.shape
    k = params.num_hashes
    i_star = torch.empty((n, k), dtype=torch.int32, device=x.device)
    t_star = torch.empty_like(i_star)
    if n == 0 or k == 0:
        return i_star, t_star
    _launch("cws_hash", _lib().cws_hash_launch, i_star, x.data_ptr(),
            params.r.data_ptr(), params.log_c.data_ptr(),
            params.beta.data_ptr(), n, d, k, i_star.data_ptr(),
            t_star.data_ptr())
    return i_star, t_star


def cws_hash_rng_cuda(x, key, num_hashes: int, *, body: str | None = None):
    """Regenerated-parameter raw hash kernel (replaces
    ``cws_hash_rng_pallas``): the only input in device memory is x.  On
    the split body, or on ``body`` when given."""
    body = _split_body(body)
    x = _check_x(x)
    k0, k1 = key_words(key)
    n, d = x.shape
    i_star = torch.empty((n, num_hashes), dtype=torch.int32, device=x.device)
    t_star = torch.empty_like(i_star)
    if n == 0 or num_hashes == 0:
        return i_star, t_star
    if body == "pair":
        _launch("cws_hash_rng", _lib().cws_hash_rng_launch, i_star,
                x.data_ptr(), k0, k1, n, d, num_hashes, i_star.data_ptr(),
                t_star.data_ptr())
    else:
        _launch("cws_hash_rng",
                cws_regen_split_library().lib.cws_regen_split_hash_launch,
                i_star, x.data_ptr(), k0, k1, n, d, num_hashes,
                *_plan_args(x, num_hashes), i_star.data_ptr(),
                t_star.data_ptr(), body=body)
    return i_star, t_star
