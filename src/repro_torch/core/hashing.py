"""Encodings of CWS samples and collision estimators (port of
``repro.core.hashing``).

Hash j with code z contributes the one-hot index ``j * 2^{b_i+b_t} + z``;
packed mode stores the b-bit codes of a row in uint32 words instead.
Integer arithmetic runs in int64; packed words are ``torch.uint32`` at the
public edge (built and read through an int32 view, since CPU and CUDA
kernels for uint32 arithmetic are missing).
"""
from __future__ import annotations

import torch

PACKED_BITS = (1, 2, 4, 8)   # word-aligned b values the packed format serves


def encode(i_star: torch.Tensor, t_star: torch.Tensor, *, b_i: int = 0,
           b_t: int = 0) -> torch.Tensor:
    """Per-hash codes; b_i = 0 keeps i* in full, b_t = 0 drops t*.
    All-zero rows (i* = -1) stay the sentinel -1."""
    i_star = i_star.to(torch.int64)
    i_part = i_star if b_i == 0 else i_star & ((1 << b_i) - 1)
    sentinel = i_star < 0
    i_part = torch.where(sentinel, -1, i_part)
    if b_t == 0:
        return i_part.to(torch.int32)
    t_part = t_star.to(torch.int64) & ((1 << b_t) - 1)
    code = i_part * (1 << b_t) + t_part
    return torch.where(sentinel, -1, code).to(torch.int32)


def encode_tstar_only(i_star: torch.Tensor, t_star: torch.Tensor, *,
                      b_i: int) -> torch.Tensor:
    """Fig. 6 variant: all of t* and only b_i bits of i* (b_i may be 0),
    combined as ``t* * 2^b_i + (i* & mask)`` wrapped to int32 as the
    reference's int32 arithmetic wraps (computed in int64, then folded to
    two's complement); all-zero rows get the sentinel -(2^30) - 12345."""
    t64 = t_star.to(torch.int64)
    if b_i == 0:
        code = t64
    else:
        i_part = i_star.to(torch.int64) & ((1 << b_i) - 1)
        code = t64 * (1 << b_i) + i_part
    code = ((code + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    return torch.where(i_star < 0, -(2 ** 30) - 12345, code).to(torch.int32)


def collision_estimate(codes_u: torch.Tensor,
                       codes_v: torch.Tensor) -> torch.Tensor:
    """K_hat = (1/k) sum_j 1[code_u_j == code_v_j], batched on (..., k)."""
    return (codes_u == codes_v).to(torch.float32).mean(dim=-1)


def full_collision_estimate(i_u, t_u, i_v, t_v) -> torch.Tensor:
    """The full scheme: a hash collides when both i* and t* agree."""
    eq = (i_u == i_v) & (t_u == t_v)
    return eq.to(torch.float32).mean(dim=-1)


def feature_indices(codes: torch.Tensor, *, b_i: int,
                    b_t: int = 0) -> torch.Tensor:
    """(n, k) int32 global indices into k * 2^{b_i+b_t} features;
    sentinel codes map to bucket 0 of their hash."""
    width = 1 << (b_i + b_t)
    k = codes.shape[-1]
    offs = torch.arange(k, dtype=torch.int64, device=codes.device) * width
    safe = torch.clamp_min(codes.to(torch.int64), 0)
    return (offs + safe).to(torch.int32)


def check_packed_bits(b: int) -> int:
    """Codes per word for a legal packed bit width; raises otherwise."""
    if b not in PACKED_BITS:
        raise ValueError(
            f"packed encoding needs b = b_i + b_t in {PACKED_BITS} "
            f"(codes must tile uint32 words); got b = {b}")
    return 32 // b


def packed_width(k: int, b: int) -> int:
    """uint32 words per row for k b-bit codes (word-aligned rows)."""
    cpw = check_packed_bits(b)
    return -(-k // cpw)


def words_to_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> the same bits as uint32."""
    signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return signed.to(torch.int32).view(torch.uint32)


def uint32_to_words(packed: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 values in [0, 2^32)."""
    return packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def pack_codes(codes: torch.Tensor, *, b: int) -> torch.Tensor:
    """(..., k) int32 codes -> (..., ceil(k*b/32)) uint32 words.  Code j
    lands in word j // (32/b) at bit (j % (32/b)) * b; sentinels pack as
    0 and the pad bits of the last word are zero."""
    cpw = check_packed_bits(b)
    k = codes.shape[-1]
    w = packed_width(k, b)
    safe = torch.clamp_min(codes.to(torch.int64), 0) & ((1 << b) - 1)
    safe = torch.nn.functional.pad(safe, (0, w * cpw - k))
    safe = safe.reshape(codes.shape[:-1] + (w, cpw))
    shifts = torch.arange(cpw, dtype=torch.int64, device=codes.device) * b
    return words_to_uint32((safe << shifts).sum(dim=-1))


def unpack_codes(packed: torch.Tensor, k: int, *, b: int) -> torch.Tensor:
    """Exact inverse of ``pack_codes``: (..., ceil(k*b/32)) uint32 ->
    (..., k) int32 codes in [0, 2^b)."""
    cpw = check_packed_bits(b)
    if packed.shape[-1] != packed_width(k, b):
        raise ValueError(
            f"packed width mismatch: got {packed.shape[-1]} words but "
            f"k = {k} at b = {b} packs into {packed_width(k, b)}")
    col = torch.arange(k, dtype=torch.int64, device=packed.device)
    words = uint32_to_words(packed).index_select(-1, col // cpw)
    shifts = (col % cpw) * b
    return ((words >> shifts) & ((1 << b) - 1)).to(torch.int32)


def hashed_dim(k: int, b_i: int, b_t: int = 0) -> int:
    return k * (1 << (b_i + b_t))


def one_hot_features(codes: torch.Tensor, *, b_i: int,
                     b_t: int = 0) -> torch.Tensor:
    """Dense 0/1 float32 matrix (n, k * 2^{b_i+b_t}): row r holds a 1 at
    each of its k feature indices (sentinel codes at bucket 0 of their
    hash).  For small problems and tests only."""
    idx = feature_indices(codes, b_i=b_i, b_t=b_t).to(torch.int64)
    dim = codes.shape[-1] * (1 << (b_i + b_t))
    out = torch.zeros(codes.shape[:-1] + (dim,), dtype=torch.float32,
                      device=codes.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=out.dtype))
