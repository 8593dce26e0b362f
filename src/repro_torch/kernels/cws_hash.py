"""The six CWS kernels: CUDA launchers beside their plain versions.

For each TPU kernel of ``repro/kernels/cws_hash.py`` (the four fused
encodes of the serving path and the two raw (i*, t*) hashes of the
estimator path) this module holds

  * the plain PyTorch version, the definition the kernel is held to: the
    chunked ``cws_hash`` / ``cws_hash_regen`` for the raw hashes, and the
    staged composition ``encode -> feature_indices`` (or ``pack_codes``)
    over them for the encodes;
  * the launcher of the hand-written CUDA kernel (``csrc/cws_encode.cu``),
    which checks its inputs, allocates the output with ``torch.empty``,
    launches on the current stream and raises on a launch error;
  * a launch counter in ``LAUNCHES``, bumped once per kernel launch.

``repro_torch.kernels.ops`` chooses between the two by the tensor's
device; a launcher never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.cws import CWSParams, cws_hash, cws_hash_regen
from repro_torch.core.hashing import (check_packed_bits, encode,
                                      feature_indices, pack_codes,
                                      packed_width)
from repro_torch.core.regen import key_words
from repro_torch.kernels.build import cws_encode_library

# Launches per kernel since the last reset_launches(): how a run shows
# that it really went through the kernels.
LAUNCHES = {"cws_encode": 0, "cws_encode_rng": 0, "cws_encode_packed": 0,
            "cws_encode_rng_packed": 0, "cws_hash": 0, "cws_hash_rng": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _launch(name: str, fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def _lib():
    return cws_encode_library().lib


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
                               b_t: int = 0):
    """Regenerated-parameter encode with packed emit (replaces
    ``cws_encode_rng_packed_pallas``)."""
    x = _check_x(x)
    _check_bits(b_i, b_t, packed=True)
    k0, k1 = key_words(key)
    n, d = x.shape
    words = packed_width(num_hashes, b_i + b_t)
    out = torch.empty((n, words), dtype=torch.uint32, device=x.device)
    if n == 0 or num_hashes == 0:
        return out
    return _launch("cws_encode_rng_packed",
                   _lib().cws_encode_rng_packed_launch, out,
                   x.data_ptr(), k0, k1, n, d, num_hashes, b_i, b_t,
                   out.data_ptr(), words)


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
    _launch("cws_hash_rng", _lib().cws_hash_rng_launch, i_star, x.data_ptr(),
            k0, k1, n, d, num_hashes, i_star.data_ptr(), t_star.data_ptr())
    return i_star, t_star
