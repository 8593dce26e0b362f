"""Counter-based regeneration of CWS parameters (port of ``repro.core.regen``).

One deterministic function

    (key words, d, hash)  ->  (r[d, hash], log_c[d, hash], beta[d, hash])

shared by the CUDA kernels (``csrc/cws_common.cuh``) and the plain PyTorch
path here.  Threefry-2x32 (20 rounds) keyed by the two key words, with one
key word XOR-tweaked per stream, and the GLOBAL (d, hash) coordinates as
the counter, so any tiling of the (D, k) grid gives the same parameters.
Uniforms are the top 24 bits of a word; Exp(1) = -log1p(-u);
Gamma(2, 1) = Exp(1) + Exp(1).

The words are the same bits as the JAX reference.  The plain path computes
them in int64 masked to 32 bits, because uint32 ``+``, ``<<``, ``>>`` and
``<`` are not implemented for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Key tweaks per parameter stream; fixed forever (they define the hashes).
STREAM_R = 0x243F6A89
STREAM_C = 0x85A308D3
STREAM_BETA = 0x13198A2F

_THREEFRY_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK = 0xFFFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds).  Keys are Python ints in [0, 2^32),
    counters int64 tensors holding uint32 values; returns two int64
    tensors of uint32 words."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _THREEFRY_PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> fp32 uniform in [0, 1) (exact: 24-bit mantissa)."""
    return (bits >> 8).to(torch.float32) * np.float32(2.0 ** -24)


def _exp1(u: torch.Tensor) -> torch.Tensor:
    return -torch.log1p(-u)


def key_words(key) -> Tuple[int, int]:
    """Two uint32 key words as Python ints, from a numpy ``uint32[2]``,
    a 2-element tensor, or a pair of ints."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    words = np.asarray(key).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"key words are two uint32 values; got shape "
                         f"{np.asarray(key).shape}")
    return int(words[0]) & _MASK, int(words[1]) & _MASK


def regen_tile(k0: int, k1: int, d0: int, kh0: int, bd: int, bk: int, *,
               device=None):
    """(r, log_c, beta) fp32 tiles of shape (bd, bk) for the global window
    [d0, d0+bd) x [kh0, kh0+bk)."""
    d = (d0 + torch.arange(bd, dtype=torch.int64, device=device))[:, None]
    kh = (kh0 + torch.arange(bk, dtype=torch.int64, device=device))[None, :]
    d, kh = torch.broadcast_tensors(d & _MASK, kh & _MASK)

    u0, u1 = threefry2x32(k0, k1 ^ STREAM_R, d, kh)
    r = _exp1(_uniform(u0)) + _exp1(_uniform(u1))          # Gamma(2,1)
    r = torch.clamp_min(r, np.float32(1e-12))              # div-safe

    u0, u1 = threefry2x32(k0, k1 ^ STREAM_C, d, kh)
    c = _exp1(_uniform(u0)) + _exp1(_uniform(u1))          # Gamma(2,1)
    log_c = torch.log(torch.clamp_min(c, np.float32(1e-38)))

    u0, _ = threefry2x32(k0, k1 ^ STREAM_BETA, d, kh)
    beta = _uniform(u0)                                    # U[0,1)
    return r, log_c, beta


def regen_params(key, dim: int, num_hashes: int, *, device=None):
    """The full (dim, num_hashes) parameter matrices of the counter stream
    as ``CWSParams``: what the regen kernels derive tile by tile."""
    from repro_torch.core.cws import CWSParams
    k0, k1 = key_words(key)
    return CWSParams(*regen_tile(k0, k1, 0, 0, dim, num_hashes,
                                 device=device))
