"""Counter-based regeneration of CWS parameters (port of ``repro.core.regen``).

One deterministic function

    (key words, d, hash)  ->  (r[d, hash], log_c[d, hash], beta[d, hash])

shared by the CUDA kernels (``csrc/cws_common.cuh``) and the plain PyTorch
path here.  Threefry-2x32 (20 rounds) keyed by the two key words, with one
key word XOR-tweaked per stream, and the GLOBAL (d, hash) coordinates as
the counter, so any tiling of the (D, k) grid gives the same parameters.
Uniforms are the top 24 bits of a word; Exp(1) = -log1p(-u);
Gamma(2, 1) = Exp(1) + Exp(1).

The same function also reproduces the reference's key arithmetic
(``jax.random`` on threefry keys, ``jax_threefry_partitionable`` on):
``prng_key``, ``fold_in``, ``split``, ``random_bits32`` and
``permutation`` give the reference's words bit for bit, so the port walks
the reference's epoch shuffles from the same key words.

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


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds).  Keys are Python ints in [0, 2^32),
    counters int64 tensors holding uint32 values (or Python ints);
    returns two int64 tensors (or ints) of uint32 words."""
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


# -- the reference's key arithmetic --------------------------------------
# A key is two uint32 words (numpy ``uint32[2]``, what ``key_words`` reads).
# Counters are (hi, lo) word pairs of a 64-bit index, hence the zero high
# words below.

def _key_array(w0: int, w1: int) -> np.ndarray:
    return np.array([w0 & _MASK, w1 & _MASK], np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & mask)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2^64); got {seed}")
    return _key_array(seed >> 32, seed)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry of the counter
    (0, data)."""
    return _key_array(*threefry2x32(*key_words(key), 0, int(data) & _MASK))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) words, key j from the
    counter (0, j)."""
    k0, k1 = key_words(key)
    return np.array([threefry2x32(k0, k1, 0, j) for j in range(num)],
                    np.uint32).reshape(num, 2)


def random_bits32(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as an int64 CPU tensor of
    uint32 values: x0 ^ x1 of threefry at the counter (i >> 32,
    i & mask)."""
    i = torch.arange(n, dtype=torch.int64)
    x0, x1 = threefry2x32(*key_words(key), i >> 32, i & _MASK)
    return x0 ^ x1


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 CPU tensor: rounds
    of a stable sort of the positions by fresh 32-bit keys (compared as
    unsigned values, which int64 holds), one split of the key a round,
    with the reference's round count (computed in float64 as it does).
    A trainer computes it on the host and moves it to its rows' device:
    a few hundred small operations, which would be as many kernel
    launches on a card."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(random_bits32(sub, n), stable=True).indices]
    return x
