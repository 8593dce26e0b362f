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

import math
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
    """``jax.random.PRNGKey(seed)`` as the reference runs it (64-bit
    types off): the seed is an int64, of which the key keeps the low 32
    bits, so the words are (0, seed mod 2^32); a negative seed is taken
    in two's complement (-1 gives (0, 2^32 - 1)).  A seed outside int64
    raises ``OverflowError``, as the reference does."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return _key_array(0, seed)


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


# -- the reference's samplers ----------------------------------------------
# ``jax.random``'s float32 samplers on these bits, each a float32 CPU tensor
# (the reference's datasets are numpy arrays made on the host).  uniform,
# bernoulli and randint are integer arithmetic and exact IEEE steps, so
# they equal the reference bit for bit; exponential and normal go through
# log1p (and erfinv's polynomial), where PyTorch's CPU math and XLA's
# differ in the last bits on a few per cent of draws.

def _size(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(map(int, shape))


def _bits(key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: the row-major index of each
    element is its counter."""
    shape = _size(shape)
    return random_bits32(key, int(np.prod(shape))).reshape(shape)


def _uniform_of(bits: torch.Tensor, minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
    """uint32 words (int64) -> ``jax.random.uniform``'s float32 values."""
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    lo_t = torch.tensor(lo)
    return torch.maximum(u * float(hi - lo) + lo_t, lo_t)


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, then
    ``u * (maxval - minval) + minval`` in float32, floored at minval."""
    return _uniform_of(_bits(key, shape), minval, maxval)


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a bool
    tensor, uniform < p in float32."""
    return uniform(key, shape) < torch.tensor(np.float32(p))


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32: two
    32-bit draws from the two halves of a split key, combined modulo the
    span in uint32 arithmetic (``2^32 mod span`` as ``(2^16 mod span)^2
    mod span``)."""
    lo, hi = int(minval), int(maxval)
    if not (-2 ** 31 <= lo and hi <= 2 ** 31 - 1):
        raise ValueError(f"randint bounds [{lo}, {hi}) must fit in int32")
    shape = _size(shape)
    k_hi, k_lo = split(key)
    span = (hi - lo) & _MASK if hi > lo else 1
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span     # uint32 product
    off = ((_bits(k_hi, shape) % span) * mult + _bits(k_lo, shape) % span)
    off = (off & _MASK) % span
    return (lo + off).to(torch.int32)


def exponential(key, shape) -> torch.Tensor:
    """``jax.random.exponential(key, shape)``: -log1p(-u)."""
    return -torch.log1p(-uniform(key, shape))


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function",
# GPU Computing Gems, 2010): a degree-8 polynomial in w - 2.5 where
# w = -log1p(-x^2) < 5, else in sqrt(w) - 3, times x.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, step by step in its order (float32
    tensors; ``torch.special.erfinv`` is another approximation)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(np.float32(a)),
                        torch.tensor(np.float32(b)))
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)``: sqrt(2) erfinv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    return _SQRT2 * erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


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


# -- Gamma and Dirichlet (jax.random.gamma / loggamma / dirichlet) ---------
# jax's sampler draws one key a element (``split(key, a.size)``, row-major)
# and runs Marsaglia and Tsang's rejection loop on each element with its
# own key (``jax._src.random._gamma_one``).  Here the loop runs on every
# element at once, a mask holding the elements still looping, so each
# element takes its own trips on its own key stream.  The float32
# arithmetic follows ``_gamma_one`` operation by operation.  The
# reference's CPU backend flushes subnormal results to zero, which decides
# which small draws come out as exact zeros, so ``flush_subnormal`` flushes
# every result that can fall below the smallest normal float32.

_TINY = float(np.finfo(np.float32).tiny)
_THIRD = np.float32(1.0 / 3.0)
_SQUEEZE = np.float32(0.0331)


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero (the reference backend's mode)."""
    return torch.where(t.abs() < _TINY, torch.zeros_like(t), t)


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """float32 ``num / t`` as a true division (a Python number over a
    tensor is a reciprocal times the number in PyTorch)."""
    return torch.div(torch.full_like(t, num), t)


def _split_each(k0: torch.Tensor, k1: torch.Tensor, num: int):
    """``split(key, num)`` of every key of a batch: num (k0, k1) pairs."""
    return [threefry2x32(k0, k1, 0, j) for j in range(num)]


def _bits_each(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``bits(key, (), uint32)`` of every key of a batch."""
    x0, x1 = threefry2x32(k0, k1, 0, 0)
    return x0 ^ x1


def _gamma_each(k0: torch.Tensor, k1: torch.Tensor, alpha: torch.Tensor,
                log_space: bool) -> torch.Tensor:
    """``_gamma_one`` on every (key, alpha) of a batch, float32."""
    boost_mask = alpha >= 1.0
    alpha_orig = alpha
    alpha = torch.where(boost_mask, alpha, alpha + 1.0)
    d = alpha - float(_THIRD)
    c = _div(float(_THIRD), torch.sqrt(d))
    (k0, k1), (s0, s1) = _split_each(k0, k1, 2)
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)

    def looping(X, V, U, d):
        return ((U >= 1.0 - float(_SQUEEZE) * (X * X))
                & (torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V))))

    live = torch.arange(alpha.numel())
    while live.numel():
        # the outer body on the elements still looping
        (k0l, k1l), (x0, x1), (u0, u1) = _split_each(k0[live], k1[live], 3)
        cl = c[live]
        x = torch.zeros_like(cl)
        v = torch.full_like(cl, -1.0)
        inner = torch.arange(live.numel())
        while inner.numel():
            (x0i, x1i), (g0, g1) = _split_each(x0[inner], x1[inner], 2)
            x0[inner], x1[inner] = x0i, x1i
            xi = _SQRT2 * erfinv(_uniform_of(_bits_each(g0, g1),
                                             _NORMAL_LO, 1.0))
            x[inner] = xi
            v[inner] = 1.0 + xi * cl[inner]
            inner = inner[v[inner] <= 0.0]
        k0[live], k1[live] = k0l, k1l
        X[live] = x * x
        V[live] = flush_subnormal(v * v * v)
        U[live] = _uniform_of(_bits_each(u0, u1))
        live = live[looping(X[live], V[live], U[live], d[live])]
    if log_space:
        log_samples = torch.log1p(-_uniform_of(_bits_each(s0, s1)))
        log_boost = torch.where(boost_mask | (log_samples == 0.0),
                                torch.zeros_like(alpha),
                                log_samples * _div(1.0, alpha_orig))
        return torch.log(d) + torch.log(V) + log_boost
    samples = 1.0 - _uniform_of(_bits_each(s0, s1))
    boost = torch.where(boost_mask, torch.ones_like(alpha),
                        flush_subnormal(torch.pow(samples,
                                                  _div(1.0, alpha_orig))))
    return flush_subnormal(flush_subnormal(d * V) * boost)


def _gamma(key, a, shape, log_space: bool) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(a, np.float32) if not
                        isinstance(a, torch.Tensor) else a,
                        dtype=torch.float32).cpu()
    if shape is not None:
        a = a.broadcast_to(_size(shape))
    flat = a.reshape(-1).contiguous()
    i = torch.arange(flat.numel(), dtype=torch.int64)
    k0, k1 = threefry2x32(*key_words(key), i >> 32, i & _MASK)
    return _gamma_each(k0, k1, flat, log_space).reshape(a.shape)


def gamma(key, a, shape=None) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)``: Gamma(a, 1) float32 draws, one
    key an element."""
    return _gamma(key, a, shape, log_space=False)


def loggamma(key, a, shape=None) -> torch.Tensor:
    """``jax.random.loggamma(key, a, shape)``: the log of the Gamma draws,
    the boost for a < 1 taken in log space."""
    return _gamma(key, a, shape, log_space=True)


def dirichlet(key, alpha, shape=None) -> torch.Tensor:
    """``jax.random.dirichlet(key, alpha, shape)``: ``loggamma`` at shape
    ``shape + alpha.shape[-1:]``, then softmax over the last axis (the max
    subtracted, exp, divided by the sum)."""
    alpha = torch.as_tensor(np.asarray(alpha, np.float32) if not
                            isinstance(alpha, torch.Tensor) else alpha,
                            dtype=torch.float32)
    if alpha.dim() < 1:
        raise ValueError(f"dirichlet requires alpha.ndim >= 1, got "
                         f"alpha.ndim == {alpha.dim()}")
    shape = tuple(alpha.shape[:-1]) if shape is None else _size(shape)
    logs = loggamma(key, alpha, shape + tuple(alpha.shape[-1:]))
    e = flush_subnormal(torch.exp(logs - logs.amax(dim=-1, keepdim=True)))
    return flush_subnormal(e / e.sum(dim=-1, keepdim=True))
