"""Consistent Weighted Sampling in PyTorch (port of ``repro.core.cws``).

For a nonnegative vector u and one hash j with draws r, c ~ Gamma(2, 1)
and beta ~ U(0, 1) per (dimension, hash), in log space:

    t_i     = floor(log u_i / r_i + beta_i)
    log a_i = log c_i - r_i (t_i - beta_i + 1)
    i*      = argmin_i log a_i (first minimum)       t* = t_{i*}

Zero entries are masked to +inf; an all-zero row gives i* = -1, t* = 0.
These are the plain versions the CUDA kernels are held against: every
operation is a separate IEEE fp32 step in the reference's order (no fused
multiply-add), so on the card they agree with the kernels bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Elements of one (rows, D, hashes) float temporary in the chunked paths:
# 2^25 fp32 is 128 MiB, and a chunk holds a handful of such temporaries,
# so peak memory stays under about 1 GiB at any D.
_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class CWSParams:
    """The shared random matrices, each of shape (D, k) float32."""

    r: torch.Tensor       # Gamma(2,1)
    log_c: torch.Tensor   # log of Gamma(2,1)
    beta: torch.Tensor    # Uniform(0,1)

    @property
    def dim(self) -> int:
        return self.r.shape[0]

    @property
    def num_hashes(self) -> int:
        return self.r.shape[1]

    @property
    def device(self) -> torch.device:
        return self.r.device

    def slice_hashes(self, start: int, size: int) -> "CWSParams":
        sl = lambda m: m[:, start:start + size].contiguous()
        return CWSParams(sl(self.r), sl(self.log_c), sl(self.beta))


def make_cws_params(generator: torch.Generator, dim: int,
                    num_hashes: int) -> CWSParams:
    """Fresh parameters on the generator's device, with the reference's
    distributions (Gamma(2,1) = Exp(1) + Exp(1); U[0,1)).  Not the same
    draws as ``repro``: parity tests hand parameters over as arrays."""
    shape = (dim, num_hashes)
    dev = generator.device

    def exp1():
        return torch.empty(shape, device=dev).exponential_(
            generator=generator)

    r = exp1() + exp1()
    c = exp1() + exp1()
    beta = torch.rand(shape, generator=generator, device=dev)
    return CWSParams(r, torch.log(c), beta)


def make_cws_params_jax(key, dim: int, num_hashes: int) -> CWSParams:
    """``repro.core.cws.make_cws_params(key, dim, num_hashes)``'s draws,
    float32 on the CPU: r and c Gamma(2,1) as the sum of two
    ``jax.random.exponential`` draws from the halves of their keys, beta
    ``jax.random.uniform``.  ``key`` is two key words (``prng_key``).
    beta is the reference's bits; r and log c differ from them by a few
    float32 roundings (PyTorch's log1p and log against XLA's), far below
    the gaps between CWS candidates."""
    from repro_torch.core import regen as R
    kr, kc, kb = R.split(key, 3)
    shape = (dim, num_hashes)

    def gamma21(k):
        k1, k2 = R.split(k)
        return R.exponential(k1, shape) + R.exponential(k2, shape)

    return CWSParams(gamma21(kr), torch.log(gamma21(kc)),
                     R.uniform(kb, shape))


def log_u(x: torch.Tensor) -> torch.Tensor:
    """log of the positive entries, -inf elsewhere (zeros never win)."""
    x = x.to(torch.float32)
    return torch.where(x > 0, torch.log(torch.clamp_min(x, np.float32(1e-38))),
                       -math.inf)


def _cws_block(logu: torch.Tensor, r: torch.Tensor, log_c: torch.Tensor,
               beta: torch.Tensor):
    """logu (n, D) with -inf at zeros; params (D, kb) -> (i*, t*) int32."""
    lu = logu[:, :, None]                                  # (n, D, 1)
    t = torch.floor(lu / r + beta)                         # (n, D, kb)
    log_a = log_c - r * (t - beta + 1.0)
    log_a = torch.where(torch.isfinite(lu), log_a, math.inf)
    del lu
    i_star = torch.argmin(log_a, dim=1)                    # (n, kb)
    del log_a
    t_star = torch.gather(t, 1, i_star[:, None, :])[:, 0, :]
    t_star = torch.clamp(t_star, -2.0 ** 30, 2.0 ** 30).to(torch.int32)
    all_zero = ~torch.isfinite(logu).any(dim=1, keepdim=True)
    i_star = torch.where(all_zero, -1, i_star).to(torch.int32)
    t_star = torch.where(all_zero, 0, t_star).to(torch.int32)
    return i_star, t_star


def cws_hash_reference(x: torch.Tensor, params: CWSParams):
    """Unchunked oracle: x (n, D) nonneg -> (i*, t*) each (n, k) int32."""
    return _cws_block(log_u(x), params.r, params.log_c, params.beta)


def chunk_sizes(n: int, d: int, k: int, hash_block: int = 128):
    """(row_block, hash_block) keeping one (rows, D, hashes) temporary at
    or under ``_CHUNK_ELEMS`` elements."""
    hb = max(1, min(hash_block, k, _CHUNK_ELEMS // max(d, 1)))
    rb = max(1, min(n, _CHUNK_ELEMS // max(d * hb, 1)))
    return rb, hb


def _chunked(logu: torch.Tensor, k: int, params_for, hash_block: int,
             row_block: int | None):
    n, d = logu.shape
    rb, hb = chunk_sizes(n, d, k, hash_block)
    if row_block is not None:
        rb = max(1, min(rb, row_block))
    i_star = torch.empty((n, k), dtype=torch.int32, device=logu.device)
    t_star = torch.empty_like(i_star)
    for h0 in range(0, k, hb):
        h1 = min(h0 + hb, k)
        r, log_c, beta = params_for(h0, h1)
        for r0 in range(0, n, rb):
            i_s, t_s = _cws_block(logu[r0:r0 + rb], r, log_c, beta)
            i_star[r0:r0 + rb, h0:h1] = i_s
            t_star[r0:r0 + rb, h0:h1] = t_s
    return i_star, t_star


def cws_hash(x: torch.Tensor, params: CWSParams, *, row_block=None,
             hash_block: int = 128):
    """Chunked CWS over rows and hashes with bounded peak memory:
    x (n, D) nonneg -> (i*, t*) each (n, k) int32."""
    k = params.num_hashes

    def params_for(h0, h1):
        return (params.r[:, h0:h1], params.log_c[:, h0:h1],
                params.beta[:, h0:h1])

    return _chunked(log_u(x), k, params_for, hash_block, row_block)


def cws_hash_regen(x: torch.Tensor, key, num_hashes: int, *,
                   row_block=None, hash_block: int = 128):
    """CWS with (r, log_c, beta) regenerated per hash block from the
    counter spec in ``repro_torch.core.regen``; independent of the block
    sizes, and bit-identical to the regen kernels' parameters."""
    from repro_torch.core.regen import key_words, regen_tile
    k0, k1 = key_words(key)
    d = x.shape[1]

    def params_for(h0, h1):
        return regen_tile(k0, k1, 0, h0, d, h1 - h0, device=x.device)

    return _chunked(log_u(x), num_hashes, params_for, hash_block, row_block)
