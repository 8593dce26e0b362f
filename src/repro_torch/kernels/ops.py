"""Public kernel ops: one call per logical kernel, dispatched by device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version (``repro_torch.kernels.cws_hash``, ``repro_torch.kernels.
minmax_gram``, ``repro_torch.kernels.flash_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.core.cws import CWSParams
from repro_torch.kernels import registry


def cws_encode(x: torch.Tensor, params: CWSParams, *, b_i: int,
               b_t: int = 0) -> torch.Tensor:
    """x (n, D) nonneg -> (n, k) int32 indices into k * 2^{b_i+b_t}."""
    fn = registry.resolve("cws_encode", x.device)
    return fn(x, params, b_i=b_i, b_t=b_t)


def cws_encode_rng(x: torch.Tensor, key, num_hashes: int, *, b_i: int,
                   b_t: int = 0) -> torch.Tensor:
    """As ``cws_encode`` with parameters regenerated from two key words."""
    fn = registry.resolve("cws_encode_rng", x.device)
    return fn(x, key, num_hashes, b_i=b_i, b_t=b_t)


def cws_encode_packed(x: torch.Tensor, params: CWSParams, *, b_i: int,
                      b_t: int = 0) -> torch.Tensor:
    """x (n, D) nonneg -> (n, ceil(k*b/32)) uint32, b = b_i + b_t."""
    fn = registry.resolve("cws_encode_packed", x.device)
    return fn(x, params, b_i=b_i, b_t=b_t)


def cws_encode_rng_packed(x: torch.Tensor, key, num_hashes: int, *,
                          b_i: int, b_t: int = 0) -> torch.Tensor:
    fn = registry.resolve("cws_encode_rng_packed", x.device)
    return fn(x, key, num_hashes, b_i=b_i, b_t=b_t)


def cws_hash(x: torch.Tensor, params: CWSParams):
    """x (n, D) nonneg -> (i*, t*) each (n, k) int32."""
    return registry.resolve("cws_hash", x.device)(x, params)


def cws_hash_rng(x: torch.Tensor, key, num_hashes: int):
    """As ``cws_hash`` with parameters regenerated from two key words."""
    return registry.resolve("cws_hash_rng", x.device)(x, key, num_hashes)


def min_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (m, D), y (n, D) -> (m, n) float32 sum_d min(x, y)."""
    return registry.resolve("min_sum", x.device)(x, y)


def minmax_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Min-max Gram (m, n) of the nonnegative parts of x and y."""
    return registry.resolve("minmax_gram", x.device)(x, y)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, q_base: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, G, D) -> (B, Sq, H, D) causal (and,
    with ``window > 0``, sliding-window) attention, rows at global
    positions ``q_base + i``."""
    return registry.resolve("flash_attention", q.device)(
        q, k, v, window=window, q_base=q_base)
