"""Public encode ops: one call per logical kernel, dispatched by device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version (``repro_torch.kernels.cws_hash``).
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
