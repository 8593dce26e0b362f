"""Embedding-bag linear scoring (serving subset of ``repro.core.linear_model``).

A hashed example is k one-hot indices into a flat (F, C) table, so its
logits are ``sum_j W[idx_j] + b``: a gather and a sum, which is plain
PyTorch (the reference leaves it to XLA, not to a Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import (check_packed_bits, packed_width,
                                      unpack_codes)


class LinearParams(NamedTuple):
    w: torch.Tensor  # (F, C) float32
    b: torch.Tensor  # (C,) float32


def init_bag(num_features: int, n_classes: int, *,
             device=None) -> LinearParams:
    """Zero flat embedding-bag table (F, C) and bias (C,)."""
    return LinearParams(
        torch.zeros((num_features, n_classes), dtype=torch.float32,
                    device=device),
        torch.zeros((n_classes,), dtype=torch.float32, device=device))


def _gather_sum(params: LinearParams, idx: torch.Tensor) -> torch.Tensor:
    n, k = idx.shape
    num_features, n_classes = params.w.shape
    # the [0, F-1] clamp guards a features/table mismatch, as the
    # reference's clipped take does; validate_bag_features makes it loud
    flat = idx.to(torch.int64).clamp(0, num_features - 1).reshape(-1)
    rows = params.w.index_select(0, flat).view(n, k, n_classes)
    return rows.sum(dim=1) + params.b


def bag_logits(params: LinearParams, idx: torch.Tensor) -> torch.Tensor:
    """idx (n, k) int32 global feature indices in [0, F) -> (n, C)."""
    if idx.ndim != 2:
        raise ValueError(f"bag indices must be (n, k); got {tuple(idx.shape)}")
    if params.w.ndim != 2:
        raise ValueError("bag params must be a flat (F, C) table "
                         f"(init_bag); got w {tuple(params.w.shape)}")
    return _gather_sum(params, idx)


def check_bag_table_size(num_hashes: int, b: int) -> int:
    """Row count ``num_hashes * 2^b`` of a packed bag table; raises when
    the top index would not fit int32 (the index type the kernels emit)."""
    check_packed_bits(b)
    num_features = num_hashes * (1 << b)
    if num_features > 2 ** 31:
        raise ValueError(
            f"packed bag table overflow: {num_hashes} hashes at b = {b} "
            f"index {num_features} features, but the top index "
            f"{num_features - 1} exceeds int32 max ({2 ** 31 - 1}); keep "
            f"num_hashes * 2^b <= 2^31 (at b = {b}: num_hashes <= "
            f"{2 ** 31 >> b})")
    return num_features


def bag_logits_packed(params: LinearParams, packed: torch.Tensor, *,
                      num_hashes: int, b: int) -> torch.Tensor:
    """Logits straight from bit-packed features (n, ceil(k*b/32)) uint32:
    unpack, add the per-hash offsets ``j * 2^b`` and gather as
    ``bag_logits`` does."""
    if packed.ndim != 2:
        raise ValueError(f"packed features must be (n, words); "
                         f"got {tuple(packed.shape)}")
    if packed.dtype != torch.uint32:
        raise ValueError(f"packed features must be uint32 words; "
                         f"got {packed.dtype}")
    if packed.shape[-1] != packed_width(num_hashes, b):
        raise ValueError(
            f"packed width mismatch: got {packed.shape[-1]} words but "
            f"{num_hashes} hashes at b = {b} pack into "
            f"{packed_width(num_hashes, b)}")
    if params.w.ndim != 2:
        raise ValueError("bag params must be a flat (F, C) table "
                         f"(init_bag); got w {tuple(params.w.shape)}")
    num_features = params.w.shape[0]
    if num_features != check_bag_table_size(num_hashes, b):
        raise ValueError(
            f"feature-table mismatch: table has {num_features} rows but "
            f"{num_hashes} hashes at b = {b} index {num_hashes * (1 << b)} "
            f"features; build with init_bag_packed(num_hashes, b, C)")
    codes = unpack_codes(packed, num_hashes, b=b).to(torch.int64)
    offs = torch.arange(num_hashes, dtype=torch.int64,
                        device=packed.device) * (1 << b)
    return _gather_sum(params, offs + codes)


def init_bag_packed(num_hashes: int, b: int, n_classes: int, *,
                    device=None) -> LinearParams:
    """Zero table sized for packed b-bit features: (num_hashes * 2^b, C)."""
    return init_bag(check_bag_table_size(num_hashes, b), n_classes,
                    device=device)


def validate_bag_features(params: LinearParams, num_features: int, *,
                          spec=None) -> None:
    """Raise when a (F, C) table does not match the feature space: a
    mismatched table would make every gather clamp silently.  A packed
    ``spec`` pins F to ``num_hashes * 2^bits``."""
    if params.w.ndim != 2:
        raise ValueError("bag params must be a flat (F, C) table "
                         f"(init_bag); got w {tuple(params.w.shape)}")
    if spec is not None and getattr(spec, "packed", False):
        expected = spec.num_hashes * (1 << spec.bits)
        if params.w.shape[0] != expected:
            raise ValueError(
                f"feature-table mismatch: table has {params.w.shape[0]} "
                f"rows but the packed pipeline ({spec.num_hashes} hashes "
                f"at b = {spec.bits}) indexes {expected} features; build "
                f"with init_bag_packed(num_hashes, b, n_classes)")
        return
    if params.w.shape[0] != num_features:
        raise ValueError(
            f"feature-table mismatch: table has {params.w.shape[0]} rows "
            f"but the pipeline emits indices into {num_features} features; "
            f"build with init_bag(pipe.num_features, n_classes)")
