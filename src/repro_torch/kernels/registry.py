"""Kernel implementations by op, chosen by the input tensor's device
(the ported subset of ``repro.kernels.registry``).

Each op has two implementations: ``cuda``, the hand-written kernel,
for CUDA tensors, and ``reference``, its plain PyTorch version, for CPU
tensors.  The tensor's device alone chooses; there is no fallback from
one to the other.  Also here: the serving bucket ladder.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import cws_hash, flash_attention, minmax_gram

IMPLS: Dict[str, Dict[str, Callable]] = {
    "cws_encode": {"cuda": cws_hash.cws_encode_cuda,
                   "reference": cws_hash.cws_encode_plain},
    "cws_encode_rng": {"cuda": cws_hash.cws_encode_rng_cuda,
                       "reference": cws_hash.cws_encode_rng_plain},
    "cws_encode_packed": {"cuda": cws_hash.cws_encode_packed_cuda,
                          "reference": cws_hash.cws_encode_packed_plain},
    "cws_encode_rng_packed": {
        "cuda": cws_hash.cws_encode_rng_packed_cuda,
        "reference": cws_hash.cws_encode_rng_packed_plain},
    "cws_hash": {"cuda": cws_hash.cws_hash_cuda,
                 "reference": cws_hash.cws_hash_plain},
    "cws_hash_rng": {"cuda": cws_hash.cws_hash_rng_cuda,
                     "reference": cws_hash.cws_hash_rng_plain},
    "min_sum": {"cuda": minmax_gram.min_sum_cuda,
                "reference": minmax_gram.min_sum_plain},
    "minmax_gram": {"cuda": minmax_gram.minmax_gram_cuda,
                    "reference": minmax_gram.minmax_gram_plain},
    "flash_attention": {
        "cuda": flash_attention.flash_attention_fwd_cuda,
        "reference": flash_attention.flash_attention_fwd_plain},
    "flash_attention_step": {
        "cuda": flash_attention.flash_attention_step_cuda,
        "reference": flash_attention.flash_attention_step_plain},
}

_FAMILY_ALIASES = {"cws_encode": "cws", "cws_encode_rng": "cws_rng",
                   "cws_encode_packed": "cws_packed",
                   "cws_encode_rng_packed": "cws_rng_packed",
                   "cws_hash": "cws", "cws_hash_rng": "cws_rng",
                   "minmax_gram": "min_sum", "gram": "min_sum"}


def family(op: str) -> str:
    """Op name -> kernel family name (the reference's aliases)."""
    return _FAMILY_ALIASES.get(op, op)


def auto_impl(device: torch.device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "reference"


def resolve(op: str, device: torch.device):
    """The implementation of ``op`` for tensors on ``device``."""
    table = IMPLS.get(op)
    if table is None:
        raise KeyError(f"no implementations registered for op {op!r}")
    return table[auto_impl(device)]


# Padded request-batch shapes the serving runner warms.
DEFAULT_SERVE_BUCKETS: Tuple[int, ...] = (1, 8, 32, 128, 512)


def serve_buckets(op: str = "cws") -> Tuple[int, ...]:
    """The padded-batch ladder the serving runner uses for ``op``: the
    default ladder for every family (the reference's per-family tables,
    tuned and saved beside the block table, are not ported yet)."""
    return DEFAULT_SERVE_BUCKETS
