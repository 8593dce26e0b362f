"""Optimizers (port of ``repro.optim``: the gradient transforms; the LM
tier's fused AdamW and gradient compression wait for ROADMAP A12)."""
from repro_torch.optim.optimizers import (
    AdamState,
    Transform,
    adamw,
    sgd,
    clip_by_global_norm,
    chain,
    apply_updates,
    cosine_schedule,
    linear_warmup_cosine,
    constant_schedule,
    tree_leaves,
    tree_map,
)

__all__ = [
    "AdamState",
    "Transform",
    "adamw",
    "sgd",
    "clip_by_global_norm",
    "chain",
    "apply_updates",
    "cosine_schedule",
    "linear_warmup_cosine",
    "constant_schedule",
    "tree_leaves",
    "tree_map",
]
