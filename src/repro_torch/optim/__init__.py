"""Optimizers (port of ``repro.optim``: the gradient transforms, the LM
trainer's fused AdamW and the int8 gradient compression)."""
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
    fused_adamw_apply,
    global_norm,
)
from repro_torch.optim.compression import (error_feedback_compress,
                                           init_residual,
                                           int8_compress_decompress)

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
    "fused_adamw_apply",
    "global_norm",
    "error_feedback_compress",
    "init_residual",
    "int8_compress_decompress",
]
