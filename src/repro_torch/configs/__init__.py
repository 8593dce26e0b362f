"""Architecture registry: full assigned configs + reduced smoke variants.

Data copied from the reference's ``repro.configs``; the port builds the
dense attention models among them (``repro_torch.models``).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "pixtral_12b",
    "llama4_maverick_400b_a17b",
    "olmoe_1b_7b",
    "granite_34b",
    "nemotron_4_340b",
    "starcoder2_7b",
    "gemma3_12b",
    "mamba2_780m",
    "recurrentgemma_2b",
    "musicgen_large",
]

# shape grid (assignment): name -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling (DESIGN.md §4)
LONG_CONTEXT_ARCHS = {"gemma3_12b", "mamba2_780m", "recurrentgemma_2b"}


def get_config(name: str, variant: str = "full"):
    """variant: 'full' (assigned spec) or 'smoke' (reduced, CPU-runnable)."""
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.CONFIG if variant == "full" else mod.SMOKE
    return cfg


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells per the assignment."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                if include_skipped:
                    out.append((arch, shape, "SKIP"))
                continue
            out.append((arch, shape))
    return out
