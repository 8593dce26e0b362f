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


def get_config(name: str, variant: str = "full"):
    """variant: 'full' (assigned spec) or 'smoke' (reduced, CPU-runnable)."""
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.CONFIG if variant == "full" else mod.SMOKE
    return cfg
