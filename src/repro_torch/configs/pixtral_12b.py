"""pixtral-12b [vlm]: Pixtral-ViT frontend (stub) + Mistral-Nemo-style decoder.

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]. The vision frontend is a STUB
per the assignment: input_specs() provides precomputed patch embeddings.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral_12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, activation="swiglu",
    rope_theta=1e6, input_mode="embeddings",
)

SMOKE = dataclasses.replace(
    CONFIG, name="pixtral_12b_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32",
    attn_chunk=64, loss_chunk=64)
