"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8, head_dim=256)
d_ff=15360, vocab=262144, 5 local (window 1024) : 1 global pattern,
GeGLU, 128k+ context. [hf:google/gemma-3-*; unverified]
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144, activation="geglu",
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, rope_theta=1e4, rope_theta_global=1e6,
    qk_norm=True, logit_softcap=0.0, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3_smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, window=32,
    dtype="float32", attn_chunk=64, loss_chunk=64)
