"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, GELU, RoPE. [arXiv:2402.19173; hf]
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152, activation="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="starcoder2_smoke", n_layers=2, d_model=64, n_heads=6,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32",
    attn_chunk=64, loss_chunk=64)
