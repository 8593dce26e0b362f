"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, GELU MLP (gpt_bigcode-style code model). [arXiv:2405.04324; hf]
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite_34b",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, activation="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=1, head_dim=16, d_ff=128, vocab=512, dtype="float32",
    attn_chunk=64, loss_chunk=64)
