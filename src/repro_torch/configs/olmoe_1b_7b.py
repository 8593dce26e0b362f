"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024,
vocab=50304, MoE 64 experts top-8 on every layer. [arXiv:2409.02060; hf]
"""
import dataclasses
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="olmoe_1b_7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, activation="swiglu",
    moe=MoECfg(num_experts=64, top_k=8, d_ff_expert=1024, every=1),
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="olmoe_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=32, vocab=512, dtype="float32",
    moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=32, every=1),
    attn_chunk=64, loss_chunk=64)
