"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128 experts top-1, interleaved every 2 layers
with a shared expert (early-fusion multimodal backbone, text path here).
[hf:meta-llama/Llama-4-*; unverified]
"""
import dataclasses
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, activation="swiglu",
    block_pattern=("attn", "attn"),
    moe=MoECfg(num_experts=128, top_k=1, d_ff_expert=8192, every=2,
               shared_expert=True),
    rope_theta=5e5, qk_norm=True,
    param_dtype="bfloat16",   # bf16 master + stochastic rounding (DESIGN.md §5)
    moment_dtype="bfloat16", grad_accum_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4_maverick_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32",
    moe=MoECfg(num_experts=8, top_k=1, d_ff_expert=128, every=2,
               shared_expert=True),
    attn_chunk=64, loss_chunk=64)
