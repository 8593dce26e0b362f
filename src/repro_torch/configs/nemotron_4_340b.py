"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8, head_dim=192)
d_ff=73728, vocab=256000, squared-ReLU MLP. [arXiv:2402.16819; unverified]

bf16 master weights, moments and gradient accumulation, as the reference
configures it (DESIGN.md §5).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron_4_340b",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, activation="sq_relu",
    param_dtype="bfloat16",   # bf16 master + stochastic rounding (DESIGN.md §5)
    moment_dtype="bfloat16", grad_accum_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, name="nemotron_smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, head_dim=16, d_ff=384, vocab=512, dtype="float32",
    attn_chunk=64, loss_chunk=64)
