"""mamba2-780m [ssm]: 48L d_model=1536, attention-free SSD blocks,
d_state=128, expand=2, head_dim=64, vocab=50280 (padded to 50432).
[arXiv:2405.21060; unverified]
"""
import dataclasses
from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2_780m",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, activation="swiglu",
    block_pattern=("ssm",),
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2_smoke", n_layers=2, d_model=64, vocab=512,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    dtype="float32", loss_chunk=64)
