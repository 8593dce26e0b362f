"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1, head_dim=256)
d_ff=7680 vocab=256000; RG-LRU + local attention 1:2 (Griffin).
[arXiv:2402.19427; hf]

26 layers with every third block a local-attention block (8 attn / 18
rglru). Expressed as a 13-block repeating pattern x 2 scan units so the
exact assigned 26L is preserved under the stacked-unit scan layout.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

_PATTERN = ("rglru", "rglru", "local") * 4 + ("rglru",)

CONFIG = ModelConfig(
    name="recurrentgemma_2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, activation="geglu",
    block_pattern=_PATTERN,
    window=2048, rnn_width=2560, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma_smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=1, head_dim=16, d_ff=128, vocab=512, window=32,
    block_pattern=("rglru", "local"),
    rnn_width=64, dtype="float32", attn_chunk=64, loss_chunk=64)
