"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, head_dim=64)
d_ff=8192 vocab=2048, decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]. EnCodec frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings; labels are codebook
token ids.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, activation="gelu", input_mode="embeddings",
)

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=128, dtype="float32",
    attn_chunk=64, loss_chunk=64)
