"""Model/architecture configuration for the assigned architecture pool.

A copy of ``repro.models.config`` with every field and derived property;
``compute_dtype`` and ``master_dtype`` return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1            # MoE on every `every`-th block (1 = all)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    activation: str = "swiglu"             # swiglu | geglu | gelu | sq_relu
    # repeating block pattern; len must divide n_layers.
    #   "attn" full attention | "local" sliding window | "ssm" | "rglru"
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                        # sliding window for "local"
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0         # 0 -> use rope_theta
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rnn_width: int = 0                     # RG-LRU recurrence width (0 -> d_model)
    input_mode: str = "tokens"             # tokens | embeddings (vlm/audio stub)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    qk_norm: bool = False
    logit_softcap: float = 0.0

    # -- numerics / memory policy ------------------------------------------
    dtype: str = "bfloat16"                # activation/compute dtype
    param_dtype: str = "float32"           # master weights
    moment_dtype: str = "float32"          # Adam moments (bf16 for the giants)
    grad_accum_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "chunked"             # naive | chunked (online softmax)
    attn_chunk: int = 512
    # sequence-parallel flash: K/V ring schedule kicks in at S_k >= this
    # (below it the all-gather wrapper wins — see kernels/flash_attention
    # use_ring and DESIGN.md §12); 0 defers to the library default
    # (kernels/flash_attention.RING_MIN_SK, 4096) so retuning it there
    # retunes every config-routed layer
    attn_ring_min_sk: int = 0
    loss_chunk: int = 1024                 # CE computed over seq chunks
    vocab_pad_multiple: int = 256

    # -- paper integration ---------------------------------------------------
    cws_head: bool = False                 # attach CWSClassifierHead
    cws_k: int = 512
    cws_b_i: int = 8

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, (
            self.name, self.n_layers, self.block_pattern)

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def q_flat(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_flat(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def master_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def is_moe_block(self, idx_in_pattern: int) -> bool:
        if self.moe is None:
            return False
        return (idx_in_pattern % self.moe.every) == (self.moe.every - 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.padded_vocab
        n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        total = v * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.block_pattern):
            b = 0
            if kind in ("attn", "local"):
                b += d * self.q_flat * 2      # wq, wo
                b += d * self.kv_flat * 2     # wk, wv
            elif kind == "ssm":
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                proj_in = 2 * d_in + 2 * s.d_state + nheads
                b += d * proj_in + d_in * d + d_in  # in_proj/out_proj/D
            elif kind == "rglru":
                w = self.rnn_width or d
                b += 2 * d * w + w * d        # in (x, gate-input), out
                b += 2 * w * w                # rg-lru a-gate, input-gate
            if kind != "ssm":  # every non-SSM block carries an MLP
                if self.moe is not None and self.is_moe_block(i):
                    m = self.moe
                    b += m.num_experts * n_mats * d * m.d_ff_expert
                    if m.shared_expert:
                        b += n_mats * d * m.d_ff_expert
                    b += d * m.num_experts     # router
                else:
                    b += n_mats * d * self.d_ff
            total += b * self.n_units
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE FLOP accounting."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        full = self.param_count()
        moe_blocks = sum(1 for i, k in enumerate(self.block_pattern)
                         if k in ("attn", "local") and self.is_moe_block(i))
        moe_blocks *= self.n_units
        all_expert = moe_blocks * m.num_experts * n_mats * self.d_model * m.d_ff_expert
        active_expert = moe_blocks * m.top_k * n_mats * self.d_model * m.d_ff_expert
        return full - all_expert + active_expert
