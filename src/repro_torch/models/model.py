"""Config-driven decoder LM: init / forward / train loss / prefill / decode.

Port of ``repro.models.model`` for the dense attention models (block
kinds ``attn`` and ``local``, dense MLPs).  The layer stack is
``n_units`` repetitions of ``cfg.block_pattern``; every parameter leaf
carries a leading unit axis U, and the reference's ``lax.scan`` over
units is a Python loop over that axis.  Under autograd with
``cfg.remat`` each unit runs inside a non-reentrant
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scan body): only the unit's input is kept, and the backward runs the
unit's forward again.  Caches mirror the layout: a tuple
(one entry per block in the pattern) of stacked (U, ...) ``KVCache``s,
written in place (``attention._write_cache``).
"""
from __future__ import annotations

from typing import Optional

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_cross_entropy, embed_tokens,
                                       init_embed, init_mlp, init_rmsnorm,
                                       lm_logits, mlp, rmsnorm)
from repro_torch.models.sharding import current_rules, seq_shards

ZERO_AUX = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0, "moe_dropped": 0.0}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not build yet (ROADMAP A12)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts blocks (models/moe.py) are not "
            f"ported yet (ROADMAP A12)")
    for kind in cfg.block_pattern:
        if kind in ("ssm", "rglru"):
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} blocks (models/{kind}.py) are not "
                f"ported yet (ROADMAP A12)")
        if kind not in ("attn", "local"):
            raise ValueError(kind)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> dict:
    """Fresh parameters with the reference's distributions (truncated
    normals at +-2 times their scale, zero norm scales), drawn from
    ``generator`` (default: one seeded with 0) directly on ``device`` (by
    default the generator's), so a full-width model never exists on the
    host.  Not the reference's draws: tests carry its weights across
    (``interop``).  ``device="meta"`` gives the shapes alone."""
    check_supported(cfg)
    device = resolve_device(device) if generator is None else \
        resolve_device(device or generator.device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device).manual_seed(0)
    u, dt = cfg.n_units, cfg.master_dtype
    units = {}
    for i, _kind in enumerate(cfg.block_pattern):
        units[f"block{i}"] = {
            "norm1": init_rmsnorm(cfg.d_model, dt, device, (u,)),
            "mixer": attn_lib.init_attention(generator, cfg, device, (u,)),
            "norm2": init_rmsnorm(cfg.d_model, dt, device, (u,)),
            "mlp": init_mlp(generator, cfg, device, (u,)),
        }
    return {
        "embed": init_embed(generator, cfg, device),
        "units": units,
        "final_norm": init_rmsnorm(cfg.d_model, dt, device),
    }


def _tree_map_(fn, tree):
    """Replace every tensor leaf of a nested dict by ``fn(leaf)``, in
    place, one leaf at a time."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _tree_map_(fn, val)
        else:
            tree[key] = fn(val)
    return tree


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast every leaf to ``dtype`` in place, one leaf at a time (the peak
    is the model plus one leaf).  For a serving model in its compute dtype
    this gives the same bits as the per-use casts of the masters, whose
    casts then cost nothing."""
    return _tree_map_(lambda t: t.to(dtype), params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device=None):
    """Stacked (U, ...) caches, one entry per block in the pattern; a local
    block keeps only its window (a rolling cache)."""
    check_supported(cfg)
    device = resolve_device(device)
    u = cfg.n_units
    entries = []
    for kind in cfg.block_pattern:
        m = max_len if kind == "attn" else min(cfg.window, max_len)
        shape = (u, batch, m, cfg.n_kv_heads, cfg.head_dim_)
        entries.append(attn_lib.KVCache(
            k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            length=torch.zeros((u,), dtype=torch.int32, device=device)))
    return tuple(entries)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(params: dict, x, cfg: ModelConfig, *, kind: str,
                 positions, cache, update_cache: bool):
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    theta = cfg.rope_theta_global if (kind == "attn" and
                                      cfg.rope_theta_global > 0) \
        else cfg.rope_theta
    mix, new_cache = attn_lib.attention(
        params["mixer"], h, cfg, kind=kind, positions=positions,
        cache=cache, update_cache=update_cache, rope_theta=theta)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h2, cfg), new_cache


def _unit_slice(tree, u: int):
    return {k: _unit_slice(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


def _apply_unit(unit_params: dict, x, cfg: ModelConfig, *, positions,
                caches, update_cache: bool):
    new_caches = []
    for i, kind in enumerate(cfg.block_pattern):
        cache_i = caches[i] if caches is not None else None
        x, nc = _apply_block(unit_params[f"block{i}"], x, cfg, kind=kind,
                             positions=positions, cache=cache_i,
                             update_cache=update_cache)
        new_caches.append(nc)
    return x, tuple(new_caches)


def forward(params: dict, inputs, cfg: ModelConfig, *, caches=None,
            update_cache: bool = False, positions=None):
    """inputs: (B, S) int tokens or (B, S, D) embeddings (vlm/audio stub).

    Returns (hidden (B, S, D), caches, aux).  The caches are the ones
    passed in, written in place when ``update_cache``.

    Under axis rules (``sharding.use_rules``) whose sequence axes span N
    ranks, ``inputs`` is this rank's shard of the residual stream, its
    rows ``index * S .. index * S + S - 1`` of the global sequence
    (``sharding.local_shard(tokens, rules, "batch", "sp")``), and so is
    the hidden state returned; the weights are whole on every rank.  The
    default positions are then global, so RoPE and the windows see true
    sequence coordinates.  Everything but attention is per token and
    stays local; attention reaches the other ranks' K/V through the
    sequence-parallel schedules."""
    check_supported(cfg)
    if inputs.ndim == 2:
        x = embed_tokens(params["embed"], inputs, cfg)
    else:
        x = inputs.to(cfg.compute_dtype)
    if positions is None:
        seq_axes, n = seq_shards()
        base = current_rules().mesh.axis_index(seq_axes) * x.shape[1] \
            if n > 1 else 0
        positions = torch.arange(base, base + x.shape[1],
                                 device=x.device)[None, :]
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for u in range(cfg.n_units):
        unit_caches = None if caches is None else tuple(
            attn_lib.KVCache(c.k[u], c.v[u], c.length[u]) for c in caches)
        unit_params = _unit_slice(params["units"], u)
        if remat:
            x = checkpoint(lambda x_, p_: _apply_unit(
                p_, x_, cfg, positions=positions, caches=None,
                update_cache=False)[0], x, unit_params, use_reentrant=False)
            continue
        x, _ = _apply_unit(unit_params, x, cfg, positions=positions,
                           caches=unit_caches, update_cache=update_cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches, dict(ZERO_AUX)


def train_loss(params: dict, inputs, labels, cfg: ModelConfig):
    """(loss, metrics): the mean next-token nll over the valid labels
    (``layers.chunked_cross_entropy``), with metrics ``nll``, ``tokens``
    and the reference's zero MoE terms (no MoE block is ported)."""
    hidden, _, aux = forward(params, inputs, cfg)
    nll, n_tok = chunked_cross_entropy(params["embed"], hidden, labels, cfg)
    return nll, {"nll": nll, "tokens": n_tok, **aux}


def prefill(params: dict, inputs, cfg: ModelConfig, caches):
    """Process a full prompt, fill caches, return logits of last position."""
    hidden, caches, _ = forward(params, inputs, cfg, caches=caches,
                                update_cache=True)
    logits = lm_logits(params["embed"], hidden[:, -1:], cfg)
    return logits[:, 0], caches


def decode_step(params: dict, tokens, pos, cfg: ModelConfig, caches):
    """tokens: (B, 1) int (or (B, 1, D) embeddings); pos: int or () int."""
    device = tokens.device
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=device).reshape(1, 1)
    hidden, caches, _ = forward(params, tokens, cfg, caches=caches,
                                update_cache=True, positions=positions)
    logits = lm_logits(params["embed"], hidden, cfg)
    return logits[:, 0], caches
