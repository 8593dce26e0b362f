"""Config-driven decoder LM: init / forward / train loss / prefill / decode.

Port of ``repro.models.model`` for every block kind: ``attn`` and
``local`` attention, ``ssm`` (``models.ssm``) and ``rglru``
(``models.rglru``) mixers, dense or mixture-of-experts MLPs
(``models.moe``; ``cfg.is_moe_block``).  The layer stack is ``n_units``
repetitions of ``cfg.block_pattern``; every parameter leaf carries a
leading unit axis U, and the reference's ``lax.scan`` over units is a
Python loop over that axis.  Under autograd with ``cfg.remat`` each unit
runs inside a non-reentrant ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the scan body): only the unit's input is kept, and
the backward runs the unit's forward again.  Caches mirror the layout: a
tuple (one entry per block in the pattern) of stacked (U, ...)
``KVCache``s, ``SSMState``s or ``RGLRUState``s, written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.device import pin_fp32_reduction, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.launch.collectives import all_gather_grad, sum_forward
from repro_torch.models.layers import (chunked_cross_entropy,
                                       cross_entropy_sums_tp, embed_tokens,
                                       embed_tokens_tp, init_embed, init_mlp,
                                       init_rmsnorm, last_position,
                                       lm_logits, lm_logits_tp, mlp, mlp_tp,
                                       rmsnorm, seq_shard)
from repro_torch.models.sharding import (CacheShards, batch_axes,
                                         current_rules, map_specs,
                                         seq_rows, seq_shards, shard_bounds,
                                         spec_axes, use_rules)

ZERO_AUX = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0, "moe_dropped": 0.0}
KINDS = ("attn", "local", "ssm", "rglru")
# leaves that the reference keeps in fp32 under any master dtype
FP32_LEAVES = frozenset({"router", "a_log", "dt_bias", "d_skip", "b_a",
                         "b_i", "lam"})


def check_supported(cfg: ModelConfig, layout=None) -> None:
    """Raise for an unknown block kind, and under the train and serving
    layout (``layout``: ``make_train_step(rules=)``,
    ``make_serve_steps(cfg, rules)``) for sequence axes other than the
    ``tp`` axes: the layout gathers the sequence over ``tp`` for its
    tensor-parallel layers."""
    for kind in cfg.block_pattern:
        if kind not in KINDS:
            raise ValueError(kind)
    if layout is None:
        return
    sp_axes = layout.axes("sp")
    sp = layout.rules.axes_size(sp_axes)
    if max(layout.tp, sp) > 1 and set(sp_axes) != set(layout.tp_axes):
        raise NotImplementedError(
            f"the train and serving layout shards the sequence over the tp "
            f"axes {layout.tp_axes}; got sp over {sp_axes}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, kind: str, is_moe: bool,
                device, lead) -> dict:
    dt = cfg.master_dtype
    p = {"norm1": init_rmsnorm(cfg.d_model, dt, device, lead)}
    if kind in ("attn", "local"):
        p["mixer"] = attn_lib.init_attention(generator, cfg, device, lead)
    elif kind == "ssm":
        p["mixer"] = ssm_lib.init_ssm(generator, cfg, device, lead)
    else:
        p["mixer"] = rglru_lib.init_rglru(generator, cfg, device, lead)
    if kind != "ssm":
        p["norm2"] = init_rmsnorm(cfg.d_model, dt, device, lead)
        p["mlp"] = moe_lib.init_moe(generator, cfg, device, lead) if is_moe \
            else init_mlp(generator, cfg, device, lead)
    return p


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None, *, keep=None) -> dict:
    """Fresh parameters with the reference's distributions (truncated
    normals at +-2 times their scale, zero norm scales, the SSM's and
    RG-LRU's fixed decay ladders), drawn from ``generator`` (default: one
    seeded with 0) directly on ``device`` (by default the generator's), so
    a full-width model never exists on the host.  Leaves take the
    reference's dtypes: ``cfg.master_dtype``, and fp32 for the
    ``FP32_LEAVES``.  Not the reference's draws: tests carry its weights
    across (``interop``).  ``device="meta"`` gives the shapes alone.

    ``keep(path, tensor)`` (the sharded trainer's) maps each leaf, by its
    path of keys, to what is kept of it, as soon as its block is drawn:
    the draws are the same, so a rank's slices equal the unsharded
    model's, and no more than one block is ever whole."""
    check_supported(cfg)
    device = resolve_device(device) if generator is None else \
        resolve_device(device or generator.device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device).manual_seed(0)

    def kept(tree, path):
        if keep is None:
            return tree
        return {k: kept(v, path + (k,)) if isinstance(v, dict)
                else keep(path + (k,), v) for k, v in tree.items()}

    # the draw order: the units, then the table
    units = {f"block{i}": kept(_init_block(generator, cfg, kind,
                                           cfg.is_moe_block(i), device,
                                           (cfg.n_units,)),
                               ("units", f"block{i}"))
             for i, kind in enumerate(cfg.block_pattern)}
    return {
        "embed": kept(init_embed(generator, cfg, device), ("embed",)),
        "units": units,
        "final_norm": kept(init_rmsnorm(cfg.d_model, cfg.master_dtype,
                                        device), ("final_norm",)),
    }


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast every leaf but the ``FP32_LEAVES`` to ``dtype`` in place, one
    leaf at a time (the peak is the model plus one leaf).  For a serving
    model in its compute dtype this gives the same bits as the per-use
    casts of the masters, whose casts then cost nothing; the fp32 leaves
    are used in fp32, as the reference uses them."""
    for key, val in params.items():
        if isinstance(val, dict):
            cast_params(val, dtype)
        elif key not in FP32_LEAVES:
            params[key] = val.to(dtype)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                long: bool = False, rules=None, device=None):
    """Stacked (U, ...) caches, one entry per block in the pattern: a
    ``KVCache`` (a local block keeps only its window, a rolling cache), an
    ``SSMState`` (conv in the compute dtype, h fp32 (U, B, H, P, N)) or an
    ``RGLRUState`` (h fp32 (U, B, W), conv (U, B, 3, W)).

    Under ``rules`` (serving with ``make_serve_steps(cfg, rules)``) each
    rank allocates only its shard, the ``shard_bounds`` of the
    reference's ``cache_pspecs(cfg, rules, batch=, max_len=, long=)``: KV
    heads over ``tp`` where they divide (not ``long``), else the slots
    over ``kv_seq``, a ``long`` global cache over ``long_seq``; the batch
    over ``batch``; a dim that does not divide whole.  Returns a
    ``sharding.CacheShards`` that carries the global shapes and the specs.
    ``long`` only places the caches: without rules it changes nothing, as
    in the reference."""
    if rules is not None:
        return _cache_shards(cfg, batch, max_len, long, rules, device)
    check_supported(cfg)
    device = resolve_device(device)
    u, dt = cfg.n_units, cfg.compute_dtype
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             device=device)
    length = lambda: zeros((u,), torch.int32)
    entries = []
    for kind in cfg.block_pattern:
        if kind in ("attn", "local"):
            m = max_len if kind == "attn" else min(cfg.window, max_len)
            shape = (u, batch, m, cfg.n_kv_heads, cfg.head_dim_)
            entries.append(attn_lib.KVCache(k=zeros(shape, dt),
                                            v=zeros(shape, dt),
                                            length=length()))
        elif kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            entries.append(ssm_lib.SSMState(
                conv=zeros((u, batch, s.d_conv - 1, d_in + 2 * s.d_state),
                           dt),
                h=zeros((u, batch, d_in // s.head_dim, s.head_dim,
                         s.d_state), torch.float32),
                length=length()))
        else:
            w = cfg.rnn_width or cfg.d_model
            entries.append(rglru_lib.RGLRUState(
                h=zeros((u, batch, w), torch.float32),
                conv=zeros((u, batch, 3, w), dt), length=length()))
    return tuple(entries)


def _cache_shards(cfg: ModelConfig, batch: int, max_len: int, long: bool,
                  rules, device) -> CacheShards:
    """``init_caches`` under ``rules`` (see there)."""
    from repro_torch.training.trainer import cache_pspecs
    device = resolve_device(device)
    shapes = init_caches(cfg, batch, max_len, device="meta")
    specs = cache_pspecs(cfg, rules, batch=batch, max_len=max_len, long=long)

    def shard(t, spec):
        axes = [a for a in spec_axes(spec) if rules.mesh.shape[a] > 1]
        if len(set(axes)) != len(axes):
            # a mesh axis of more than one rank in two dims of one leaf
            # (the reference's PartitionSpec refuses any axis twice)
            raise ValueError(
                f"cache spec {spec} for {tuple(t.shape)} uses a mesh axis "
                f"twice (a long cache's slots over long_seq with a batch of "
                f"{batch} split over the same axes): take a batch that does "
                f"not divide over the batch axes")
        size = [hi - lo for lo, hi in shard_bounds(t.shape, spec,
                                                    rules.mesh)]
        return torch.zeros(size, dtype=t.dtype, device=device)

    return CacheShards(map_specs(shard, shapes, specs), shapes, specs)


def embed_generated(params: dict, tokens, cfg: ModelConfig, *,
                    layout=None) -> torch.Tensor:
    """Generated ids (B, 1) as a decode step's input embeddings for the
    stub frontends (``input_mode == "embeddings"``): rows of the output
    table in the compute dtype, as the reference's serving loop takes
    them; under a layout whose table is D-sharded the columns are
    gathered over ``tp``."""
    if layout is None:
        return embed_tokens(params["embed"], tokens, cfg)
    one = dataclasses.replace(layout, one_token=True)
    return embed_tokens_tp(params["embed"], tokens, cfg, one,
                           layout.specs["embed"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _write_state(cache, new) -> None:
    """Copy a recurrent block's new state into its (unit's view of the)
    stacked cache, in place."""
    for dst, src in zip(cache, new):
        dst.copy_(src)


def _apply_block(params: dict, x, cfg: ModelConfig, *, kind: str,
                 is_moe: bool, positions, cache, update_cache: bool,
                 layout=None, spec=None, kv=None):
    """(x, aux): the reference's block, with a cache written in place.
    Under a layout of tp > 1 (``spec``: the block's specs, unit axis
    dropped) attention, the MLP, the SSM and the RG-LRU run their
    tensor-parallel forms on this rank's shard of the residual stream;
    under a layout with a cache (any tp) attention runs ``attention_tp``
    on the cache's shard, placed by ``kv``; under a layout that splits
    the batch or the sequence an MoE block runs ``moe_mlp_tp`` (its
    capacity and aux terms over the global batch).  Under axis rules
    whose sequence axes span more than one rank (the sequence-parallel
    forward, weights whole) the MoE, SSM and RG-LRU blocks gather the
    sequence, run it whole and keep their own rows; the MoE's aux terms
    are the global batch's there wherever the rules split the batch or
    the sequence."""
    aux = dict(ZERO_AUX)
    tp = layout is not None and layout.tp > 1
    seq_axes, n_seq = seq_shards() if layout is None else ((), 1)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind in ("attn", "local"):
        theta = cfg.rope_theta_global if (kind == "attn" and
                                          cfg.rope_theta_global > 0) \
            else cfg.rope_theta
        if tp or (layout is not None and cache is not None):
            mix, _ = attn_lib.attention_tp(
                params["mixer"], h, cfg, kind=kind, layout=layout,
                spec=spec["mixer"], rope_theta=theta, positions=positions,
                cache=cache, kv=kv)
        else:
            mix, _ = attn_lib.attention(
                params["mixer"], h, cfg, kind=kind, positions=positions,
                cache=cache, update_cache=update_cache, rope_theta=theta)
    else:
        ssm = kind == "ssm"
        if tp:
            block = ssm_lib.ssm_block_tp if ssm else rglru_lib.rglru_block_tp
            mix, new_state = block(params["mixer"], h, cfg, layout,
                                   spec["mixer"], state=cache,
                                   update_state=update_cache)
        elif n_seq > 1:
            mix = _seq_whole(ssm_lib.ssm_block if ssm else
                             rglru_lib.rglru_block, params["mixer"], h, cfg,
                             cache, seq_axes)
            new_state = None
        else:
            block = ssm_lib.ssm_block if ssm else rglru_lib.rglru_block
            mix, new_state = block(params["mixer"], h, cfg, state=cache,
                                   update_state=update_cache)
        if update_cache and cache is not None:
            _write_state(cache, new_state)
    x = x + mix
    if kind != "ssm":
        h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
        if is_moe:
            # exact (dropless) capacity for small inference token counts
            # (the global length: x holds a shard of it under a layout);
            # Switch-style capacity dropping otherwise
            s = x.shape[1] * (1 if layout is None else layout.sp)
            exact = cache is not None and s * cfg.moe.top_k <= 256
            rules = current_rules() if layout is None else layout.rules
            split = rules is not None and (
                n_seq > 1 or tp or rules.axes_size(batch_axes(rules)) > 1)
            if split and layout is not None:
                y, moe_aux = moe_lib.moe_mlp_tp(params["mlp"], h2, cfg,
                                                layout, spec["mlp"],
                                                exact_capacity=exact)
            elif split:
                y, moe_aux = moe_lib.moe_mlp_rows(
                    params["mlp"], h2, cfg, mesh=rules.mesh,
                    seq_axes=seq_axes, batch_axes=batch_axes(rules))
                y = seq_rows(y, rules.mesh, seq_axes, h2.shape[1])
                if cfg.moe.shared_expert:
                    y = y + mlp(params["mlp"]["shared"], h2, cfg)
            else:
                y, moe_aux = moe_lib.moe_mlp(params["mlp"], h2, cfg,
                                             exact_capacity=exact)
            aux.update(moe_aux)
        elif tp:
            y = mlp_tp(params["mlp"], h2, cfg, layout, spec["mlp"])
        else:
            y = mlp(params["mlp"], h2, cfg)
        x = x + y
    return x, aux


def _seq_whole(block, params: dict, h, cfg: ModelConfig, cache, seq_axes):
    """A recurrent block in the sequence-parallel forward: the sequence
    gathered over ``seq_axes``, the block run whole (the weights are whole
    on every rank), this rank's rows of its output."""
    if cache is not None:
        raise NotImplementedError(
            "the sequence-parallel forward (use_rules) runs without a "
            "cache: serve sharded through make_serve_steps(cfg, rules), "
            "whose caches come from init_caches(rules=)")
    mesh = current_rules().mesh
    out, _ = block(params, all_gather_grad(h, mesh, seq_axes, 1), cfg)
    return seq_rows(out, mesh, seq_axes, h.shape[1])


def _unit_slice(tree, u: int):
    return {k: _unit_slice(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


def _add_aux(total: dict, aux: dict) -> dict:
    return {k: total[k] + aux[k] for k in total}


def _apply_unit(unit_params: dict, x, cfg: ModelConfig, *, positions,
                caches, update_cache: bool, layout=None, specs=None,
                slices=None):
    """(x, the unit's aux summed over its blocks)."""
    aux_sum = dict(ZERO_AUX)
    for i, kind in enumerate(cfg.block_pattern):
        x, aux = _apply_block(
            unit_params[f"block{i}"], x, cfg, kind=kind,
            is_moe=cfg.is_moe_block(i), positions=positions,
            cache=caches[i] if caches is not None else None,
            update_cache=update_cache, layout=layout,
            spec=None if specs is None else specs[f"block{i}"],
            kv=None if slices is None else slices[i])
        aux_sum = _add_aux(aux_sum, aux)
    return x, aux_sum


def _unit_specs(specs: dict) -> dict:
    """The units' spec tree with the leading unit axis dropped."""
    return {k: _unit_specs(v) if isinstance(v, dict) else v[1:]
            for k, v in specs.items()}


def _kv_slices(caches, mesh):
    """Each entry's ``attention.KVSlice`` (None for a recurrent state)
    from ``init_caches(rules=)``'s shapes and specs."""
    if not isinstance(caches, CacheShards):
        raise TypeError("under a layout the caches are init_caches(rules=)"
                        "'s shards (a CacheShards)")
    return tuple(attn_lib.kv_slice(tuple(sh.k.shape), sp.k, mesh)
                 if isinstance(c, attn_lib.KVCache) else None
                 for c, sh, sp in zip(caches, caches.shapes, caches.specs))


def _forward_layout(params: dict, inputs, cfg: ModelConfig, layout, *,
                    caches=None, update_cache=False, positions=None):
    """``forward`` under the train and serving layout (see ``forward``)."""
    check_supported(cfg, layout)
    specs = layout.specs
    if caches is not None and inputs.shape[1] == 1:
        layout = dataclasses.replace(layout, one_token=True)
    if inputs.ndim == 2:
        x = embed_tokens_tp(params["embed"], inputs, cfg, layout,
                            specs["embed"])
    else:
        x = seq_shard(inputs, layout).to(cfg.compute_dtype)
    # attention sees the whole sequence (tp > 1 gathers it; tp = 1 holds
    # it): global positions from 0
    if positions is None:
        positions = torch.arange(inputs.shape[1], device=x.device)[None, :]
    slices = None if caches is None else _kv_slices(caches, layout.mesh)
    unit_specs = _unit_specs(specs["units"])

    def unit(x_, p_, c_=None):
        # the FSDP gathers inside the checkpointed unit: the recompute
        # gathers again, and no gathered weight outlives its unit
        return _apply_unit(layout.gather_tree(p_, unit_specs), x_, cfg,
                           positions=positions, caches=c_,
                           update_cache=update_cache, layout=layout,
                           specs=unit_specs, slices=slices)

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    aux = dict(ZERO_AUX)
    for u in range(cfg.n_units):
        unit_params = _unit_slice(params["units"], u)
        if remat:
            x, aux_u = checkpoint(unit, x, unit_params, use_reentrant=False)
        else:
            x, aux_u = unit(x, unit_params, None if caches is None else tuple(
                type(c)(*(f[u] for f in c)) for c in caches))
        aux = _add_aux(aux, aux_u)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches, aux


def forward(params: dict, inputs, cfg: ModelConfig, *, caches=None,
            update_cache: bool = False, positions=None, layout=None):
    """inputs: (B, S) int tokens or (B, S, D) embeddings (vlm/audio stub).

    Returns (hidden (B, S, D), caches, aux).  The caches are the ones
    passed in, written in place when ``update_cache``.  aux holds the MoE
    terms summed over blocks and units, as the reference sums them (0.0
    without an MoE block).

    Under axis rules (``sharding.use_rules``) whose sequence axes span N
    ranks, ``inputs`` is this rank's shard of the residual stream, its
    rows ``index * S .. index * S + S - 1`` of the global sequence
    (``sharding.local_shard(tokens, rules, "batch", "sp")``), and so is
    the hidden state returned; the weights are whole on every rank.  The
    default positions are then global, so RoPE and the windows see true
    sequence coordinates.  The norms and dense MLPs are per token and
    stay local; attention reaches the other ranks' K/V through the
    sequence-parallel schedules; the MoE, SSM and RG-LRU blocks gather
    the sequence, run it whole and keep their own rows (the MoE's aux
    terms over the global batch: ``moe.moe_mlp_rows``).

    Under the train and serving layout (``layout``, a
    ``sharding.TrainLayout``; never guessed from the shapes) ``params``
    are this rank's slices (``shard_params``), ``inputs`` the whole
    sequence of this rank's batch rows, and the hidden state returned is
    this rank's shard of the sequence over ``sp``; each unit gathers its
    ``fsdp`` dims (inside its checkpoint under autograd), and attention,
    the MLP, the MoE (experts over ``experts``), the SSM (heads) and the
    RG-LRU (width) run tensor-parallel over ``tp``.  Caches are then
    ``init_caches(rules=)``'s shards; a decode step's one token (S = 1
    with caches) stays whole on every rank (``TrainLayout.one_token``),
    and so does the hidden state returned.  The products reduce in fp32
    (``device.pin_fp32_reduction``)."""
    pin_fp32_reduction()
    if layout is not None:
        return _forward_layout(params, inputs, cfg, layout, caches=caches,
                               update_cache=update_cache,
                               positions=positions)
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
    # the backward's recompute runs outside this call (and on the autograd
    # engine's thread): it installs the rules the forward ran under
    rules = current_rules()

    def unit_remat(x_, p_):
        with use_rules(rules):
            return _apply_unit(p_, x_, cfg, positions=positions, caches=None,
                               update_cache=False)

    aux = dict(ZERO_AUX)
    for u in range(cfg.n_units):
        unit_caches = None if caches is None else tuple(
            type(c)(*(f[u] for f in c)) for c in caches)
        unit_params = _unit_slice(params["units"], u)
        if remat:
            x, aux_u = checkpoint(unit_remat, x, unit_params,
                                  use_reentrant=False)
        else:
            x, aux_u = _apply_unit(unit_params, x, cfg, positions=positions,
                                   caches=unit_caches,
                                   update_cache=update_cache)
        aux = _add_aux(aux, aux_u)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches, aux


def train_loss(params: dict, inputs, labels, cfg: ModelConfig, *,
               layout=None):
    """(loss, metrics): the mean next-token nll over the valid labels
    (``layers.chunked_cross_entropy``), plus ``0.01 * lb + 1e-3 * z`` of
    the MoE aux terms when ``cfg.moe`` is set; metrics ``nll``, ``tokens``
    and the aux terms.

    Under the train layout the logits are sharded over the vocabulary
    (``layers.cross_entropy_sums_tp``) and the nll and the valid tokens
    are summed over the batch axes before the division: the loss is the
    global batch's mean, every token counted once, the same on every
    rank."""
    hidden, _, aux = forward(params, inputs, cfg, layout=layout)
    if layout is None:
        nll, n_tok = chunked_cross_entropy(params["embed"], hidden, labels,
                                           cfg)
    else:
        tot, n_tok = cross_entropy_sums_tp(params["embed"], hidden, labels,
                                           cfg, layout,
                                           layout.specs["embed"])
        batch = layout.axes("batch")
        tot = sum_forward(tot, layout.mesh, batch)
        n_tok = sum_forward(n_tok, layout.mesh, batch)
        nll = tot / torch.clamp_min(n_tok, 1.0)
    loss = nll
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    return loss, {"nll": nll, "tokens": n_tok, **aux}


def _logits(params: dict, hidden, cfg: ModelConfig, layout):
    if layout is None:
        return lm_logits(params["embed"], hidden, cfg)
    return lm_logits_tp(params["embed"], hidden, cfg, layout,
                        layout.specs["embed"])


def prefill(params: dict, inputs, cfg: ModelConfig, caches, *,
            layout=None):
    """Process a full prompt, fill caches, return logits of last position.
    Under a layout: this rank's slices, rows and cache shards (see
    ``forward``), the whole (B, V) logits on every rank."""
    hidden, caches, _ = forward(params, inputs, cfg, caches=caches,
                                update_cache=True, layout=layout)
    last = hidden[:, -1:] if layout is None else last_position(hidden,
                                                               layout)
    return _logits(params, last, cfg, layout)[:, 0], caches


def decode_step(params: dict, tokens, pos, cfg: ModelConfig, caches, *,
                layout=None):
    """tokens: (B, 1) int (or (B, 1, D) embeddings); pos: int or () int.
    Under a layout as ``prefill``."""
    device = tokens.device
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=device).reshape(1, 1)
    hidden, caches, _ = forward(params, tokens, cfg, caches=caches,
                                update_cache=True, positions=positions,
                                layout=layout)
    return _logits(params, hidden, cfg, layout)[:, 0], caches
