"""Shared layers: RMSNorm, embeddings, RoPE, MLPs (dense + gated + sq-relu),
and the chunked cross-entropy.

Port of ``repro.models.layers``.  Parameters are plain dictionaries of
tensors in the reference's layout; every ``init_*`` takes a
``torch.Generator`` and a ``lead`` shape that stacks the leaf (the model's
leading unit axis).  Weights are cast to the compute dtype at each use, as
the reference does (a cast of a tensor already in that dtype is free).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.collectives import (all_gather_grad, gather_parts,
                                            max_nograd, reshard_grad,
                                            sum_forward)
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import local_shard


# a leaf narrower than fp32 and larger than this is drawn in slices of at
# most this many elements, so that no fp32 copy of the whole leaf exists
# (llama4's (128, 5120, 8192) expert stack is 21.5 GB in fp32)
DRAW_SLICE = 1 << 28
# the tied table's rows whose fp32 copy a vocabulary-sharded logit
# product makes at once hold at most this many elements (256 MB)
LOGIT_CHUNK_ELEMS = 1 << 26


def trunc_normal(generator: Optional[torch.Generator], shape, scale: float,
                 dtype: torch.dtype, device) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], drawn on
    ``device`` (the reference's ``jax.random.truncated_normal``; not the
    same draws)."""
    shape = tuple(shape)
    if dtype == torch.float32 or math.prod(shape) <= DRAW_SLICE or \
            torch.device(device).type == "meta":
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, DRAW_SLICE // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        part = rows[r0:r0 + step]
        t = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(t.mul_(scale))
    return out


# ---------------------------------------------------------------------------
# RMSNorm (fp32 variance)
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype: torch.dtype, device,
                 lead: Tuple[int, ...] = ()) -> dict:
    return {"scale": torch.zeros(lead + (dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    # the variance in fp32; the normalizing multiplies stay in x's dtype,
    # in the reference's order: x * inv * (1 + scale)
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + params["scale"].to(x.dtype))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embed(generator, cfg: ModelConfig, device) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"tokens": trunc_normal(generator, (v, d), 1.0, cfg.master_dtype,
                                device)}
    if not cfg.tie_embeddings:
        p["head"] = trunc_normal(generator, (d, v), d ** -0.5,
                                 cfg.master_dtype, device)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same bits as the reference's cast-then-gather
    # without a compute-dtype copy of the whole table.  F.embedding, not
    # indexing: its backward sums each row's gradients in a fixed order
    # (indexing's accumulating scatter does not, on the CPU)
    return F.embedding(tokens.long(), params["tokens"]).to(cfg.compute_dtype)


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.tie_embeddings:
        w = params["tokens"].to(dt).T
    else:
        w = params["head"].to(dt)
    logits = x @ w
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# RoPE (halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (Dh/2,)
    ang = positions[..., :, None].float() * freqs                # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg: ModelConfig, device,
             lead: Tuple[int, ...] = (), d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.master_dtype
    p = {}
    if cfg.activation in ("swiglu", "geglu"):
        p["gate"] = trunc_normal(generator, lead + (d, ff), d ** -0.5, dt,
                                 device)
    p["up"] = trunc_normal(generator, lead + (d, ff), d ** -0.5, dt, device)
    p["down"] = trunc_normal(generator, lead + (ff, d), ff ** -0.5, dt,
                             device)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.activation in ("swiglu", "geglu"):
        g = x @ params["gate"].to(dt)
        u = x @ params["up"].to(dt)
        act = F.silu(g) if cfg.activation == "swiglu" else _gelu(g)
        h = act * u
    else:
        u = x @ params["up"].to(dt)
        if cfg.activation == "sq_relu":
            h = torch.square(F.relu(u))
        else:  # gelu
            h = _gelu(u)
    return h @ params["down"].to(dt)


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materializes the whole (B, S, V) fp32 logits)
# ---------------------------------------------------------------------------

def _chunks(x: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig):
    """x and labels padded to a multiple of the loss chunk (label -1),
    the labels' validity mask, and the chunk length."""
    s = x.shape[1]
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < cfg.vocab)
    return x, labels, valid, chunk


def _chunk_sums(body, x, labels, valid, chunk):
    """(sum of ``body`` over the chunks, valid tokens): under autograd
    each chunk's logits are recomputed in the backward (a non-reentrant
    checkpoint per chunk, the reference's ``jax.checkpoint(body)``)."""
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for c0 in range(0, x.shape[1], chunk):
        args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                valid[:, c0:c0 + chunk])
        tot = tot + (checkpoint(body, *args, use_reentrant=False) if remat
                     else body(*args))
        cnt = cnt + args[2].sum()
    return tot, cnt


def cross_entropy_sums(embed_params: dict, x: torch.Tensor,
                       labels: torch.Tensor, cfg: ModelConfig):
    """(summed nll, token count) of ``chunked_cross_entropy``."""
    x, labels, valid, chunk = _chunks(x, labels, cfg)
    vocab_ok = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab

    def body(xc, lc, vm):
        logits = lm_logits(embed_params, xc, cfg).float()
        logits = torch.where(vocab_ok, logits, -torch.inf)
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, lc.clamp(0, cfg.padded_vocab - 1)
                            [..., None])[..., 0]
        return torch.where(vm, logz - gold, 0.0).sum()

    return _chunk_sums(body, x, labels, valid, chunk)


def chunked_cross_entropy(embed_params: dict, x: torch.Tensor,
                          labels: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D), labels: (B, S) -> (mean nll, token count), both fp32
    0-dim tensors.  The sequence is padded to a multiple of
    ``cfg.loss_chunk`` with label -1; labels outside [0, vocab) and the
    padded vocabulary ids are masked.  Under autograd each chunk's logits
    are recomputed in the backward, so one chunk's fp32 logits are live at
    a time."""
    tot, cnt = cross_entropy_sums(embed_params, x, labels, cfg)
    return tot / torch.clamp_min(cnt, 1.0), cnt


# ---------------------------------------------------------------------------
# the train layout's sharded forms (FSDP x TP; ``sharding.TrainLayout``)
# ---------------------------------------------------------------------------

def seq_shard(x: torch.Tensor, layout) -> torch.Tensor:
    """This rank's shard of x's sequence (dim 1) over the ``sp`` axes; a
    sequence that does not divide raises (``sharding.local_shard``).
    Under ``one_token`` (a decode step) x stays whole."""
    if layout.one_token:
        return x
    return local_shard(x, layout.rules, None, "sp")


def embed_tokens_tp(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    layout, spec: dict) -> torch.Tensor:
    """The whole sequence's tokens (B, S) -> this rank's shard of the
    residual stream (B, S / sp, D).  The table is D-sharded over ``tp``
    (``(None, "tp")``): each rank looks up every token's D / tp columns,
    gathers D and keeps its rows (the backward reduce-scatters D).  A
    table left whole looks up its own rows alone."""
    if not layout.tp_sharded(spec["tokens"], 1):
        return embed_tokens(params, seq_shard(tokens, layout), cfg)
    x = embed_tokens(params, tokens, cfg)
    x = all_gather_grad(x, layout.mesh, layout.tp_axes, 2)
    return seq_shard(x, layout)


def mlp_tp(params: dict, x: torch.Tensor, cfg: ModelConfig, layout,
           spec: dict) -> torch.Tensor:
    """The MLP on this rank's shard of the residual stream (B, S / sp, D):
    the sequence gathered over ``sp`` (the reference's ``shard(x, "batch",
    None, None)``), ``gate`` / ``up`` column-parallel, ``down``
    row-parallel, the partial sums reduce-scattered back to the sequence
    shards (``shard(out, "batch", "sp", None)``), or for a decode step's
    one token summed over ``tp`` (``layout.row_reduce``).  A d_ff that
    does not divide over ``tp`` leaves the weights whole: each rank then
    runs its own rows."""
    if not layout.tp_sharded(spec["up"], -1):
        return mlp(params, x, cfg)
    out = mlp(params, all_gather_grad(x, layout.mesh, layout.sp_axes, 1),
              cfg)
    return layout.row_reduce(out)


def last_position(x: torch.Tensor, layout) -> torch.Tensor:
    """The global sequence's last position (B, 1, D), on every rank, from
    this rank's shard of it over ``sp`` (the last rank's last row)."""
    if layout.sp == 1:
        return x[:, -1:]
    return gather_parts(x[:, -1:], layout.mesh, layout.sp_axes)[-1]


def lm_logits_tp(params: dict, x: torch.Tensor, cfg: ModelConfig, layout,
                 spec: dict) -> torch.Tensor:
    """``lm_logits`` of x (B, S, D), whole on every rank of ``tp``, from
    the vocabulary shards: the whole (B, S, V) logits on every rank, so a
    greedy argmax is the global one (the lowest id winning ties).  An
    untied ``head`` (``(None, "tp")``) gives each rank its V / tp columns,
    all-gathered.  The tied table is D-sharded (``(None, "tp")``): each
    rank's fp32 product of its D / tp columns, summed over ``tp`` in rank
    order and rounded once to the compute dtype (GSPMD's partial-sum
    route; no table moves), V a chunk at a time.  A leaf left whole
    computes the logits locally."""
    n = layout.tp
    dt = cfg.compute_dtype
    key = "tokens" if cfg.tie_embeddings else "head"
    if n == 1 or not layout.tp_sharded(spec[key], 1):
        return lm_logits(params, x, cfg)
    mesh, axes = layout.mesh, layout.tp_axes
    if cfg.tie_embeddings:
        tab = params["tokens"]
        dl = tab.shape[1]
        xs = x.narrow(-1, layout.tp_index() * dl, dl).float()
        step = max(1, LOGIT_CHUNK_ELEMS // dl)
        part = torch.cat([xs @ tab[v0:v0 + step].to(dt).float().T
                          for v0 in range(0, tab.shape[0], step)], -1)
        logits = sum_forward(part, mesh, axes).to(dt)
    else:
        logits = all_gather_grad(x @ params["head"].to(dt), mesh, axes, -1)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def cross_entropy_sums_tp(embed_params: dict, x: torch.Tensor,
                          labels: torch.Tensor, cfg: ModelConfig, layout,
                          spec: dict):
    """(summed nll, token count) over this rank's batch rows, the logits
    sharded over the vocabulary: x is this rank's shard of the final
    hidden state (B, S / sp, D), labels the whole sequence's (B, S).

    The sequence is gathered over ``tp``; each rank computes its V / tp
    slice of every chunk's logits, from ``head`` (``(None, "tp")``) or the
    tied table (D-sharded: resharded to V-sharded by one all-to-all a
    call, its backward the reverse).  logsumexp takes the max over the
    ranks (outside the graph), then the sum of exp over them; the gold
    logit comes from the rank that owns its id (a sum); padded ids are
    masked at their global ids.  Every rank of ``tp`` returns the same
    sums.  The per-chunk checkpoint stays."""
    mesh, axes, n = layout.mesh, layout.tp_axes, layout.tp
    if n == 1:
        return cross_entropy_sums(embed_params, x, labels, cfg)
    if cfg.padded_vocab % n:
        # a vocabulary that does not divide over tp: each rank its own rows
        # of the sequence over the whole vocabulary (a D-sharded tied table
        # gathered), the sums added over the sequence ranks
        table = dict(embed_params)
        if cfg.tie_embeddings and layout.tp_sharded(spec["tokens"], 1):
            table["tokens"] = all_gather_grad(table["tokens"], mesh, axes, 1)
        sr = x.shape[1]
        lo = mesh.axis_index(layout.sp_axes) * sr
        tot, cnt = cross_entropy_sums(table, x, labels[:, lo:lo + sr], cfg)
        return (sum_forward(tot, mesh, layout.sp_axes),
                sum_forward(cnt, mesh, layout.sp_axes))
    dt = cfg.compute_dtype
    vl = cfg.padded_vocab // n
    v0 = layout.tp_index() * vl
    if cfg.tie_embeddings:
        tab = embed_params["tokens"].to(dt)
        tab = reshard_grad(tab, mesh, axes, 0, 1) \
            if layout.tp_sharded(spec["tokens"], 1) else tab.narrow(0, v0, vl)
        w = tab.T
    else:
        w = embed_params["head"].to(dt)
        if not layout.tp_sharded(spec["head"], 1):
            w = w.narrow(1, v0, vl)
    x = all_gather_grad(x, mesh, layout.sp_axes, 1)
    x, labels, valid, chunk = _chunks(x, labels, cfg)
    vocab_ok = torch.arange(v0, v0 + vl, device=x.device) < cfg.vocab

    def body(xc, lc, vm):
        logits = xc @ w
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        logits = torch.where(vocab_ok, logits.float(), -torch.inf)
        m = max_nograd(logits.amax(-1), mesh, axes)
        se = sum_forward(torch.exp(logits - m[..., None]).sum(-1), mesh,
                         axes)
        logz = m + torch.log(se)
        local = lc.clamp(0, cfg.padded_vocab - 1) - v0
        own = (local >= 0) & (local < vl)
        g = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
        gold = sum_forward(torch.where(own, g, 0.0), mesh, axes)
        return torch.where(vm, logz - gold, 0.0).sum()

    return _chunk_sums(body, x, labels, valid, chunk)
