"""Mixture-of-Experts with sort-based capacity dispatch.

Port of ``repro.models.moe``.  Routing and slotting run per batch row, as
in the reference: the router (fp32 under any master dtype) picks the top-k
experts of every token, a stable sort of the (token, choice) pairs by
expert gives each pair its position in its expert's segment, and pairs at
positions of at least the capacity C are dropped.  Tokens are scattered
into an (E, C) expert buffer, the experts run as batched matmuls, and the
outputs are gathered back and weighted.

Where torch differs from jax:
  * ``jax.lax.top_k`` returns the lowest index among ties; ``torch.topk``
    promises no order, so the top k come from a stable descending sort.
  * The reference's ``mode="drop"`` scatter and ``mode="fill"`` gather have
    no torch mode: the buffer gets one dump row at slot E*C, which the
    dropped pairs write to and read zeros from, and which is sliced off.
  * ``jnp`` promotes a mixed-dtype product to the wider dtype; torch's
    matmul refuses one, so each such product casts as the promotion would.

Over ranks (``moe_mlp_rows``; under the train and serving layout
``moe_mlp_tp``, the expert stacks over ``experts``) each rank gathers its
batch rows' sequence, routes the whole rows at the global length's
capacity, dispatches only its experts' pairs and sums their outputs back
over the experts' ranks; the aux terms are the global batch's.

All of it is plain PyTorch: the reference's dispatch is ``argsort``,
``searchsorted``, scatter and gather, not a TPU kernel.  Every op here is
deterministic on the card: the scatter's backward is a gather, and the
gather's backward adds at most one value into every slot but the dump row.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.collectives import (all_gather_grad, axis_sum,
                                            sum_forward)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_gelu, init_mlp, mlp, mlp_tp,
                                       trunc_normal)
from repro_torch.models.sharding import seq_rows


def init_moe(generator, cfg: ModelConfig, device, lead=()) -> dict:
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = cfg.master_dtype
    lead = tuple(lead)
    p = {"router": trunc_normal(generator, lead + (d, e), d ** -0.5,
                                torch.float32, device),
         "down": trunc_normal(generator, lead + (e, ff, d), ff ** -0.5, dt,
                              device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["gate"] = trunc_normal(generator, lead + (e, d, ff), d ** -0.5, dt,
                                 device)
    p["up"] = trunc_normal(generator, lead + (e, d, ff), d ** -0.5, dt,
                           device)
    if m.shared_expert:
        p["shared"] = init_mlp(generator, cfg, device, lead, d_ff=ff)
    return p


def capacity(cfg: ModelConfig, s: int, exact: bool = False) -> int:
    """Slots per expert and batch row: S*K when exact (dropless), else the
    reference's ``max(1, int(-(-s * k * cf // e)))`` (a float ceiling)."""
    m = cfg.moe
    if exact:
        return s * m.top_k
    return max(1, int(-(-s * m.top_k * m.capacity_factor // m.num_experts)))


def route(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """(logits (B, S, E) fp32, probs, top_w (B, S, K) normalized, top_i)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: the lowest expert first among ties
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return logits, probs, top_w, top_i


def dispatch_slots(top_i: torch.Tensor, n_experts: int, cap: int):
    """The reference's per-row sort-based slotting.  top_i: (B, S, K) ->
    (slot of every (token, choice) pair (B, S*K), E*C for a dropped one;
    valid (B, S*K) in expert-sorted order).  Integer results, equal to
    the reference's exactly."""
    b, s, k = top_i.shape
    flat_e = top_i.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # position within the expert's segment: index - its first index
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(s * k, device=top_i.device)[None, :] - first
    valid = pos < cap
    slot_sorted = torch.where(valid, sorted_e * cap + pos, n_experts * cap)
    # invert the sort
    slot = torch.zeros_like(slot_sorted).scatter(1, order, slot_sorted)
    return slot, valid


def _dropped_count(kept: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``_dropped_share`` from the count of kept pairs and the count of
    pairs (0-dim int64 tensors, the global batch's): the reciprocal of n
    rounded to fp32 on the device, the same bits as the host's."""
    recip = (1.0 / n.double()).float().double()
    return (1.0 - kept.double() * recip).float()


def _dropped_share(valid: torch.Tensor) -> torch.Tensor:
    """``1 - mean(valid)`` as XLA computes the reference's on the CPU: the
    count times the fp32 reciprocal of n, subtracted from 1 in one fused
    multiply-add.  The count and the fp32 reciprocal multiply exactly in
    float64, and 1 minus that product is exact there too, so one rounding
    to fp32 gives the fused result.  Equal on every device."""
    # the reciprocal rounded to fp32 on the host: no copy to the device,
    # which would wait for the card on every call
    recip = float(torch.tensor(1.0 / valid.numel(), dtype=torch.float32))
    return (1.0 - valid.sum().double() * recip).float()


# an expert stack not in the compute dtype (bf16 masters under fp32
# compute) is cast a slice of experts at a time, each slice at most this
# many elements: llama4's (128, 5120, 8192) stacks are 21.5 GB each in fp32
CAST_SLICE = 1 << 28


def _experts(params: dict, h: torch.Tensor, cfg: ModelConfig,
             sl: slice) -> torch.Tensor:
    """Experts ``sl`` on their rows of the buffer, h: (B, E', C, d)."""
    dt = cfg.compute_dtype
    w = lambda name: params[name][sl].to(dt)
    if cfg.activation in ("swiglu", "geglu"):
        g = torch.einsum("becd,edf->becf", h, w("gate"))
        u = torch.einsum("becd,edf->becf", h, w("up"))
        z = (F.silu(g) if cfg.activation == "swiglu" else _gelu(g)) * u
    else:
        u = torch.einsum("becd,edf->becf", h, w("up"))
        z = torch.square(F.relu(u)) if cfg.activation == "sq_relu" \
            else _gelu(u)
    return torch.einsum("becf,efd->becd", z, w("down"))


def _expert_ffn(params: dict, h: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """h: (B, E, C, d) -> (B, E, C, d), batched over the experts (the
    experts are independent: a slice of them computes what the whole
    batch computes for it)."""
    up = params["up"]
    if up.dtype == cfg.compute_dtype or up.numel() <= CAST_SLICE:
        return _experts(params, h, cfg, slice(None))
    e = up.shape[0]
    step = max(1, CAST_SLICE // up[0].numel())
    return torch.cat([_experts(params, h[:, e0:e0 + step], cfg,
                               slice(e0, e0 + step))
                      for e0 in range(0, e, step)], dim=1)


def _dispatch_combine(params: dict, x: torch.Tensor, slot: torch.Tensor,
                      top_w: torch.Tensor, n_experts: int, cap: int,
                      cfg: ModelConfig) -> torch.Tensor:
    """Every (token, choice) pair of x (B, S, d) into its slot of the
    experts' (n_experts, cap) buffer (slot n_experts * cap: none, the
    dropped pairs' dump row, sliced off), the experts on it, then the
    outputs gathered back (zeros from the dump row), weighted by top_w and
    summed over k: (B, S, d) in the compute dtype."""
    b, s, d = x.shape
    k = top_w.shape[-1]
    dt = cfg.compute_dtype
    tok = x.to(dt).repeat_interleave(k, dim=1)               # (B, S*K, d)
    idx = slot[..., None].expand(b, s * k, d)
    buf = torch.zeros((b, n_experts * cap + 1, d), dtype=dt, device=x.device)
    buf = buf.scatter(1, idx, tok)[:, :n_experts * cap].reshape(
        b, n_experts, cap, d)

    out_buf = _expert_ffn(params, buf, cfg).reshape(b, n_experts * cap, d)

    out_buf = F.pad(out_buf, (0, 0, 0, 1))
    gathered = torch.gather(out_buf, 1, idx)                 # (B, S*K, d)
    w = top_w.reshape(b, s * k, 1).to(dt)
    return (gathered * w).reshape(b, s, k, d).sum(dim=2)


def moe_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
            exact_capacity: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, aux); routing is per batch row.

    ``exact_capacity=True`` (decode and small inference batches) sets
    C = S*K, so no pair is dropped; otherwise Switch-style capacity
    dropping at ``capacity(cfg, S)``.  aux: ``moe_lb_loss`` (the
    load-balance loss), ``moe_z_loss`` (the router z-loss) and
    ``moe_dropped`` (the dropped share of pairs), 0-dim fp32 tensors."""
    e = cfg.moe.num_experts
    cap = capacity(cfg, x.shape[1], exact_capacity)

    logits, probs, top_w, top_i = route(params, x, cfg)
    slot, valid = dispatch_slots(top_i, e, cap)
    y = _dispatch_combine(params, x, slot, top_w, e, cap, cfg)
    if cfg.moe.shared_expert:
        y = y + mlp(params["shared"], x, cfg)

    me = probs.mean(dim=(0, 1))                              # (E,)
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    aux = {"moe_lb_loss": e * torch.sum(me * ce),
           "moe_z_loss": torch.mean(torch.square(
               torch.logsumexp(logits, dim=-1))),
           "moe_dropped": _dropped_share(valid)}
    return y, aux


def moe_mlp_rows(params: dict, x: torch.Tensor, cfg: ModelConfig, *, mesh,
                 seq_axes, batch_axes, experts=None,
                 exact_capacity: bool = False) -> Tuple[torch.Tensor, dict]:
    """The MoE over ranks: x (B, S / n, d) is this rank's shard of its
    batch rows' sequence over ``seq_axes`` (n ranks; whole without them).

    The sequence is gathered (``all_gather_grad``) and the whole rows are
    routed on every rank, the same bits on each, at the capacity of the
    global length.  With ``experts`` = (e0, n) the expert stacks in
    ``params`` are this rank's experts e0 .. e0 + n - 1: the rank
    dispatches only the pairs slotted to them (every other pair goes to
    the dump row, as a dropped one does), runs them, gathers their outputs
    back, weights them and sums over k, and returns its partial sums over
    the whole rows (B, S, d), which the caller sums over the experts'
    ranks.  Without ``experts`` the stacks are whole: it returns the whole
    rows' output.

    The aux terms are statistics over the global batch: each rank sums
    ``probs``, the top-1 one-hot and the squared logsumexp over its own
    rows (its shard of the sequence), and the sums and the token count go
    over the batch and sequence ranks in rank order (``sum_forward``: the
    identity back, so each rank's rows get the gradient of the global
    term) before the means and ``moe_lb_loss``'s product; the kept pairs
    and the pairs are counted over the batch ranks (every sequence rank
    holds the whole rows) and ``moe_dropped`` rounds once, as
    ``_dropped_share``.  A batch left whole on several ranks counts on
    each, in the sums and the counts alike: the means are unchanged."""
    e = cfg.moe.num_experts
    b, s_local, _ = x.shape
    xf = all_gather_grad(x, mesh, seq_axes, 1)
    cap = capacity(cfg, xf.shape[1], exact_capacity)

    logits, probs, top_w, top_i = route(params, xf, cfg)
    slot, valid = dispatch_slots(top_i, e, cap)
    e0, n = experts if experts is not None else (0, e)
    if n < e:
        # this rank's experts' slots, the others' to the dump row
        local = slot - e0 * cap
        slot = torch.where((local >= 0) & (local < n * cap), local, n * cap)
    y = _dispatch_combine(params, xf, slot, top_w, n, cap, cfg)

    own = lambda t: seq_rows(t, mesh, seq_axes, s_local)  # noqa: E731
    lse = torch.logsumexp(own(logits), dim=-1)
    stats = torch.cat([own(probs).sum(dim=(0, 1)),
                       F.one_hot(own(top_i)[..., 0], e).float().sum(
                           dim=(0, 1)),
                       torch.square(lse).sum()[None],
                       lse.new_full((1,), lse.numel())])
    stats = sum_forward(stats, mesh, tuple(batch_axes) + tuple(seq_axes))
    tokens = stats[-1].detach()
    me, ce = stats[:e] / tokens, stats[e:2 * e] / tokens
    counts = axis_sum(torch.stack([valid.sum(), valid.new_tensor(
        valid.numel(), dtype=torch.int64)]), mesh, batch_axes)
    aux = {"moe_lb_loss": e * torch.sum(me * ce),
           "moe_z_loss": stats[2 * e] / tokens,
           "moe_dropped": _dropped_count(counts[0], counts[1])}
    return y, aux


def moe_mlp_tp(params: dict, x: torch.Tensor, cfg: ModelConfig, layout,
               spec: dict, *, exact_capacity: bool = False):
    """The MoE block under the train and serving layout
    (``sharding.TrainLayout``): x is this rank's shard of the residual
    stream (B, S / sp, d), or a decode step's whole token.  The expert
    stacks are this rank's E / tp experts (``("experts", "fsdp", None)``):
    ``moe_mlp_rows`` over the sequence's ranks, its partial sums
    reduce-scattered back to the sequence shards or, for one token, summed
    over ``tp`` (``layout.row_reduce``).  Stacks left whole (E not
    dividing over tp) run every expert on the whole rows, and each rank
    keeps its own.  llama4's shared expert runs as ``mlp_tp``."""
    split = layout.tp_sharded(spec["up"], 0)
    if not split and layout.rules.axes_size(spec["up"][0]) > 1:
        raise NotImplementedError(
            f"{cfg.name}: the expert stacks sharded over {spec['up'][0]!r}, "
            f"not the tp axes {layout.tp_axes}")
    experts = None
    if split:
        n = cfg.moe.num_experts // layout.tp
        experts = (layout.tp_index() * n, n)
    y, aux = moe_mlp_rows(params, x, cfg, mesh=layout.mesh,
                          seq_axes=layout.sp_axes,
                          batch_axes=layout.axes("batch"), experts=experts,
                          exact_capacity=exact_capacity)
    y = layout.row_reduce(y) if split else \
        seq_rows(y, layout.mesh, layout.sp_axes, x.shape[1])
    if cfg.moe.shared_expert:
        y = y + mlp_tp(params["shared"], x, cfg, layout, spec["shared"])
    return y, aux
