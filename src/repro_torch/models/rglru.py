"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro.models.rglru``:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The train and prefill path scans in chunks of 256 steps: inside a chunk
a log-depth scan follows ``lax.associative_scan``'s odd/even recursion
(the reference's order of products and sums), all chunks at once, and a
short loop over the chunks carries h across them
(``_chunked_linear_scan``).  Decode is one step with O(width)
state.  The block: x -> [linear -> conv1d(4) -> RG-LRU] * gelu(linear)
-> linear out.  The gates compute in fp32 under any compute dtype.  Under
the train and serving layout ``rglru_block_tp`` runs a rank's share of the
width over ``tp`` (the reference's ``shard(x, "batch", None, "tp")``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.collectives import all_gather_grad
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _gelu, trunc_normal
from repro_torch.models.sharding import seq_rows

C_FACTOR = 8.0
SCAN_CHUNK = 256


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, W) fp32
    conv: torch.Tensor    # (B, d_conv-1, W)
    length: torch.Tensor  # () int32


def init_rglru(generator, cfg: ModelConfig, device, lead=()) -> dict:
    d = cfg.d_model
    w = cfg.rnn_width or d
    dt = cfg.master_dtype
    lead = tuple(lead)
    # Lambda so that a^c lies in [0.9, 0.999] at r = 1 (Griffin app. A)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, dtype=torch.float32, device=device)) / C_FACTOR))
    return {
        "in_x": trunc_normal(generator, lead + (d, w), d ** -0.5, dt, device),
        "in_gate": trunc_normal(generator, lead + (d, w), d ** -0.5, dt,
                                device),
        "conv_w": trunc_normal(generator, lead + (4, w), 0.3, dt, device),
        "conv_b": torch.zeros(lead + (w,), dtype=dt, device=device),
        "w_a": trunc_normal(generator, lead + (w, w), w ** -0.5, dt, device),
        "b_a": torch.zeros(lead + (w,), dtype=torch.float32, device=device),
        "w_i": trunc_normal(generator, lead + (w, w), w ** -0.5, dt, device),
        "b_i": torch.zeros(lead + (w,), dtype=torch.float32, device=device),
        "lam": lam.expand(lead + (w,)).contiguous(),
        "out": trunc_normal(generator, lead + (w, d), w ** -0.5, dt, device),
    }


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even may be one
    longer)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1) if even.shape[1] > n \
        else both


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``lax.associative_scan(combine, (a, b), axis=1)`` for the linear
    recurrence's combine, in its odd/even recursion: the same products
    and sums in the same order, log2(L) levels deep."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan the halves, then fill in the evens
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _chunked_linear_scan(a: torch.Tensor, bb: torch.Tensor,
                         h0: torch.Tensor,
                         chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, chunked: the log-depth scan
    inside chunks of ``chunk`` steps (the working set is log Q * B*Q*W, not
    log L * B*L*W).  The chunks' scans run together, each from a zero
    carry, giving every step's (A_t, B_t) = (a_0 ... a_t, h_t from 0);
    then one pass over the chunks carries h into each, h_t = B_t + A_t h.
    The reference folds the carry into the chunk's first b before its
    scan: the same recurrence, its carry term rounded in another order,
    and L/Q times fewer launches."""
    b, l, w = a.shape
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        # padded steps: a = 1, b = 0 keep the carry unchanged
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        bb = F.pad(bb, (0, 0, 0, pad))
    nc = a.shape[1] // q
    prod, local = associative_scan(a.reshape(b * nc, q, w),
                                   bb.reshape(b * nc, q, w))
    prod, local = prod.reshape(b, nc, q, w), local.reshape(b, nc, q, w)
    h, starts = h0, []
    for c in range(nc):
        starts.append(h)
        h = prod[:, c, -1] * h + local[:, c, -1]
    hh = local + prod * torch.stack(starts, dim=1)[:, :, None]
    return hh.reshape(b, nc * q, w)[:, :l]


def _conv1d(u, w, b, prev=None):
    width = w.shape[0]
    if prev is None:
        u_pad = F.pad(u, (0, 0, width - 1, 0))
    else:
        u_pad = torch.cat([prev.to(u.dtype), u], dim=1)
    l = u.shape[1]
    out = sum(u_pad[:, i:i + l, :] * w[i][None, None] for i in range(width))
    return out + b[None, None]


def _gates(params: dict, x: torch.Tensor, x_own=None):
    """x: (..., W) fp32 -> (a, gated input), fp32, for the channels of
    ``w_a`` / ``w_i``'s columns (every channel, or under tp a rank's,
    whose inputs ``x_own`` are)."""
    x_own = x if x_own is None else x_own
    r = torch.sigmoid(x @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(x @ params["w_i"].float() + params["b_i"])
    log_a = -C_FACTOR * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * \
        (i * x_own)
    return a, gated


def rglru_block(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[RGLRUState] = None,
                update_state: bool = False):
    """u: (B, L, d_model) -> (out, new_state)."""
    dt_c = cfg.compute_dtype
    b, l, d = u.shape
    w = cfg.rnn_width or d
    conv_w, conv_b = params["conv_w"].to(dt_c), params["conv_b"].to(dt_c)

    gate = _gelu(u @ params["in_gate"].to(dt_c))
    x = u @ params["in_x"].to(dt_c)

    if state is not None and l == 1:
        xc = _conv1d(x, conv_w, conv_b, prev=state.conv)
        new_conv = torch.cat([state.conv.to(dt_c), x], dim=1)[:, 1:]
        a, gated = _gates(params, xc[:, 0].float())
        h = a * state.h + gated                       # (B, W)
        y = h[:, None].to(dt_c)
        new_state = RGLRUState(h=h, conv=new_conv, length=state.length + 1)
    else:
        xc = _conv1d(x, conv_w, conv_b)
        a, gated = _gates(params, xc.float())         # (B, L, W)
        h0 = state.h if state is not None else torch.zeros(
            (b, w), dtype=torch.float32, device=u.device)
        hh = _chunked_linear_scan(a, gated, h0)
        y = hh.to(dt_c)                               # (B, L, W)
        new_state = None
        if update_state:
            width = conv_w.shape[0]
            conv_tail = x[:, -(width - 1):] if l >= width - 1 else \
                F.pad(x, (0, 0, width - 1 - l, 0))
            length = (state.length if state is not None else 0) + l
            new_state = RGLRUState(h=hh[:, -1].float(), conv=conv_tail,
                                   length=length)

    y = y * gate
    return y @ params["out"].to(dt_c), new_state


def rglru_block_tp(params: dict, u: torch.Tensor, cfg: ModelConfig, layout,
                   spec: dict, *, state: Optional[RGLRUState] = None,
                   update_state: bool = False):
    """The RG-LRU block under the train and serving layout
    (``sharding.TrainLayout``) with its width over ``tp``: u is this
    rank's shard of the residual stream (B, L / sp, D), or a decode step's
    whole token; returns (this rank's part of the output, the new state).

    The sequence is gathered over ``sp``; ``in_x`` and ``in_gate`` run
    column-parallel to the rank's W / tp channels, and the conv (per
    channel) on them.  The gates contract the conv'd x over every channel
    (``w_a`` / ``w_i`` column-split, ``(None, "tp")``): it is gathered
    over ``tp`` first.  The scan runs on the rank's channels; the
    row-parallel ``out``'s partial sums go through ``layout.row_reduce``.
    The state's h holds the rank's channels (``cache_pspecs``), its conv
    state every channel (gathered x).  A width that does not divide over
    ``tp`` leaves the leaves whole: every rank of ``tp`` runs the whole
    block and keeps its own rows."""
    dt_c = cfg.compute_dtype
    mesh, tpx = layout.mesh, layout.tp_axes
    w = cfg.rnn_width or cfg.d_model
    uf = all_gather_grad(u, mesh, layout.sp_axes, 1)
    if w % layout.tp:
        out, new_state = rglru_block(layout.gather_tp(params, spec), uf, cfg,
                                     state=state, update_state=update_state)
        return seq_rows(out, mesh, layout.sp_axes, u.shape[1]), new_state
    wl = w // layout.tp
    ch = slice(layout.tp_index() * wl, (layout.tp_index() + 1) * wl)
    b, l, _ = uf.shape
    conv_w, conv_b = params["conv_w"].to(dt_c), params["conv_b"][ch].to(dt_c)
    gp = {"w_a": params["w_a"], "w_i": params["w_i"],
          "b_a": params["b_a"][ch], "b_i": params["b_i"][ch],
          "lam": params["lam"][ch]}

    gate = _gelu(uf @ params["in_gate"].to(dt_c))
    x = uf @ params["in_x"].to(dt_c)
    every = lambda t: all_gather_grad(t, mesh, tpx, t.ndim - 1)  # noqa: E731

    if state is not None and l == 1:
        xc = _conv1d(x, conv_w, conv_b, prev=state.conv[..., ch])
        new_conv = torch.cat([state.conv.to(dt_c), every(x)], dim=1)[:, 1:]
        xo = xc[:, 0].float()
        a, gated = _gates(gp, every(xo), xo)
        h = a * state.h + gated                       # (B, W / tp)
        y = h[:, None].to(dt_c)
        new_state = RGLRUState(h=h, conv=new_conv, length=state.length + 1)
    else:
        xc = _conv1d(x, conv_w, conv_b)
        xo = xc.float()
        a, gated = _gates(gp, every(xo), xo)          # (B, L, W / tp)
        h0 = state.h if state is not None else torch.zeros(
            (b, wl), dtype=torch.float32, device=u.device)
        hh = _chunked_linear_scan(a, gated, h0)
        y = hh.to(dt_c)
        new_state = None
        if update_state:
            width = conv_w.shape[0]
            conv_tail = x[:, -(width - 1):] if l >= width - 1 else \
                F.pad(x, (0, 0, width - 1 - l, 0))
            length = (state.length if state is not None else 0) + l
            new_state = RGLRUState(h=hh[:, -1].float(), conv=every(conv_tail),
                                   length=length)

    y = y * gate
    return layout.row_reduce(y @ params["out"].to(dt_c)), new_state
