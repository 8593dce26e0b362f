"""Mamba-2 SSD (state-space duality) block: chunked train path + O(1) decode.

Port of ``repro.models.ssm``.  The train path is the SSD algorithm: the
sequence is split into chunks of Q tokens, the within-chunk term is a
masked-decay quadratic form (batched matmuls), and a sequential loop over
the L/Q chunks carries the (h, p, n) state (the reference's ``lax.scan``).
Decode: h_new = exp(dt*A) h + dt * B x; y = C.h + D x, with a rolling conv
state of width d_conv - 1.  The state is (B, H, P, N), constant in the
sequence length.

Under the train and serving layout ``ssm_block_tp`` runs a rank's heads
over ``tp`` (the reference's ``shard(x, "batch", None, "tp", None)``).

Behaviours of the reference kept as they are: a prefill (L > 1) starts
the SSD from a zero state even when it is given one; a prefill of one
token with a state takes the recurrent branch; a conv tail shorter than
d_conv - 1 tokens is padded with zeros in front.  One is not: where
the within-chunk decay overflows, the reference's gradient is NaN and
this one is finite (``_ssd_chunked``); the forward is the same.

``jnp`` promotes a mixed-dtype product to the wider dtype, and the train
step's compute-dtype copy holds the fp32-by-design leaves (``a_log``,
``dt_bias``, ``d_skip``) in bf16 when the masters are fp32: elementwise
torch ops promote the same way, and matmuls cast as the promotion would.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.collectives import all_gather_grad, sum_both
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import trunc_normal
from repro_torch.models.sharding import seq_rows


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_in + 2*n) rolling conv input
    h: torch.Tensor       # (B, H, P, N) fp32 ssm state
    length: torch.Tensor  # () int32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.d_state


def init_ssm(generator, cfg: ModelConfig, device, lead=()) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, h, p, n = _dims(cfg)
    dt = cfg.master_dtype
    lead = tuple(lead)
    conv_ch = d_in + 2 * n

    # dt_bias: softplus^-1 of a log-uniform draw in [1e-3, 1e-1]
    u = torch.empty(lead + (h,), dtype=torch.float32, device=device)
    if u.device.type != "meta":
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    dt_bias = torch.log(torch.expm1(torch.exp(u)))
    return {
        # order: [z (gate), x, B, C, dt]
        "in_proj": trunc_normal(generator, lead + (d, 2 * d_in + 2 * n + h),
                                d ** -0.5, dt, device),
        "conv_w": trunc_normal(generator, lead + (s.d_conv, conv_ch), 0.3,
                               dt, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=device)).expand(
                lead + (h,)).contiguous(),
        "dt_bias": dt_bias,
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32, device=device),
        "norm_scale": torch.zeros(lead + (d_in,), dtype=dt, device=device),
        "out_proj": trunc_normal(generator, lead + (d_in, d), d_in ** -0.5,
                                 dt, device),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. u: (B, L, C); w: (W, C); prev: (B, W-1, C)."""
    width = w.shape[0]
    if prev is None:
        u_pad = F.pad(u, (0, 0, width - 1, 0))
    else:
        u_pad = torch.cat([prev.to(u.dtype), u], dim=1)
    l = u.shape[1]
    out = sum(u_pad[:, i:i + l, :] * w[i][None, None] for i in range(width))
    return out + b[None, None]


def ssm_block(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[SSMState] = None, update_state: bool = False):
    """u: (B, L, d_model) -> (out, new_state)."""
    d_in, h, p, n = _dims(cfg)
    dt_c = cfg.compute_dtype

    zxbcdt = u @ params["in_proj"].to(dt_c)
    z, xbc_dt = zxbcdt[..., :d_in], zxbcdt[..., d_in:]
    xbc = xbc_dt[..., :d_in + 2 * n]
    dt_raw = xbc_dt[..., d_in + 2 * n:]
    y, new_state = _heads(params, xbc, xbc, dt_raw, params["conv_w"],
                          params["conv_b"], cfg, state=state,
                          update_state=update_state)

    # gated RMSNorm, then the out-projection
    yf = y.float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    y = _gated(yf, var, z, params["norm_scale"], cfg)
    return y @ params["out_proj"].to(dt_c), new_state


def ssm_block_tp(params: dict, u: torch.Tensor, cfg: ModelConfig, layout,
                 spec: dict, *, state: Optional[SSMState] = None,
                 update_state: bool = False):
    """The SSM block under the train and serving layout
    (``sharding.TrainLayout``) with its heads over ``tp``: u is this
    rank's shard of the residual stream (B, L / sp, D), or a decode step's
    whole token; returns (this rank's part of the output, the new state).

    The sequence is gathered over ``sp``.  ``in_proj`` is whole
    (``("fsdp", None)``): each rank projects its heads' z, x and dt
    columns and B, C (every head's); the packed x | B | C conv taps
    (``conv_w``, ``(None, "tp")``, cut at C / tp channels, not on a head
    boundary) are gathered and the rank's channels taken (the backward
    reduce-scatters their gradient back to the shards); ``a_log``,
    ``dt_bias``, ``d_skip`` and ``norm_scale`` are whole and sliced to
    the rank's heads.  The SSD runs on the rank's heads over the whole
    sequence; the gated RMSNorm takes the fp32 sum of squares over every
    head, summed over ``tp`` in rank order (``sum_both``: each rank's
    norm is its own work, so the gradient of the sum is summed too); the
    row-parallel ``out_proj``'s partial sums go through
    ``layout.row_reduce``.  With a state (serving) every rank projects
    every channel of x | B | C, for the conv state, which is whole; h
    holds the rank's heads (``cache_pspecs``).  Heads that do not divide
    over ``tp`` run the whole block on every rank of ``tp`` (the leaves
    gathered), each keeping its own rows."""
    d_in, h, p, n = _dims(cfg)
    mesh, tp = layout.mesh, layout.tp
    if h % tp:
        out, new_state = ssm_block(
            layout.gather_tp(params, spec),
            all_gather_grad(u, mesh, layout.sp_axes, 1), cfg, state=state,
            update_state=update_state)
        return seq_rows(out, mesh, layout.sp_axes, u.shape[1]), new_state
    dt_c = cfg.compute_dtype
    hl = h // tp
    dl = hl * p
    me = layout.tp_index()
    heads = slice(me * hl, (me + 1) * hl)
    chans = slice(me * dl, (me + 1) * dl)
    xs = slice(d_in + me * dl, d_in + (me + 1) * dl)
    bc = slice(2 * d_in, 2 * d_in + 2 * n)
    dts = slice(2 * d_in + 2 * n + me * hl, 2 * d_in + 2 * n + (me + 1) * hl)

    def own(t):
        """The rank's channels of a packed x | B | C (last dim)."""
        return torch.cat([t[..., chans], t[..., d_in:]], -1)

    uf = all_gather_grad(u, mesh, layout.sp_axes, 1)
    w = params["in_proj"].to(dt_c)
    if state is None:
        zxbcdt = uf @ torch.cat([w[:, chans], w[:, xs], w[:, bc], w[:, dts]],
                                1)
        z, xbc = zxbcdt[..., :dl], zxbcdt[..., dl:2 * dl + 2 * n]
        dt_raw, xbc_all = zxbcdt[..., 2 * dl + 2 * n:], None
    else:
        zxbcdt = uf @ w
        z, dt_raw = zxbcdt[..., chans], zxbcdt[..., dts]
        xbc_all = zxbcdt[..., d_in:2 * d_in + 2 * n]
        xbc = own(xbc_all)
    conv_w = params["conv_w"]
    if layout.tp_sharded(spec["conv_w"], 1):
        conv_w = all_gather_grad(conv_w, mesh, layout.tp_axes, 1)
    y, new_state = _heads(params, xbc, xbc_all, dt_raw, own(conv_w),
                          own(params["conv_b"]), cfg, state=state,
                          update_state=update_state, heads=heads, own=own)

    yf = y.float()
    sq = sum_both(torch.square(yf).sum(-1, keepdim=True), mesh,
                  layout.tp_axes)
    y = _gated(yf, sq / d_in, z, params["norm_scale"][chans], cfg)
    return layout.row_reduce(y @ params["out_proj"].to(dt_c)), new_state


def _gated(yf, var, z, norm_scale, cfg: ModelConfig) -> torch.Tensor:
    """The gated RMSNorm of yf (fp32) given its mean square ``var``."""
    yf = yf * torch.rsqrt(var + cfg.norm_eps)
    yf = yf * (1.0 + norm_scale.float())
    return (yf * F.silu(z.float())).to(cfg.compute_dtype)


def _heads(params: dict, xbc, xbc_all, dt_raw, conv_w, conv_b,
           cfg: ModelConfig, *, state: Optional[SSMState],
           update_state: bool, heads: slice = slice(None), own=None):
    """The conv and the SSD (or the recurrent step) of the heads
    ``heads``: xbc (B, L, x | B | C) holds their x channels and B, C
    (``own`` of every channel; None: all of them); ``conv_w`` / ``conv_b``
    are those channels' taps; ``dt_raw`` (B, L, heads); ``xbc_all`` every
    channel (the conv state's); ``state``'s h holds those heads.  Returns
    (y (B, L, heads * P) in the compute dtype, the new state: the conv
    state of every channel, h of those heads)."""
    p, n = cfg.ssm.head_dim, cfg.ssm.d_state
    dt_c = cfg.compute_dtype
    b, l, _ = xbc.shape
    dl = xbc.shape[-1] - 2 * n
    hl = dl // p
    conv_w, conv_b = conv_w.to(dt_c), conv_b.to(dt_c)
    width = conv_w.shape[0]

    recurrent = state is not None and l == 1
    if recurrent:
        new_conv = torch.cat([state.conv.to(dt_c), xbc_all], dim=1)[:, 1:]
        prev = state.conv if own is None else own(state.conv)
        xbc_c = _causal_conv(xbc, conv_w, conv_b, prev=prev)
    else:
        xbc_c = _causal_conv(xbc, conv_w, conv_b)
    xbc_c = F.silu(xbc_c)
    x = xbc_c[..., :dl].reshape(b, l, hl, p)
    bmat = xbc_c[..., dl:dl + n]
    cmat = xbc_c[..., dl + n:]

    a = -torch.exp(params["a_log"][heads])                    # (H,) negative
    dt = F.softplus(dt_raw.float() + params["dt_bias"][heads][None, None])
    d_skip = params["d_skip"][heads]

    if recurrent:
        da = torch.exp(dt[:, 0] * a[None])                    # (B, H)
        xb = torch.einsum("bhp,bn->bhpn", dt[:, 0, :, None] *
                          x[:, 0].float(), bmat[:, 0].float())
        h_new = state.h * da[..., None, None] + xb
        y = torch.einsum("bhpn,bn->bhp", h_new, cmat[:, 0].float())
        y = y + d_skip[None, :, None] * x[:, 0].float()
        y = y[:, None].to(dt_c).reshape(b, 1, dl)
        new_state = SSMState(conv=new_conv.to(dt_c), h=h_new,
                             length=state.length + 1)
    else:
        y, h_last = _ssd_chunked(x, dt, a, bmat, cmat, cfg)
        y = y + d_skip[None, None, :, None] * x.float()
        y = y.reshape(b, l, dl).to(dt_c)
        new_state = None
        if update_state:
            conv_tail = xbc_all[:, -(width - 1):] if l >= width - 1 else \
                F.pad(xbc_all, (0, 0, width - 1 - l, 0))
            length = (state.length if state is not None else 0) + l
            new_state = SSMState(conv=conv_tail.to(dt_c), h=h_last,
                                 length=length)
    return y, new_state


def _ssd_chunked(x, dt, a, bmat, cmat, cfg: ModelConfig):
    """The SSD algorithm. x: (B, L, H, P) any float; dt: (B, L, H) fp32;
    a: (H,); bmat/cmat: (B, L, N).  Returns (y (B, L, H, P) fp32, the
    final state (B, H, P, N) fp32), starting from a zero state."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    q = min(cfg.ssm.chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    lc = x.shape[1]
    nc = lc // q
    xf = x.float().reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bf = bmat.float().reshape(b, nc, q, n)
    cf = cmat.float().reshape(b, nc, q, n)

    da = dtc * a[None, None, None]                   # (B, C, Q, H)
    cs = torch.cumsum(da, dim=2)                     # inclusive cumsum
    xbar = xf * dtc[..., None]                       # (B, C, Q, H, P)

    # the within-chunk (diagonal) term
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)     # (B, C, Q, Q)
    ii = torch.arange(q, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # exp(cs_i - cs_j) above the diagonal is masked, but can overflow to
    # inf, whose product with the masked gradient's zero is NaN in the
    # backward (the reference's is): the exponent is masked first, so
    # those entries are exp(-inf) = 0, and the kept ones are unchanged
    seg_ij = torch.where(mask, cs[:, :, :, None] - cs[:, :, None, :],
                         -torch.inf)
    decay = torch.exp(seg_ij)                        # (B, C, Qi, Qj, H)
    m = torch.where(mask, cb[..., None] * decay, 0.0)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", m, xbar)

    # chunk states: S_c = sum_j B_j xbar_j exp(cs_last - cs_j)
    seg = torch.exp(cs[:, :, -1:, :] - cs)           # (B, C, Q, H)
    states = torch.einsum("bcjn,bcjhp->bchpn", bf, xbar * seg[..., None])

    # the inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(cs[:, :, -1, :])         # (B, C, H)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)            # (B, C, H, P, N)

    # off-diagonal: y_off_i = C_i . H_prev * exp(cs_i)
    y_off = torch.einsum("bcin,bchpn->bcihp", cf, h_prevs) * \
        torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(b, lc, h, p)[:, :l]
    return y, hstate
