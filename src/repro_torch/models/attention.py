"""GQA attention: full/sliding-window, prefill + KV-cache decode, and the
sequence-parallel flash schedules.

Port of ``repro.models.attention``.  Execution paths, chosen as the
reference chooses them:
  * ``decode``  - one query against the KV cache (``_decode_grouped``),
                  plain tensor operations;
  * ``flash``   - the hand-written flash kernel (``ops.flash_attention``,
                  TPU kernel row 8) when ``cfg.attn_impl == "flash"`` and
                  the sequence is longer than ``cfg.attn_chunk``; under
                  autograd its backward recomputes through the chunked
                  path at ``attn_chunk`` (``flash_attention.
                  FlashAttention``, the reference's custom_vjp);
  * ``sharded`` - under axis rules whose sequence axes (``sp``, else
                  ``tp``) span N > 1 ranks, x is this rank's sequence shard
                  and the flash route runs a schedule over those ranks: the
                  ring (``ring_flash_attention``, row 9) when
                  ``use_ring`` holds for the global k/v length, else the
                  all-gather (``sharded_flash_attention``, row 8 at the
                  shard's ``q_base``);
  * ``naive`` / ``chunked`` - scores materialized at once, or an online
                  softmax over ``attn_chunk`` blocks that skips blocks
                  outside the causal/window range; flat heads (k/v
                  repeated to the query heads) without a cache, grouped
                  (B, S, G, R, Dh) queries with one.

Under sequence sharding the reference's predicates see global arrays; each
rank here sees S/N rows, so the global length N * S stands in for S in
each of them.  A global length that does not divide over N never reaches
this layer: ``sharding.local_shard`` refuses it.  The reference's other
routes under a mesh (GSPMD-gathered naive/chunked attention, caches
sharded over ``kv_seq``) are not ported: they raise.

q is (B, S, H, Dh), k and v (B, S, G, Dh); the caches are stacked
(U, B, M, G, Dh) per pattern entry, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.launch.collectives import (all_gather_grad,
                                            reduce_scatter_grad)
from repro_torch.kernels.flash_attention import (ring_flash_attention,
                                                 sharded_flash_attention,
                                                 use_ring)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, trunc_normal
from repro_torch.models.sharding import current_rules, seq_shards

NEG_INF = -1e30


def init_attention(generator, cfg: ModelConfig, device,
                   lead=()) -> dict:
    d = cfg.d_model
    dt = cfg.master_dtype
    scale = d ** -0.5
    lead = tuple(lead)
    return {
        "wq": trunc_normal(generator, lead + (d, cfg.q_flat), scale, dt,
                           device),
        "wk": trunc_normal(generator, lead + (d, cfg.kv_flat), scale, dt,
                           device),
        "wv": trunc_normal(generator, lead + (d, cfg.kv_flat), scale, dt,
                           device),
        "wo": trunc_normal(generator, lead + (cfg.q_flat, d),
                           cfg.q_flat ** -0.5, dt, device),
    }


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_max, G, Dh), or stacked (U, B, ...)
    v: torch.Tensor
    length: torch.Tensor   # () int32, or (U,)


def _block_mask(sq: int, sk: int, off, window: int,
                device=None) -> torch.Tensor:
    """m[i, j] = (j <= i + off) & (j > i + off - window)."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi + off
    if window > 0:
        m &= kj > qi + off - window
    return m


def _softmax_pv(scores, v_op, q_dtype):
    # softmax in fp32, probabilities cast to the compute dtype before the
    # product with v, as the reference does; the product sums in fp32
    probs = torch.softmax(scores, dim=-1).to(q_dtype)
    return v_op(probs.float())


# ---------------------------------------------------------------------------
# grouped (GQA-native) attention cores
# ---------------------------------------------------------------------------

def _naive_grouped(q5, k, v, *, window: int) -> torch.Tensor:
    # q5: (b, sq, g, r, d); k/v: (b, sk, g, d)
    sq, sk = q5.shape[1], k.shape[1]
    scale = q5.shape[-1] ** -0.5
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q5.float(), k.float()) * scale
    mask = _block_mask(sq, sk, 0, window, q5.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    out = _softmax_pv(scores, lambda p: torch.einsum(
        "bgrqk,bkgd->bqgrd", p, v.float()), q5.dtype)
    return out.to(q5.dtype)


def _online_blocks(q, k, v, *, window: int, chunk: int, scores_fn, pv_fn,
                   row_t):
    """The reference's chunked online softmax, shared by the grouped and
    flat layouts: q, k, v padded to a multiple of ``chunk`` along the
    sequence; for each q block, the kv blocks inside the causal/window
    range (the others are skipped), with (m, l) in the scores' layout
    ``(..., chunk, 1)`` and ``row_t`` mapping them to the output layout."""
    s = q.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (torch.cat([t, t.new_zeros((t.shape[0], pad) +
                                             t.shape[2:])], 1)
                   for t in (q, k, v))
    n_blk = q.shape[1] // chunk
    scale = q.shape[-1] ** -0.5
    outs = []
    for qi in range(n_blk):
        q_off = qi * chunk
        qc = q[:, q_off:q_off + chunk]
        m = l = o = None
        for ki in range(n_blk):
            k_off = ki * chunk
            needed = k_off <= q_off
            if window > 0:
                needed &= k_off >= q_off - window - chunk + 1
            if not needed:
                continue
            kc, vc = k[:, k_off:k_off + chunk], v[:, k_off:k_off + chunk]
            s_blk = scores_fn(qc, kc) * scale
            mask = _block_mask(chunk, chunk, q_off - k_off, window, q.device)
            s_blk = s_blk.masked_fill(~mask, NEG_INF)
            if m is None:
                m = torch.full(s_blk.shape[:-1] + (1,), NEG_INF,
                               device=q.device)
                l = torch.zeros_like(m)
                o = torch.zeros(qc.shape, dtype=torch.float32,
                                device=q.device)
            m_new = torch.maximum(m, s_blk.amax(-1, keepdim=True))
            p = torch.exp(s_blk - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1, keepdim=True)
            pv = pv_fn(p.to(q.dtype).float(), vc)
            o = row_t(corr) * o + pv
            m = m_new
        outs.append((o / torch.clamp_min(row_t(l), 1e-30)).to(q.dtype))
    return torch.cat(outs, 1)[:, :s]


def _chunked_grouped(q5, k, v, *, window: int, chunk: int) -> torch.Tensor:
    return _online_blocks(
        q5, k, v, window=window, chunk=chunk,
        scores_fn=lambda qc, kc: torch.einsum(
            "bqgrd,bkgd->bgrqk", qc.float(), kc.float()),
        pv_fn=lambda p, vc: torch.einsum("bgrqk,bkgd->bqgrd", p, vc.float()),
        row_t=lambda t: t[..., 0].permute(0, 3, 1, 2)[..., None])


def _decode_grouped(q5, cache: KVCache, *, window: int) -> torch.Tensor:
    # q5: (b, 1, g, r, d); cache.k: (b, S, g, d)
    s = cache.k.shape[1]
    scale = q5.shape[-1] ** -0.5
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q5.float(),
                          cache.k.float()) * scale
    pos = torch.arange(s, device=q5.device)
    valid = pos < cache.length
    if window > 0:
        valid &= pos >= cache.length - window
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(q5.dtype).float(),
                       cache.v.float())
    l_t = l[..., 0].permute(0, 3, 1, 2)[..., None]
    return (out / torch.clamp_min(l_t, 1e-30)).to(q5.dtype)


# ---------------------------------------------------------------------------
# flat-head core (no cache)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, g, d = k.shape
    return k[:, :, :, None, :].expand(b, s, g, n_rep, d).reshape(
        b, s, g * n_rep, d)


def _naive_flat(q, k, v, *, window: int) -> torch.Tensor:
    sq, sk = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _block_mask(sq, sk, 0, window, q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    out = _softmax_pv(scores, lambda p: torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float()), q.dtype)
    return out.to(q.dtype)


def _chunked_flat(q, k, v, *, window: int, chunk: int) -> torch.Tensor:
    return _online_blocks(
        q, k, v, window=window, chunk=chunk,
        scores_fn=lambda qc, kc: torch.einsum("bqhd,bkhd->bhqk", qc.float(),
                                              kc.float()),
        pv_fn=lambda p, vc: torch.einsum("bhqk,bkhd->bqhd", p, vc.float()),
        row_t=lambda t: t.transpose(1, 2))


# ---------------------------------------------------------------------------
# public layer
# ---------------------------------------------------------------------------

def _write_cache(cache: KVCache, k, v, s: int) -> KVCache:
    """Write this call's k/v into the cache IN PLACE and return the cache
    with its new length.  The reference returns new arrays; updating the
    stacked cache through views saves a copy of every cache (all of
    2·U·B·M·G·Dh elements per pattern entry) on every step.  Prefill
    starts at slot 0, as in the reference."""
    m_len = cache.k.shape[1]
    if s == 1:
        # rolling caches wrap; full caches never reach m_len
        wpos = (cache.length % m_len).long().reshape(1)
        cache.k.index_copy_(1, wpos, k.to(cache.k.dtype))
        cache.v.index_copy_(1, wpos, v.to(cache.v.dtype))
    elif s >= m_len:
        # rolling cache: token t lives at slot t % m_len; the last m_len
        # tokens are a rotation by s % m_len
        cache.k.copy_(torch.roll(k[:, s - m_len:], s % m_len, dims=1))
        cache.v.copy_(torch.roll(v[:, s - m_len:], s % m_len, dims=1))
    else:
        cache.k[:, :s] = k
        cache.v[:, :s] = v
        cache.k[:, s:] = 0
        cache.v[:, s:] = 0
    cache.length.add_(s)
    return cache


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              kind: str, positions: torch.Tensor,
              cache: Optional[KVCache] = None,
              update_cache: bool = False,
              rope_theta: Optional[float] = None):
    """Returns (out, cache). x: (B, S, D).  With ``update_cache`` the cache
    is written in place (see ``_write_cache``) and returned."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    h, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    r = h // g
    window = cfg.window if kind == "local" else 0
    theta = rope_theta if rope_theta is not None else cfg.rope_theta

    q = (x @ params["wq"].to(dt)).reshape(b, s, h, dh)
    k = (x @ params["wk"].to(dt)).reshape(b, s, g, dh)
    v = (x @ params["wv"].to(dt)).reshape(b, s, g, dh)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if cfg.qk_norm:
        q = _qknorm(q, dt)
        k = _qknorm(k, dt)

    # under sequence sharding x holds S / N of the sequence: the
    # predicates below take the global length
    seq_axes, n_seq = seq_shards()
    s_global = n_seq * s
    if n_seq > 1 and cache is not None:
        raise NotImplementedError(
            "caches sharded over the sequence (kv_seq) are not ported yet "
            "(ROADMAP A12.5): the sequence-parallel path runs forward only")
    rolling = cache is not None and window > 0 and cache.k.shape[1] <= window
    if cache is not None and update_cache:
        cache = _write_cache(cache, k, v, s)

    flash_want = (cfg.attn_impl == "flash"
                  and (cache is None or s > 1) and s_global > cfg.attn_chunk)
    if n_seq > 1 and not flash_want:
        raise NotImplementedError(
            f"sequence-parallel attention runs the flash schedules only "
            f"(attn_impl='flash', a global length {s_global} above "
            f"attn_chunk {cfg.attn_chunk}); got attn_impl="
            f"{cfg.attn_impl!r}; the GSPMD routes are ROADMAP A12.6")
    if cache is not None and s == 1:
        # rolling caches enforce the window structurally: no mask needed
        out = _decode_grouped(q.reshape(b, s, g, r, dh), cache,
                              window=0 if rolling else window)
        out = out.reshape(b, s, h, dh)
    elif n_seq > 1:
        # each rank masks at its shard's global offsets.  Short sequences
        # all-gather K/V; from attn_ring_min_sk keys on, the ring keeps
        # them sharded and rotates them past the resident q rows.
        fn = ring_flash_attention if use_ring(
            s_global, n_seq, threshold=cfg.attn_ring_min_sk or None) \
            else sharded_flash_attention
        out = fn(q, k, v, window=window, mesh=current_rules().mesh,
                 seq_axes=seq_axes)
    elif flash_want or cache is None:
        out = _self_attend(q, k, v, cfg, window)
    else:
        q5 = q.reshape(b, s, g, r, dh)
        if cfg.attn_impl == "naive" or s <= cfg.attn_chunk:
            out = _naive_grouped(q5, k, v, window=window)
        else:
            out = _chunked_grouped(q5, k, v, window=window,
                                   chunk=cfg.attn_chunk)
        out = out.reshape(b, s, h, dh)

    out = out.to(dt).reshape(b, s, h * dh)
    return out @ params["wo"].to(dt), cache


def _self_attend(q, k, v, cfg: ModelConfig, window: int) -> torch.Tensor:
    """Causal self-attention of a whole sequence without a cache: the
    flash kernel (row 8) when ``cfg.attn_impl == "flash"`` and the
    sequence is longer than ``attn_chunk``, else naive or chunked over
    flat heads (k/v repeated to q's heads)."""
    s = q.shape[1]
    if cfg.attn_impl == "flash" and s > cfg.attn_chunk:
        return ops.flash_attention(q, k, v, window=window,
                                   chunk=cfg.attn_chunk)
    r = q.shape[2] // k.shape[2]
    kk, vv = _repeat_kv(k, r), _repeat_kv(v, r)
    if cfg.attn_impl == "naive" or s <= cfg.attn_chunk:
        return _naive_flat(q, kk, vv, window=window)
    return _chunked_flat(q, kk, vv, window=window, chunk=cfg.attn_chunk)


def _kv_for_heads(k: torch.Tensor, q_heads: range, rep: int):
    """The KV heads that the query heads ``q_heads`` read (head j reads
    KV head j // rep), as few as keep the grouping (each KV head serving
    an equal run of consecutive q heads), else one a q head."""
    want = [j // rep for j in q_heads]
    lo, hi = want[0], want[-1] + 1
    per = len(want) // (hi - lo)
    if len(want) % (hi - lo) == 0 and \
            want == [lo + i // per for i in range(len(want))]:
        return k[:, :, lo:hi]
    return k[:, :, torch.tensor(want, device=k.device)]


def attention_tp(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 kind: str, layout, spec: dict,
                 rope_theta: Optional[float] = None) -> torch.Tensor:
    """Attention under the train layout (``sharding.TrainLayout``, tp >
    1): x is this rank's shard of the residual stream (B, S / sp, D); the
    sequence is gathered over ``sp``, ``wq`` / ``wk`` / ``wv`` run
    column-parallel to this rank's heads, attention runs over them on the
    whole sequence (rows at global positions, ``q_base`` 0), and ``wo``
    runs row-parallel, its partial sums reduce-scattered back to the
    sequence shards.

    ``wk`` / ``wv`` shard their flat G * Dh dim, not heads: where the KV
    heads divide over ``tp`` this rank's slice holds exactly the KV heads
    its q heads read; otherwise (G < tp, say) K/V are gathered over
    ``tp`` before this rank's q heads pick theirs, and a ``wk`` / ``wv``
    left whole (G * Dh not dividing) projects this rank's own rows, then
    gathers the sequence.  With ``attn_impl="flash"`` the attention is row
    8 through ``ops.flash_attention`` (kernel forward, recompute
    backward).  The reference routes flash under tp > 1 to its
    sequence-sharded ``shard_map`` schedule instead, whose backward is
    ROADMAP A12.4; the function computed is the same."""
    dt = cfg.compute_dtype
    mesh, tp, sp_axes = layout.mesh, layout.tp, layout.sp_axes
    h, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if h % tp:
        raise NotImplementedError(
            f"{cfg.name}: {h} heads over tp = {tp}: the train layout runs "
            f"attention over each rank's heads; the reference's "
            f"sequence-sharded GSPMD route is ROADMAP A12.6")
    hl = h // tp
    heads = range(layout.tp_index() * hl, (layout.tp_index() + 1) * hl)
    window = cfg.window if kind == "local" else 0
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    xf = all_gather_grad(x, mesh, sp_axes, 1)
    b, s, _ = xf.shape
    positions = torch.arange(s, device=x.device)[None, :]

    def kv(name):
        w = params[name].to(dt)
        if not layout.tp_sharded(spec[name], -1):
            t = all_gather_grad(x @ w, mesh, sp_axes, 1)
        elif g % tp == 0:
            return (xf @ w).reshape(b, s, g // tp, dh)
        else:
            t = all_gather_grad(xf @ w, mesh, layout.tp_axes, 2)
        return _kv_for_heads(t.reshape(b, s, g, dh), heads, h // g)

    q = (xf @ params["wq"].to(dt)).reshape(b, s, hl, dh)
    k, v = kv("wk"), kv("wv")
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if cfg.qk_norm:
        q = _qknorm(q, dt)
        k = _qknorm(k, dt)
    out = _self_attend(q, k, v, cfg, window)
    out = out.to(dt).reshape(b, s, hl * dh) @ params["wo"].to(dt)
    return reduce_scatter_grad(out, mesh, sp_axes, 1)


def _qknorm(q: torch.Tensor, dt) -> torch.Tensor:
    n = torch.rsqrt(q.float().square().mean(-1, keepdim=True) + 1e-6)
    return (q.float() * n).to(dt)
