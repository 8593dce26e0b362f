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
                  ``tp``) span N > 1 ranks, x is this rank's sequence shard:
                  the flash route runs a schedule over those ranks, the
                  ring (``ring_flash_attention``, row 9) when ``use_ring``
                  holds for the global k/v length, else the all-gather
                  (``sharded_flash_attention``, row 8 at the shard's
                  ``q_base``); the naive and chunked routes gather K/V
                  and run the grouped cores on this rank's q rows at
                  their global offset (the reference's GSPMD route);
  * ``naive`` / ``chunked`` - scores materialized at once, or an online
                  softmax over ``attn_chunk`` blocks that skips blocks
                  outside the causal/window range; flat heads (k/v
                  repeated to the query heads) without a cache, grouped
                  (B, S, G, R, Dh) queries with one or on a rank's rows.

Under sequence sharding the reference's predicates see global arrays; each
rank here sees S/N rows, so the global length N * S stands in for S in
each of them.  A global length that does not divide over N never reaches
this layer: ``sharding.local_shard`` refuses it.  Every route is
differentiable: row 8 at any ``q_base`` recomputes its backward through
the chunked core (``FlashAttention``), the ring runs the reference's
reverse ring (``RingFlashAttention``), and the gathers' backward
reduce-scatters dK/dV to their shards.

Under the train layout (``sharding.TrainLayout``) ``attention_tp`` runs a
rank's heads over the whole sequence where the heads divide over ``tp``,
and otherwise the reference's sequence-sharded route: every head on this
rank's rows of the sequence; with a cache (serving,
``make_serve_steps(cfg, rules)``) the cache is this rank's shard of the
reference's ``cache_pspecs``: its KV heads over ``tp``, or its slots over
``kv_seq`` / ``long_seq`` (``KVSlice``), and a decode step over a
sequence-sliced cache combines the ranks' partial softmaxes.

q is (B, S, H, Dh), k and v (B, S, G, Dh); the caches are stacked
(U, B, M, G, Dh) per pattern entry, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.launch.collectives import (all_gather_grad,
                                            all_gather_many, max_nograd,
                                            reshard_grad, sum_forward)
from repro_torch.kernels.flash_attention import (ring_flash_attention,
                                                 sharded_flash_attention,
                                                 use_ring)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, trunc_normal
from repro_torch.models.sharding import (_axes, current_rules, seq_rows,
                                         seq_shards, shard_bounds)

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


class KVSlice(NamedTuple):
    """Where this rank's shard of a KV cache sits in the global cache: the
    global slot count ``m``, this rank's first slot ``lo``, the mesh axes
    the slots are sliced over (``()``: whole), and whether the KV heads
    are sliced over ``tp`` instead."""
    m: int
    lo: int
    axes: tuple
    heads: bool


def kv_slice(shape, spec, mesh) -> KVSlice:
    """The ``KVSlice`` of a stacked (U, B, M, G, Dh) cache of global
    ``shape`` cut by ``spec`` (``cache_pspecs``') on ``mesh``."""
    return KVSlice(m=shape[2], lo=shard_bounds(shape, spec, mesh)[2][0],
                   axes=_axes(spec[2]), heads=spec[3] is not None)


# slots of a cache scored at once in a decode step: a chunk's fp32 copy
# of K (or V) holds at most this many elements
DECODE_CHUNK_ELEMS = 1 << 26


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

def _naive_grouped(q5, k, v, *, window: int, q_base: int = 0) -> torch.Tensor:
    # q5: (b, sq, g, r, d), rows at q_base + i; k/v: (b, sk, g, d)
    sq, sk = q5.shape[1], k.shape[1]
    scale = q5.shape[-1] ** -0.5
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q5.float(), k.float()) * scale
    mask = _block_mask(sq, sk, q_base, window, q5.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    out = _softmax_pv(scores, lambda p: torch.einsum(
        "bgrqk,bkgd->bqgrd", p, v.float()), q5.dtype)
    return out.to(q5.dtype)


def _online_blocks(q, k, v, *, window: int, chunk: int, scores_fn, pv_fn,
                   row_t, q_base: int = 0):
    """The reference's chunked online softmax, shared by the grouped and
    flat layouts: q and k/v each padded to a multiple of ``chunk`` along
    the sequence; for each q block (rows at global positions ``q_base +
    i``), the kv blocks inside the causal/window range (the others are
    skipped), with (m, l) in the scores' layout ``(..., chunk, 1)`` and
    ``row_t`` mapping them to the output layout.  q_base 0 with equal
    lengths is causal self-attention, the reference's only case; a rank's
    rows of the sequence take their offset against the whole K/V (rows
    within the keys, ``q_base + Sq <= Sk``, so a padded key is visible to
    padded rows alone)."""
    sq, sk = q.shape[1], k.shape[1]
    chunk = min(chunk, max(sq, sk))
    pad_q, pad_k = (-sq) % chunk, (-sk) % chunk
    if pad_q:
        q = torch.cat([q, q.new_zeros((q.shape[0], pad_q) + q.shape[2:])], 1)
    if pad_k:
        k, v = (torch.cat([t, t.new_zeros((t.shape[0], pad_k) +
                                          t.shape[2:])], 1) for t in (k, v))
    n_q, n_k = q.shape[1] // chunk, k.shape[1] // chunk
    scale = q.shape[-1] ** -0.5
    outs = []
    for qi in range(n_q):
        q_off = q_base + qi * chunk
        qc = q[:, qi * chunk:(qi + 1) * chunk]
        m = l = o = None
        for ki in range(n_k):
            k_off = ki * chunk
            needed = k_off <= q_off + chunk - 1
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
    return torch.cat(outs, 1)[:, :sq]


def _chunked_grouped(q5, k, v, *, window: int, chunk: int,
                     q_base: int = 0) -> torch.Tensor:
    return _online_blocks(
        q5, k, v, window=window, chunk=chunk, q_base=q_base,
        scores_fn=lambda qc, kc: torch.einsum(
            "bqgrd,bkgd->bgrqk", qc.float(), kc.float()),
        pv_fn=lambda p, vc: torch.einsum("bgrqk,bkgd->bqgrd", p, vc.float()),
        row_t=lambda t: t[..., 0].permute(0, 3, 1, 2)[..., None])


def _decode_grouped(q5, cache: KVCache, *, window: int,
                    sl: Optional[KVSlice] = None, mesh=None) -> torch.Tensor:
    """One query a row (q5: (b, 1, g, r, d)) against the cache (b, M, g,
    d), or with ``sl`` against this rank's slots ``[lo, lo + M_loc)`` of a
    cache sliced over ``sl.axes`` (every rank of them holding the same
    batch rows and all KV heads).  Each slot is scored at its global
    position, a chunk of slots at a time into one fp32 score tensor (no
    whole fp32 copy of a long cache); the max is taken over the ranks
    before the exponent, so p has the unsliced cache's bits; p is cast to
    the compute dtype before the PV product; l and the PV partial sums
    are summed over the ranks in rank order."""
    b, _, g, r, d = q5.shape
    m_loc = cache.k.shape[1]
    scale = d ** -0.5
    chunk = max(1, DECODE_CHUNK_ELEMS // max(1, b * g * d))
    qf = q5.float()
    scores = torch.empty((b, g, r, 1, m_loc), dtype=torch.float32,
                         device=q5.device)
    for c0 in range(0, m_loc, chunk):
        scores[..., c0:c0 + chunk] = torch.einsum(
            "bqgrd,bkgd->bgrqk", qf,
            cache.k[:, c0:c0 + chunk].float()) * scale
    lo, axes = (0, ()) if sl is None else (sl.lo, sl.axes)
    pos = lo + torch.arange(m_loc, device=q5.device)
    valid = pos < cache.length
    if window > 0:
        valid &= pos >= cache.length - window
    scores = scores.masked_fill(~valid, NEG_INF)
    m = max_nograd(scores.amax(-1, keepdim=True), mesh, axes)
    p = torch.exp(scores - m)
    l = sum_forward(p.sum(-1, keepdim=True), mesh, axes)
    p = p.to(q5.dtype).float()
    out = torch.zeros((b, 1, g, r, d), dtype=torch.float32,
                      device=q5.device)
    for c0 in range(0, m_loc, chunk):
        out += torch.einsum("bgrqk,bkgd->bqgrd", p[..., c0:c0 + chunk],
                            cache.v[:, c0:c0 + chunk].float())
    out = sum_forward(out, mesh, axes)
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

def _write_cache(cache: KVCache, k, v, s: int, lo: int = 0,
                 m: Optional[int] = None) -> KVCache:
    """Write this call's k/v into the cache IN PLACE and return the cache
    with its new length.  The reference returns new arrays; updating the
    stacked cache through views saves a copy of every cache (all of
    2·U·B·M·G·Dh elements per pattern entry) on every step.  Prefill
    starts at slot 0, as in the reference.

    The cache may be this rank's slots ``[lo, lo + M_loc)`` of a cache of
    ``m`` slots sliced over the sequence (``m`` None: the whole cache),
    given k/v for the KV heads it holds: prefill cuts the rank's slots
    out of the global cache's content (the prompt at slots [0, s), zeros
    after it; a rolling cache's slot t % m after the roll); a decode
    step's token lands at slot ``length % m``, written by the rank that
    owns it alone (a masked write, no host sync).  ``length`` stays
    global."""
    m_loc = cache.k.shape[1]
    m = m_loc if m is None else m
    for c, t in ((cache.k, k), (cache.v, v)):
        t = t.to(c.dtype)
        if s == 1:
            # rolling caches wrap; full caches never reach m
            at = (cache.length % m).long() - lo
            idx = at.clamp(0, m_loc - 1).reshape(1)
            if m_loc < m:
                own = (at >= 0) & (at < m_loc)
                t = torch.where(own, t, c.index_select(1, idx))
            c.index_copy_(1, idx, t)
        elif s >= m:
            # rolling cache: token t lives at slot t % m; the last m
            # tokens are a rotation by s % m
            c.copy_(torch.roll(t[:, s - m:], s % m, dims=1)
                    .narrow(1, lo, m_loc))
        else:
            n = max(0, min(s, lo + m_loc) - lo)
            c[:, :n] = t[:, lo:lo + n]
            c[:, n:] = 0
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
            "the sequence-parallel forward (use_rules) runs without a "
            "cache: serve sharded through make_serve_steps(cfg, rules), "
            "whose caches come from init_caches(rules=)")
    rolling = cache is not None and window > 0 and cache.k.shape[1] <= window
    if cache is not None and update_cache:
        cache = _write_cache(cache, k, v, s)

    flash_want = (cfg.attn_impl == "flash"
                  and (cache is None or s > 1) and s_global > cfg.attn_chunk)
    if cache is not None and s == 1:
        # rolling caches enforce the window structurally: no mask needed
        out = _decode_grouped(q.reshape(b, s, g, r, dh), cache,
                              window=0 if rolling else window)
        out = out.reshape(b, s, h, dh)
    elif n_seq > 1:
        # each rank masks at its shard's global offsets.  Short sequences
        # all-gather K/V; from attn_ring_min_sk keys on, the ring keeps
        # them sharded and rotates them past the resident q rows.
        mesh = current_rules().mesh
        if flash_want and _ring(cfg, s_global, n_seq):
            out = ring_flash_attention(q, k, v, window=window, mesh=mesh,
                                       seq_axes=seq_axes)
        elif flash_want:
            out = sharded_flash_attention(q, k, v, window=window, mesh=mesh,
                                          seq_axes=seq_axes,
                                          chunk=cfg.attn_chunk)
        else:
            kf, vf = all_gather_many([k, v], [1, 1], mesh, seq_axes)
            out = _grouped_rows(q, kf, vf, cfg, window,
                                q_base=mesh.axis_index(seq_axes) * s,
                                s_global=s_global)
    else:
        out = _self_attend(q, k, v, cfg, window, grouped=cache is not None)

    out = out.to(dt).reshape(b, s, h * dh)
    return out @ params["wo"].to(dt), cache


def _ring(cfg: ModelConfig, s_global: int, n: int) -> bool:
    """The ring schedule for a global k/v length over n ranks."""
    return use_ring(s_global, n, threshold=cfg.attn_ring_min_sk or None)


def _grouped_rows(q, k, v, cfg: ModelConfig, window: int, *, q_base: int,
                  s_global: int) -> torch.Tensor:
    """The reference's non-flash route for a rank's rows of the sequence
    (its GSPMD grouped cores): q (B, Sr, H, Dh) at global positions
    ``q_base + i`` against the whole K/V (B, S, G, Dh), naive where the
    config asks for it or the global length is within ``attn_chunk``,
    else chunked."""
    b, sr, h, dh = q.shape
    g = k.shape[2]
    q5 = q.reshape(b, sr, g, h // g, dh)
    if cfg.attn_impl == "naive" or s_global <= cfg.attn_chunk:
        out = _naive_grouped(q5, k, v, window=window, q_base=q_base)
    else:
        out = _chunked_grouped(q5, k, v, window=window, chunk=cfg.attn_chunk,
                               q_base=q_base)
    return out.reshape(b, sr, h, dh)


def _self_attend(q, k, v, cfg: ModelConfig, window: int,
                 grouped: bool = False) -> torch.Tensor:
    """Causal self-attention of a whole sequence (q (B, S, H, Dh), k/v
    (B, S, G, Dh)): the flash kernel (row 8) when ``cfg.attn_impl ==
    "flash"`` and the sequence is longer than ``attn_chunk``, else naive
    or chunked, over flat heads (k/v repeated to q's heads), or with
    ``grouped`` (a prefill beside a cache, as the reference routes it)
    over the grouped cores."""
    b, s, h, dh = q.shape
    if cfg.attn_impl == "flash" and s > cfg.attn_chunk:
        return ops.flash_attention(q, k, v, window=window,
                                   chunk=cfg.attn_chunk)
    r = h // k.shape[2]
    if grouped:
        q5 = q.reshape(b, s, k.shape[2], r, dh)
        if cfg.attn_impl == "naive" or s <= cfg.attn_chunk:
            out = _naive_grouped(q5, k, v, window=window)
        else:
            out = _chunked_grouped(q5, k, v, window=window,
                                   chunk=cfg.attn_chunk)
        return out.reshape(b, s, h, dh)
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
                 rope_theta: Optional[float] = None, positions=None,
                 cache: Optional[KVCache] = None,
                 kv: Optional[KVSlice] = None):
    """Attention under the layout (``sharding.TrainLayout``): x is this
    rank's shard of the residual stream (B, S / sp, D), or under
    ``one_token`` the whole decode token; the sequence is gathered over
    ``sp``, ``wq`` / ``wk`` / ``wv`` run column-parallel, and ``wo`` runs
    row-parallel, its partial sums reduce-scattered back to the sequence
    shards (``layout.row_reduce``; summed over ``tp`` for one token).
    Returns (out, cache).

    Where the heads divide over ``tp`` each rank's columns are its heads,
    and attention runs over them on the whole sequence (rows at global
    positions from 0, or ``positions``), with ``attn_impl="flash"`` on row
    8 through ``ops.flash_attention``.  ``wk`` / ``wv`` shard their flat
    G * Dh dim, not heads: where the KV heads divide over ``tp`` this
    rank's slice holds exactly the KV heads its q heads read; otherwise
    (G < tp, say) K/V are gathered over ``tp`` before this rank's q heads
    pick theirs, and a ``wk`` / ``wv`` left whole (G * Dh not dividing)
    projects this rank's own rows, then gathers the sequence.  Heads that
    do not divide take ``_attention_rows``, the reference's
    sequence-sharded route; the function computed is the same.

    With a cache (this rank's shard, placed by ``kv``): a prefill writes
    its k/v (``_write_cache``: the rank's KV heads, or its slots from k/v
    gathered to every KV head) and attends as the unsharded layer does
    with a cache (flash, else the grouped cores); a decode step writes
    its token, then attends over a head-sharded cache locally, or, over a
    sequence-sliced one, with q for every head (gathered over ``tp``)
    against the rank's slots, the partial softmaxes combined over
    ``kv.axes`` (``_decode_grouped``), before this rank's heads go
    through ``wo``."""
    dt = cfg.compute_dtype
    mesh, tp, sp_axes = layout.mesh, layout.tp, layout.sp_axes
    h, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    window = cfg.window if kind == "local" else 0
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    xf = all_gather_grad(x, mesh, sp_axes, 1)
    b, s, _ = xf.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]

    def project(name):
        """(K or V, True when it holds every KV head, False when this
        rank's G / tp)."""
        w = params[name].to(dt)
        if not layout.tp_sharded(spec[name], -1):
            t = all_gather_grad(x @ w, mesh, sp_axes, 1)
        elif g % tp == 0:
            return (xf @ w).reshape(b, s, g // tp, dh), False
        else:
            t = all_gather_grad(xf @ w, mesh, layout.tp_axes, 2)
        return t.reshape(b, s, g, dh), True

    (k, whole), (v, _) = project("wk"), project("wv")
    k = apply_rope(k, positions, theta)
    if cfg.qk_norm:
        k = _qknorm(k, dt)
    if cache is not None:
        if kv.heads:
            gl = g // tp
            kc, vc = (t[:, :, layout.tp_index() * gl:
                        (layout.tp_index() + 1) * gl] if whole else t
                      for t in (k, v))
        else:
            kc, vc = (t if whole else all_gather_grad(t, mesh,
                                                      layout.tp_axes, 2)
                      for t in (k, v))
        cache = _write_cache(cache, kc, vc, s, kv.lo, kv.m)
    if h % tp:
        return _attention_rows(params, x, xf, k, v, cfg, layout, spec,
                               window=window, theta=theta,
                               positions=positions, cache=cache, kv=kv)

    hl = h // tp
    me = layout.tp_index()
    heads = range(me * hl, (me + 1) * hl)
    q = (xf @ params["wq"].to(dt)).reshape(b, s, hl, dh)
    q = apply_rope(q, positions, theta)
    if cfg.qk_norm:
        q = _qknorm(q, dt)
    if whole:      # this rank's q heads pick theirs
        kq, vq = (_kv_for_heads(t, heads, h // g) for t in (k, v))
    else:
        kq, vq = k, v
    if cache is not None and s == 1:
        win = 0 if window > 0 and kv.m <= window else window
        if kv.heads:
            q5 = q.reshape(b, 1, g // tp, hl * tp // g, dh)
            out = _decode_grouped(q5, cache, window=win, sl=kv, mesh=mesh)
        else:
            qa = all_gather_grad(q, mesh, layout.tp_axes, 2)
            out = _decode_grouped(qa.reshape(b, 1, g, h // g, dh), cache,
                                  window=win, sl=kv, mesh=mesh)
            out = out.reshape(b, 1, h, dh)[:, :, heads]
        out = out.reshape(b, 1, hl, dh)
    else:
        out = _self_attend(q, kq, vq, cfg, window, grouped=cache is not None)
    out = out.to(dt).reshape(b, s, hl * dh) @ params["wo"].to(dt)
    return layout.row_reduce(out), cache


def _attention_rows(params: dict, x, xf, k, v, cfg: ModelConfig, layout,
                    spec: dict, *, window: int, theta: float, positions,
                    cache, kv):
    """``attention_tp`` for heads that do not divide over ``tp``: the
    reference's sequence-sharded route (its shard_map'd flash schedules
    and GSPMD's grouped cores on the sequence over ``sp``), for any head
    count.  K/V (B, S, G, Dh) hold every KV head over the whole sequence
    (``attention_tp`` gathered them and wrote any cache).  q's columns
    (``wq`` column-parallel, a rank's slice of them possibly cutting
    through a head) are resharded to this rank's rows with every head
    (one all-to-all), where RoPE and the qk-norm act on whole heads;
    attention runs over those rows at ``q_base = index * S / tp``: row 9
    around the ring from ``attn_ring_min_sk`` global keys on (K/V this
    rank's rows of them), else row 8 at ``q_base``, under ``attn_impl=
    "flash"`` above ``attn_chunk``, else the grouped cores.  The output is
    resharded back to this rank's columns for ``wo``'s row-parallel
    product.  A ``wq`` / ``wo`` left whole (H * Dh not dividing) projects
    this rank's own rows, and its product is then this rank's shard of
    the residual stream whole.  A decode step (``one_token``) gathers q
    over ``tp`` for every head and attends over the rank's cache slots
    (``_decode_grouped``), then keeps this rank's columns of the
    output."""
    dt = cfg.compute_dtype
    mesh, tp_axes = layout.mesh, layout.tp_axes
    h, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b, s, _ = xf.shape
    cols = layout.tp_sharded(spec["wq"], -1)
    wq, wo = params["wq"].to(dt), params["wo"].to(dt)
    if cache is not None and s == 1:
        q = xf @ wq
        if cols:
            q = all_gather_grad(q, mesh, tp_axes, 2)
        q = apply_rope(q.reshape(b, 1, h, dh), positions, theta)
        if cfg.qk_norm:
            q = _qknorm(q, dt)
        win = 0 if window > 0 and kv.m <= window else window
        out = _decode_grouped(q.reshape(b, 1, g, h // g, dh), cache,
                              window=win, sl=kv, mesh=mesh)
        out = out.to(dt).reshape(b, 1, h * dh)
        if cols:
            n = h * dh // layout.tp
            out = out[..., layout.tp_index() * n:(layout.tp_index() + 1) * n]
    else:
        sr = x.shape[1]
        q_base = layout.tp_index() * sr
        q = reshard_grad(xf @ wq, mesh, tp_axes, 1, 2) if cols else x @ wq
        q = apply_rope(q.reshape(b, sr, h, dh),
                       positions[..., q_base:q_base + sr], theta)
        if cfg.qk_norm:
            q = _qknorm(q, dt)
        flash = cfg.attn_impl == "flash" and s > cfg.attn_chunk
        if flash and _ring(cfg, s, layout.tp):
            out = ring_flash_attention(
                q, seq_rows(k, mesh, tp_axes, sr),
                seq_rows(v, mesh, tp_axes, sr), window=window, mesh=mesh,
                seq_axes=tp_axes)
        elif flash:
            out = ops.flash_attention(q, k, v, window=window, q_base=q_base,
                                      chunk=cfg.attn_chunk)
        else:
            out = _grouped_rows(q, k, v, cfg, window, q_base=q_base,
                                s_global=s)
        out = out.to(dt).reshape(b, sr, h * dh)
        if cols:
            out = reshard_grad(out, mesh, tp_axes, 2, 1)
    out = out @ wo
    return (layout.row_reduce(out) if cols else out), cache


def _qknorm(q: torch.Tensor, dt) -> torch.Tensor:
    n = torch.rsqrt(q.float().square().mean(-1, keepdim=True) + 1e-6)
    return (q.float() * n).to(dt)
