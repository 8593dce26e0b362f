"""Flash-attention forward: CUDA launchers beside their plain versions,
and the sequence-parallel schedules built on them.

Port of ``repro/kernels/flash_attention.py``: ``flash_attention_fwd``
(TPU kernel table row 8) and the block-resumable ``flash_attention_step``
(row 9).  The function, for q (B, Sq, H, D) and k, v (B, Sk, G, D) with
H % G == 0 and r = H / G:

    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // r] / sqrt(D)) v[b, j, h // r]

over the keys visible from query row i: ``j <= i + q_base`` and, when
``window > 0``, ``j > i + q_base - window``.  Scores, the softmax and the
product with v are fp32 whatever the input dtype; the output is cast to
q's dtype after dividing by ``max(l, 1e-30)``.

``flash_attention_step`` folds one K/V shard, whose row 0 sits at global
position ``k_base``, into a carried online-softmax state (m, l, acc): fp32
(B, Sq, H, 1), (B, Sq, H, 1) and (B, Sq, H, D), ``None`` for a fresh start
(m = -1e30, l = 0, acc = 0), returned un-normalized; ``finalize`` turns it
into (out, lse).  Chaining the steps over the shards of K/V gives the
one-shot forward.

Each op has a launcher, ``*_cuda``, which runs a hand-written kernel on
CUDA tensors and counts its launches in ``LAUNCHES``, and a plain
version, ``*_plain``, the same function in PyTorch tensor operations,
chunked over query rows so its (B, H, rows, Sk) score block stays
bounded.  ``flash_attention_fwd`` and
``flash_attention_step`` choose between them by the tensors' device,
through the registry; a launcher never falls back to the plain version.

Two device bodies compute rows 8 and 9, and ``flash_body`` picks one from
the dtype and head dim alone: ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``,
Hopper's tensor cores fed by TMA, p split into bf16 hi + lo) for bf16 with
D in ``WGMMA_HEAD_DIMS``, ``"simt"`` (``csrc/flash_attention.cu``, fp32 FMAs)
for fp32 and every other D.  ``BODY_LAUNCHES`` counts launches by body; a
refused launch raises, and neither body gives way to the other.

On ``meta`` tensors (the dry run, ``launch.dryrun``) each op has a third
route, ``*_meta``: no kernel and no arithmetic, the output's shapes alone,
and the call's work counted in ``META_WORK`` by the formula of the
kernels' bound: 4 D FLOPs per visible (query, key) pair and head, each
operand read once and each output written once.  ``FlashAttention``'s
backward on ``meta`` counts, under ``flash_attention_bwd``, the products
of the plain chunked recompute and of its autograd backward that it runs
on real tensors (``chunked_bwd_work``), without running them op by op;
the reverse ring's backward on ``meta`` rotates its shards as on real
tensors (the collectives count themselves) and counts each step's
products the same way (``ring_bwd_step_work``).

Under autograd row 8 runs inside ``FlashAttention`` (the reference's
``flash_attention`` custom_vjp): the forward is the kernel, the backward
recomputes the same attention through the plain chunked path, its rows
at their global positions ``q_base + i``, and differentiates that.  No
backward kernel exists, here or in the reference.

The sequence-parallel schedules (the reference's shard_map wrappers) run
on every rank of a mesh axis with that rank's sequence shard of q, k and
v: ``sharded_flash_attention`` all-gathers K/V (differentiably: dK/dV are
reduce-scattered back to their shards) and runs row 8 at the shard's
``q_base``; ``ring_flash_attention`` keeps K/V sharded and chains row 9
over the ring, rotating the shards with
``repro_torch.launch.collectives.ring_shift``, and under autograd runs the
reference's reverse ring backward (``RingFlashAttention``).  ``use_ring``
is the routing predicate between them.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels.build import (flash_attention_library,
                                       flash_attention_wgmma_library)
from repro_torch.launch.collectives import all_gather_many, ring_shift
# the reference's name for launch.mesh.axis_size, as this module exports it
from repro_torch.launch.mesh import axis_size as axes_size

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_step": 0}
BODY_LAUNCHES = {"wgmma": 0, "simt": 0}
# the meta route's calls, FLOPs and bytes by op (module docstring)
META_WORK = {op: {"calls": 0, "flops": 0, "bytes": 0}
             for op in ("flash_attention_fwd", "flash_attention_step",
                        "flash_attention_bwd")}
# the head dims the tensor-core body is built for: every full config's
WGMMA_HEAD_DIMS = (64, 128, 192, 256)

NEG_INF = -1e30
# fp32 elements of one (B, H, rows, Sk) score block in the plain version
# (1 GiB)
_CHUNK_ELEMS = 1 << 28
_MAX_HEAD_DIM = 256
_GRID_YZ_MAX = 65535
_INT_MAX = 2 ** 31 - 1
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def reset_meta_work() -> None:
    for rec in META_WORK.values():
        for key in rec:
            rec[key] = 0


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The device body rows 8 and 9 run for q/k/v of ``dtype`` and head
    dim ``d``: ``"wgmma"`` for bf16 at D in ``WGMMA_HEAD_DIMS``, else
    ``"simt"``."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "simt"


# The bodies' tiles and block sizes (csrc/flash_attention.cu,
# csrc/flash_attention_wgmma.cu)
FLASH_BQ = 64                          # query rows a block (a consumer)
FLASH_BK = 64                          # keys a tile
SIMT_TX = 16                           # SIMT threads along D
SIMT_COLS = (1, 2, 4, 8, 12, 16)       # its instantiations: columns a thread
SIMT_THREADS = 256
WGMMA_THREADS = 384                    # producer + two consumer warpgroups


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How a body covers q (B, Sq, H, D) against K/V of G heads: its
    grid, the block size, and (``block_writes``) the output rows and
    heads each block writes, as the launcher and the kernel compute
    them.  The SIMT body: a block of 64 rows of one head, each thread
    ``cols`` columns of D.  The wgmma body: two consumers a block, 64
    rows each; with one q head a KV head (``pair_rows``) the two take
    128 consecutive rows of one head, else one 64-row tile of two heads
    of one group."""

    body: str
    b: int
    sq: int
    h: int
    g: int
    d: int

    @property
    def pair_rows(self) -> bool:
        return self.h == self.g

    @property
    def cols(self) -> int:
        """The SIMT body's columns a thread (its ``DPT``)."""
        need = -(-self.d // SIMT_TX)
        return next((c for c in SIMT_COLS if need <= c), 0)

    @property
    def threads(self) -> int:
        return WGMMA_THREADS if self.body == "wgmma" else SIMT_THREADS

    @property
    def grid(self):
        r = self.h // self.g
        if self.body == "simt":
            return (-(-self.sq // FLASH_BQ), self.h, self.b)
        if self.pair_rows:
            return (-(-self.sq // (2 * FLASH_BQ)), self.h, self.b)
        return (-(-self.sq // FLASH_BQ), self.g * ((r + 1) // 2), self.b)

    def block_writes(self, bx: int, by: int, bz: int):
        """[(batch, head, first row, end row, D columns written)] of block
        (bx, by, bz); heaviest tiles first, as both bodies order them."""
        gx = self.grid[0]
        if self.body == "simt":
            q0 = (gx - 1 - bx) * FLASH_BQ
            cols = min(self.d, SIMT_TX * self.cols)
            return [(bz, by, q0, min(q0 + FLASH_BQ, self.sq), cols)]
        if self.pair_rows:
            q0 = (gx - 1 - bx) * 2 * FLASH_BQ
            return [(bz, by, r0, min(r0 + FLASH_BQ, self.sq), self.d)
                    for r0 in (q0, q0 + FLASH_BQ) if r0 < self.sq]
        r = self.h // self.g
        pairs = (r + 1) // 2
        kvh, pair = divmod(by, pairs)
        q0 = (gx - 1 - bx) * FLASH_BQ
        return [(bz, kvh * r + 2 * pair + c, q0, min(q0 + FLASH_BQ, self.sq),
                 self.d) for c in (0, 1) if 2 * pair + c < r]


def flash_plan(b: int, sq: int, h: int, g: int, d: int, dtype,
               body: str | None = None) -> FlashPlan:
    """The plan rows 8 and 9 launch for q (b, sq, h, d) against g KV
    heads: ``flash_body``'s body, or ``body`` where it takes the call."""
    return FlashPlan(_pick_body(body, dtype, d), b, sq, h, g, d)


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, G, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    g = k.shape[2]
    if g == 0 or h % g:
        raise ValueError(f"{h} query heads do not group over {g} kv heads")
    return b, sq, k.shape[1], h, g, d


def flash_attention_fwd(q, k, v, *, window: int = 0, q_base: int = 0):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    from repro_torch.kernels import registry
    return registry.resolve("flash_attention", q.device)(
        q, k, v, window=window, q_base=q_base)


def flash_attention_step(q, k, v, carry, *, q_base: int, k_base: int,
                         window: int = 0):
    """One ring step (row 9): the kernel on CUDA tensors, its plain
    version on CPU tensors."""
    from repro_torch.kernels import registry
    return registry.resolve("flash_attention_step", q.device)(
        q, k, v, carry, q_base=q_base, k_base=k_base, window=window)


def _ref_bwd_fn(q, k, v, window: int, chunk: int, q_base: int = 0):
    """The plain chunked attention the backward recomputes through (the
    reference's ``_ref_bwd_fn``), q's rows at ``q_base + i``."""
    from repro_torch.models.attention import _chunked_grouped
    b, s, h, d = q.shape
    g = k.shape[2]
    out = _chunked_grouped(q.reshape(b, s, g, h // g, d), k, v,
                           window=window, chunk=chunk, q_base=q_base)
    return out.reshape(b, s, h, d)


class FlashAttention(torch.autograd.Function):
    """Row 8 under autograd: the reference's ``flash_attention``
    custom_vjp.  The forward is the registry's route (the kernel on CUDA
    tensors, whose output has no graph of its own; the plain version on
    CPU tensors), run without a graph; the backward recomputes the same
    attention through the plain chunked path (``_chunked_grouped`` at
    ``chunk``, the model's ``attn_chunk``, q's rows at ``q_base + i``
    against every key of k and v) and differentiates that, as the
    reference's ``_fa_bwd`` does (and its ``_sfa_bwd`` for a rank's rows
    of the all-gather schedule).  q, k and v are saved only when one of
    them needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk: int, q_base: int):
        ctx.window, ctx.chunk, ctx.q_base = window, chunk, q_base
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, window=window, q_base=q_base)

    @staticmethod
    def backward(ctx, g_out):
        if g_out.device.type == "meta":
            q, k, v = ctx.saved_tensors
            _add_work("flash_attention_bwd", *chunked_bwd_work(
                q.shape, k.shape, ctx.window, ctx.chunk, ctx.q_base))
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None, None, None)
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            out = _ref_bwd_fn(q, k, v, ctx.window, ctx.chunk, ctx.q_base)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g_out)
        return dq, dk, dv, None, None, None


def init_carry(b: int, sq: int, h: int, d: int, device):
    """The fresh carry: m = -1e30, l = 0, acc = 0, fp32."""
    return (torch.full((b, sq, h, 1), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, sq, h, 1), dtype=torch.float32, device=device),
            torch.zeros((b, sq, h, d), dtype=torch.float32, device=device))


def _carry(carry, b, sq, h, d, device):
    """``carry``, checked against the step's shapes, or a fresh one."""
    if carry is None:
        return init_carry(b, sq, h, d, device)
    m, l, acc = carry
    for name, t, shape in (("m", m, (b, sq, h, 1)), ("l", l, (b, sq, h, 1)),
                           ("acc", acc, (b, sq, h, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != device:
            raise ValueError(f"carry {name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; the step needs {shape} float32 "
                             f"on {device}")
    return m, l, acc


def finalize(carry, dtype):
    """(out, lse) from a carry: ``out = acc / max(l, 1e-30)`` in ``dtype``
    and the per-row logsumexp ``m + log l`` (B, Sq, H), 0 where l = 0 (a
    row that saw no key)."""
    m, l, acc = carry
    out = (acc / l.clamp_min(1e-30)).to(dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.zeros_like(m))
    return out, lse[..., 0]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, *, window: int = 0, q_base: int = 0):
    """The definition the kernel is held to, in PyTorch tensor operations
    (the CPU path; on the card, the yardstick of correctness only)."""
    b, sq, sk, h, g, d = _shapes(q, k, v)
    r = h // g
    scale = d ** -0.5
    qf = q.float().reshape(b, sq, g, r, d)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kj = torch.arange(sk, device=q.device)
    rows = max(1, _CHUNK_ELEMS // max(b * h * sk, 1))
    for i0 in range(0, sq, rows):
        qc = qf[:, i0:i0 + rows]
        n = qc.shape[1]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qc, kf) * scale
        pos = torch.arange(i0, i0 + n, device=q.device)[:, None] + q_base
        visible = kj[None, :] <= pos
        if window > 0:
            visible &= kj[None, :] > pos - window
        s.masked_fill_(~visible, NEG_INF)
        s.sub_(s.amax(-1, keepdim=True)).exp_()
        l = s.sum(-1)                                    # (b, g, r, n)
        o = torch.einsum("bgrqk,bkgd->bqgrd", s, vf)
        o /= l.permute(0, 3, 1, 2)[..., None].clamp_min(1e-30)
        out[:, i0:i0 + n] = o.reshape(b, n, h, d).to(q.dtype)
    return out


def flash_attention_step_plain(q, k, v, carry, *, q_base: int, k_base: int,
                               window: int = 0):
    """The definition the row-9 kernel is held to: ``carry`` updated by the
    online softmax with the keys of this shard that each row can see,
    global key position ``k_base + j``.  A masked key adds nothing, so a
    row that sees no key here keeps its carry exactly."""
    b, sq, sk, h, g, d = _shapes(q, k, v)
    m0, l0, acc0 = _carry(carry, b, sq, h, d, q.device)
    r = h // g
    scale = d ** -0.5
    qf = q.float().reshape(b, sq, g, r, d)
    kf, vf = k.float(), v.float()
    m, l, acc = m0.clone(), l0.clone(), acc0.clone()
    if sk == 0:
        return m, l, acc
    kj = torch.arange(sk, device=q.device) + k_base
    rows = max(1, _CHUNK_ELEMS // max(b * h * sk, 1))

    def rows_t(t, i0, n):       # (b, n, h, 1) -> (b, g, r, n)
        return t[:, i0:i0 + n, :, 0].reshape(b, n, g, r).permute(0, 2, 3, 1)

    for i0 in range(0, sq, rows):
        qc = qf[:, i0:i0 + rows]
        n = qc.shape[1]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qc, kf) * scale
        pos = torch.arange(i0, i0 + n, device=q.device)[:, None] + q_base
        visible = kj[None, :] <= pos
        if window > 0:
            visible &= kj[None, :] > pos - window
        s.masked_fill_(~visible, NEG_INF)
        m_prev = rows_t(m0, i0, n)
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_().masked_fill_(~visible, 0.0)
        corr = torch.exp(m_prev - m_new)
        l_new = corr * rows_t(l0, i0, n) + p.sum(-1)
        pv = torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
        back = lambda t: t.permute(0, 3, 1, 2).reshape(b, n, h, 1)  # noqa: E731
        acc[:, i0:i0 + n] = back(corr) * acc0[:, i0:i0 + n] + \
            pv.reshape(b, n, h, d)
        m[:, i0:i0 + n] = back(m_new)
        l[:, i0:i0 + n] = back(l_new)
    return m, l, acc


# ---------------------------------------------------------------------------
# meta route
# ---------------------------------------------------------------------------

def visible_pairs(sq: int, sk: int, *, q_base: int = 0, k_base: int = 0,
                  window: int = 0) -> int:
    """The (query, key) pairs that rows ``q_base + i`` (i < sq) see among
    keys ``k_base + j`` (j < sk): ``key <= row`` and, with ``window > 0``,
    ``key > row - window``."""
    if sq <= 0 or sk <= 0:
        return 0
    rows = torch.arange(q_base, q_base + sq, dtype=torch.int64)
    hi = rows.clamp(max=k_base + sk - 1)
    lo = (rows - window + 1).clamp(min=k_base) if window > 0 else \
        torch.full_like(rows, k_base)
    return int((hi - lo + 1).clamp(min=0).sum())


def chunked_bwd_work(q_shape, k_shape, window: int, chunk: int,
                     q_base: int = 0):
    """(FLOPs, bytes) of the matrix products that ``FlashAttention``'s
    backward runs on real tensors: the plain chunked recompute
    (``_ref_bwd_fn``: per q block, the kv blocks its mask needs, each a
    scores and a p.v product) and autograd's two products for each of
    them; the bytes are each product's fp32 operands and output, the
    backward's products moving the same three sizes as their forward's."""
    b, sq, h, d = q_shape
    sk, g = k_shape[1], k_shape[2]
    r = h // g
    c = min(chunk, max(sq, sk))
    n_q, n_k = -(-sq // c), -(-sk // c)
    pairs = 0
    for qi in range(n_q):
        q_off = q_base + qi * c
        hi = min(n_k - 1, (q_off + c - 1) // c)
        lo = 0
        if window > 0:
            lo = max(0, -(-(q_off - window - c + 1) // c))
        pairs += max(0, hi - lo + 1)
    # one product (b g, r c, d) x (b g, d, c) and one (b g, r c, c) x
    # (b g, c, d) a block pair, three times over (forward, two grads)
    flops = 3 * 2 * (2 * b * g * r * c * c * d)
    nbytes = 3 * 4 * b * g * (2 * (r * c * d + d * c + r * c * c))
    return pairs * flops, pairs * nbytes


def ring_bwd_step_work(q_shape, k_shape):
    """(FLOPs, bytes) of one step of ``ring_flash_attention_bwd`` on real
    tensors: per block of q rows, five fp32 products of (rows x Sk) per
    head (the scores, dv, dp, dq and dk), each moving its two operands
    and its output."""
    b, sq, h, d = q_shape
    sk, g = k_shape[1], k_shape[2]
    r = h // g
    rows = max(1, _CHUNK_ELEMS // max(b * h * sk, 1))
    flops = nbytes = 0
    for i0 in range(0, sq, rows):
        n = min(rows, sq - i0)
        flops += 5 * 2 * b * g * r * n * sk * d
        nbytes += 5 * 4 * b * g * (r * n * d + sk * d + r * n * sk)
    return flops, nbytes


def _add_work(op: str, flops: int, nbytes: int) -> None:
    rec = META_WORK[op]
    rec["calls"] += 1
    rec["flops"] += flops
    rec["bytes"] += nbytes


def _count_meta(op: str, b: int, h: int, d: int, pairs: int,
                tensors) -> None:
    """One row 8 / 9 call: 4 D FLOPs a visible pair and head, each tensor
    read or written once."""
    _add_work(op, 4 * d * b * h * pairs,
              sum(t.numel() * t.element_size() for t in tensors))


def flash_attention_fwd_meta(q, k, v, *, window: int = 0, q_base: int = 0):
    """Row 8 on ``meta`` tensors: the output's shape, the work counted in
    ``META_WORK``."""
    b, sq, sk, h, g, d = _shapes(q, k, v)
    out = torch.empty_like(q)
    _count_meta("flash_attention_fwd", b, h, d,
                visible_pairs(sq, sk, q_base=q_base, window=window),
                (q, k, v, out))
    return out


def flash_attention_step_meta(q, k, v, carry, *, q_base: int, k_base: int,
                              window: int = 0):
    """Row 9 on ``meta`` tensors: the new carry's shapes, the work counted
    in ``META_WORK`` (the carry read and written)."""
    b, sq, sk, h, g, d = _shapes(q, k, v)
    old = _carry(carry, b, sq, h, d, q.device)
    new = tuple(torch.empty_like(t) for t in old)
    _count_meta("flash_attention_step", b, h, d,
                visible_pairs(sq, sk, q_base=q_base, k_base=k_base,
                              window=window), (q, k, v) + old + new)
    return new


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _check_cuda(q, k, v, window, q_base, k_base=0):
    """The launchers' checks: CUDA tensors of one dtype and device that the
    kernel takes, within its int32 ranges.  Returns the shapes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"the CUDA flash-attention kernel takes CUDA "
                             f"tensors; {name} is not one")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} but q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16; got "
                         f"{q.dtype}")
    b, sq, sk, h, g, d = _shapes(q, k, v)
    if not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{_MAX_HEAD_DIM}")
    if h > _GRID_YZ_MAX or b > _GRID_YZ_MAX:
        raise ValueError(f"{b} batch rows or {h} heads exceed the grid")
    if max(sq, sk, int(window), int(q_base) + sq, int(k_base) + sk) > \
            _INT_MAX or q_base < 0 or k_base < 0:
        raise ValueError(f"sequence lengths ({sq}, {sk}), q_base {q_base} "
                         f"or k_base {k_base} outside the kernel's int32 "
                         f"range")
    return b, sq, sk, h, g, d


def _pick_body(body, dtype, d):
    """``body`` checked against what it takes, or ``flash_body``'s."""
    if body is None:
        return flash_body(dtype, d)
    if body == "simt":
        return body
    if body == "wgmma" and flash_body(dtype, d) == "wgmma":
        return body
    raise ValueError(f"flash body {body!r} does not take {dtype} at head "
                     f"dim {d} (wgmma: bfloat16, D in {WGMMA_HEAD_DIMS})")


def check_tma(name: str, t: torch.Tensor) -> None:
    """Refuse a tensor the TMA loads cannot read: the base pointer and
    every stride but the innermost must be multiples of 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:-1]):
        raise ValueError(f"the wgmma flash body reads {name} by TMA, which "
                         f"needs 16-byte-aligned base pointers and strides; "
                         f"{name} starts at {t.data_ptr():#x} with strides "
                         f"{t.stride()} of {size} bytes")


def flash_attention_fwd_cuda(q, k, v, *, window: int = 0, q_base: int = 0,
                             body: str | None = None):
    """Flash-attention kernel (replaces ``flash_attention_fwd``'s
    ``_flash_kernel``) on the body ``flash_body`` picks, or on ``body``
    when given (the comparisons of the two bodies).  The kernels read
    dense (B, S, heads, D) rows, so a strided q, k or v (a transposed or
    sliced view) is copied to a contiguous tensor here; the model's q, k
    and v already are."""
    b, sq, sk, h, g, d = _check_cuda(q, k, v, window, q_base)
    body = _pick_body(body, q.dtype, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if body == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma(name, t)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scale = ctypes.c_float(d ** -0.5)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if body == "wgmma":
            rc = flash_attention_wgmma_library().lib.\
                flash_attention_wgmma_fwd_launch(
                    *ptrs, b, sq, sk, h, g, d, int(window), int(q_base),
                    scale, stream)
        else:
            rc = flash_attention_library().lib.flash_attention_fwd_launch(
                *ptrs, b, sq, sk, h, g, d, int(window), int(q_base), scale,
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel ({body} body) launch "
                           f"failed: cudaError {rc}")
    LAUNCHES["flash_attention_fwd"] += 1
    BODY_LAUNCHES[body] += 1
    return out


def flash_attention_step_cuda(q, k, v, carry, *, q_base: int, k_base: int,
                              window: int = 0, body: str | None = None):
    """Block-resumable flash kernel (row 9, replaces
    ``flash_attention_step``'s ``_flash_carry_kernel``) on the body
    ``flash_body`` picks, or on ``body`` when given.  Returns a new carry;
    the one passed in is left as it is.  Strided q, k, v or carry tensors
    are copied to contiguous ones here."""
    b, sq, sk, h, g, d = _check_cuda(q, k, v, window, q_base, k_base)
    body = _pick_body(body, q.dtype, d)
    m, l, acc = (t.contiguous() for t in _carry(carry, b, sq, h, d,
                                                q.device))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    if acc.numel() == 0:
        return m_out, l_out, acc_out
    if body == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma(name, t)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scale = ctypes.c_float(d ** -0.5)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
                l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
                l_out.data_ptr(), acc_out.data_ptr(), b, sq, sk, h, g, d,
                int(window), int(q_base), int(k_base), scale)
        if body == "wgmma":
            rc = flash_attention_wgmma_library().lib.\
                flash_attention_wgmma_step_launch(*args, stream)
        else:
            rc = flash_attention_library().lib.flash_attention_step_launch(
                *args, int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_step kernel ({body} body) "
                           f"launch failed: cudaError {rc}")
    LAUNCHES["flash_attention_step"] += 1
    BODY_LAUNCHES[body] += 1
    return m_out, l_out, acc_out


# ---------------------------------------------------------------------------
# sequence-parallel schedules over a mesh axis
# ---------------------------------------------------------------------------

# Below this k/v length the all-gather schedule wins: a ring of tiny shards
# pays N collective latencies for K/V that would have fit on each rank
# anyway.  models/attention.py routes on cfg.attn_ring_min_sk, which
# defaults to this.
RING_MIN_SK = 4096


def use_ring(s_k: int, n_shards: int, *, threshold: int | None = None) -> bool:
    """The ring-vs-all-gather routing predicate, on the GLOBAL k/v length:
    ring only when there is a real ring (> 1 shard), K/V divides over it,
    and the per-rank K/V saving (~N x) is worth N collective steps."""
    t = RING_MIN_SK if threshold is None else threshold
    return n_shards > 1 and s_k >= t and s_k % n_shards == 0


def sharded_flash_attention(q, k, v, *, window: int, mesh,
                            seq_axes=("model",), chunk: int = 256):
    """The all-gather schedule.  On every rank of ``seq_axes``: q (B, Sq/N,
    H, D), k and v (B, Sk/N, G, D), this rank's sequence shards.  K/V are
    all-gathered to their full length and row 8 runs on the local q rows
    at ``q_base = index * Sq/N``, so the masks compare global positions.
    Returns this rank's (B, Sq/N, H, D) rows.  Differentiable: the
    backward recomputes the rows' attention against the whole K/V
    (``FlashAttention`` at ``chunk``) and reduce-scatters dK/dV back to
    their shards."""
    from repro_torch.kernels.ops import flash_attention
    kf, vf = all_gather_many([k, v], [1, 1], mesh, seq_axes)
    q_base = mesh.axis_index(seq_axes) * q.shape[1]
    return flash_attention(q, kf, vf, window=window, q_base=q_base,
                           chunk=chunk)


def ring_flash_attention_fwd(q, k, v, *, window: int, mesh,
                             seq_axes=("model",)):
    """The ring schedule's body (the reference's ``_ring_fwd_impl``), on
    every rank of ``seq_axes`` with its sequence shards as in
    ``sharded_flash_attention``.  K/V stay sharded: at step s the rank
    holds the shard that started s hops upstream, global row 0 at
    ``k_base = ((index - s) mod N) * Sk/N``; the rotation for step s + 1
    starts before step s's kernel and is waited on after it.  Returns
    (out (B, Sq/N, H, D), lse (B, Sq/N, H)); lse is for the backward."""
    n = axes_size(mesh, seq_axes)
    me = mesh.axis_index(seq_axes)
    q_base = me * q.shape[1]
    sk_local = k.shape[1]
    carry = None
    kv = (k, v)
    for s in range(n):
        pending = ring_shift(kv, mesh, seq_axes) if s < n - 1 else None
        carry = flash_attention_step(
            q, kv[0], kv[1], carry, q_base=q_base,
            k_base=((me - s) % n) * sk_local, window=window)
        if pending is not None:
            kv = pending.wait()
    return finalize(carry, q.dtype)


def ring_flash_attention_bwd(q, k, v, out, lse, g_out, *, window: int, mesh,
                             seq_axes=("model",)):
    """The reverse ring with recompute (the reference's
    ``_ring_bwd_impl``): q, out, lse and dout stay put; (k, v, dk, dv)
    rotate the opposite way to the forward, so that at step s the rank
    holds the shard of index ``(me + s) mod N`` with the dk / dv that the
    ranks before it added to it, and after N hops dk / dv are home (the
    last hop moves only them).  Each step recomputes p = exp(s - lse) for
    the resident shard, in fp32, and adds its terms to dq and to the
    travelling dk / dv.  Returns (dq, dk, dv) in q's, k's and v's dtypes.
    Plain PyTorch, in q rows of at most ``_CHUNK_ELEMS`` scores at a
    time; no backward kernel exists, here or in the reference."""
    n = axes_size(mesh, seq_axes)
    me = mesh.axis_index(seq_axes)
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    r = h // g
    scale = d ** -0.5
    q5 = q.float().reshape(b, sq, g, r, d)
    go5 = g_out.float().reshape(b, sq, g, r, d)
    lse_t = lse.float().reshape(b, sq, g, r).permute(0, 2, 3, 1)[..., None]
    delta = (go5 * out.float().reshape(b, sq, g, r, d)).sum(-1).permute(
        0, 2, 3, 1)[..., None]                          # (b, g, r, sq, 1)
    iq = me * sq + torch.arange(sq, device=q.device)
    dq = torch.zeros_like(q5)
    rows = max(1, _CHUNK_ELEMS // max(b * h * sk, 1))
    ring = (k.float(), v.float(), torch.zeros((b, sk, g, d),
                                              dtype=torch.float32,
                                              device=q.device),
            torch.zeros((b, sk, g, d), dtype=torch.float32, device=q.device))
    meta = q.device.type == "meta"
    for s in range(n):
        kf, vf, dk, dv = ring
        ik = ((me + s) % n) * sk + torch.arange(sk, device=q.device)
        if meta:
            # the products counted, not run (module docstring)
            _add_work("flash_attention_bwd",
                      *ring_bwd_step_work(q.shape, k.shape))
        for i0 in range(0, sq if not meta else 0, rows):
            sl = slice(i0, i0 + rows)
            visible = ik[None, :] <= iq[sl, None]
            if window > 0:
                visible &= ik[None, :] > iq[sl, None] - window
            qc, gc = q5[:, sl], go5[:, sl]
            sc = torch.einsum("bqgrd,bkgd->bgrqk", qc, kf) * scale
            sc.masked_fill_(~visible, NEG_INF)
            p = sc.sub_(lse_t[:, :, :, sl]).exp_()
            dv += torch.einsum("bgrqk,bqgrd->bkgd", p, gc)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", gc, vf)
            ds = p.mul_(dp.sub_(delta[:, :, :, sl]))
            dq[:, sl] += torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
            dk += torch.einsum("bgrqk,bqgrd->bkgd", ds, qc) * scale
        live = (kf, vf, dk, dv) if s < n - 1 else (dk, dv)
        ring = ring_shift(live, mesh, seq_axes, reverse=True).wait()
    dk, dv = ring[-2:]
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class RingFlashAttention(torch.autograd.Function):
    """The ring schedule under autograd (the reference's
    ``ring_flash_attention`` custom_vjp): the forward chains row 9 over
    the ring and keeps (q, k, v, out, lse); the backward is
    ``ring_flash_attention_bwd``, which every rank of ``seq_axes`` runs
    together."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, mesh, seq_axes):
        out, lse = ring_flash_attention_fwd(q, k, v, window=window,
                                            mesh=mesh, seq_axes=seq_axes)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, mesh, seq_axes)
        return out

    @staticmethod
    def backward(ctx, g_out):
        window, mesh, seq_axes = ctx.args
        return ring_flash_attention_bwd(
            *ctx.saved_tensors, g_out, window=window, mesh=mesh,
            seq_axes=seq_axes) + (None, None, None)


def ring_flash_attention(q, k, v, *, window: int, mesh, seq_axes=("model",)):
    """The ring schedule: this rank's (B, Sq/N, H, D) output rows;
    differentiable (``RingFlashAttention``) when a gradient is wanted."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingFlashAttention.apply(q, k, v, window, mesh,
                                        tuple(seq_axes))
    return ring_flash_attention_fwd(q, k, v, window=window, mesh=mesh,
                                    seq_axes=seq_axes)[0]
