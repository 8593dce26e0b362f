"""Collectives over a mesh axis: the ring shift of a tuple of tensors and
the all-gather along one dimension that the sequence-parallel attention
needs (the sequence's, for K/V), and the mean over the ``data`` axis that
the data-parallel trainer takes of its loss and gradients; and for the
sharded LM trainer, collectives with a backward (``torch.distributed``'s
have none): the all-gather whose backward is a reduce-scatter, the
reduce-scatter whose backward is an all-gather, Megatron's pair (the sum
forward with the identity back, and the reverse) and the sum both ways, a
max outside the graph
and the all-to-all reshard of a tensor from one sharded dim to another.

The group's backend decides how a tensor moves:
  * ``nccl``: CUDA tensors move directly between cards (one rank a card);
  * ``gloo``: host tensors.  A CPU tensor moves as it is.  A CUDA tensor is
    copied to a host buffer before it is sent and back to its card after
    it is received: the transport for several ranks that share one card,
    where NCCL refuses to run (it takes one rank a device).  Those copies
    are explicit and counted in ``HOST_COPIES``;
  * ``fake`` (the dry run, ``launch.dryrun``): ``meta`` tensors, and no data
    moves.  Each collective records itself and returns ``meta`` tensors of
    the shapes the real one returns.
Nothing retries one transport after another fails, and a tensor that the
group's backend cannot move raises: a ``meta`` tensor on a gloo or NCCL
group, a real one on a fake group.

Every collective, on every backend, is counted in ``COLLECTIVES`` by what
it computes: ``all_gather``, ``reduce_scatter``, ``all_reduce`` (the sums,
the maxima and ``axis_mean``), ``all_to_all`` (``reshard_dims``) and
``send_recv`` (one ring shift), with its calls, its wire bytes a rank by
the reference's model (``repro.launch.hlo_analysis``: all-reduce 2 x out,
all-gather out, reduce-scatter out x group, all-to-all out, a shift out)
and its calls by mesh axes.  The model counts what each computes, not the
bytes this module's route sends for it: a sum here is an all-gather of N
parts and a rank-order sum (N x out on the wire), counted as the
all-reduce it computes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

# bytes and tensors copied between a card and the host for a gloo group
HOST_COPIES = {"bytes": 0, "tensors": 0}

COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "all_reduce",
                    "all_to_all", "send_recv")
# per kind: calls, wire bytes a rank, operand + output bytes a rank, calls
# by the mesh axes they ran over
COLLECTIVES = {kind: {"count": 0, "bytes": 0, "io_bytes": 0, "axes": {}}
               for kind in COLLECTIVE_KINDS}


# Callables told of each collective (``CALL_HOOKS``: a dict of its kind,
# axes, group size and, for a ring shift, its (source, destination) pairs
# of axis indices) and of each sum's inputs and result (``REDUCE_HOOKS``:
# ``hook(inputs, outputs, axes)``): ``repro_torch.analysis``'s recorders.
# Empty unless an audit records.
CALL_HOOKS: list = []
REDUCE_HOOKS: list = []


def reset_host_copies() -> None:
    for key in HOST_COPIES:
        HOST_COPIES[key] = 0


def reset_collectives() -> None:
    for rec in COLLECTIVES.values():
        rec["count"], rec["bytes"], rec["io_bytes"] = 0, 0, 0
        rec["axes"].clear()


def collectives_snapshot() -> dict:
    """A copy of ``COLLECTIVES`` (axes as ``"data,model"`` strings)."""
    return {kind: {"count": rec["count"], "bytes": rec["bytes"],
                   "io_bytes": rec["io_bytes"],
                   "axes": {",".join(a): n for a, n in
                            sorted(rec["axes"].items())}}
            for kind, rec in COLLECTIVES.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, mesh, axes, in_bytes: int, out_bytes: int, *,
            pairs=None) -> None:
    """Count one collective of ``kind`` over ``axes`` that takes
    ``in_bytes`` on this rank and gives it ``out_bytes`` (its wire bytes
    by the module's model); ``pairs``: a ring shift's (source,
    destination) axis indices."""
    n = len(mesh.ranks(axes))
    wire = {"all_reduce": 2 * out_bytes,
            "reduce_scatter": out_bytes * n}.get(kind, out_bytes)
    rec = COLLECTIVES[kind]
    rec["count"] += 1
    rec["bytes"] += wire
    rec["io_bytes"] += in_bytes + out_bytes
    key = mesh._key(axes)
    rec["axes"][key] = rec["axes"].get(key, 0) + 1
    if CALL_HOOKS:
        call = {"kind": kind, "axes": key, "size": n, "pairs": pairs,
                "bytes": wire}
        for hook in tuple(CALL_HOOKS):
            hook(call)


def _summed(inputs, outputs, axes):
    """Tell ``REDUCE_HOOKS`` that ``outputs`` are sums of ``inputs`` over
    ``axes``."""
    for hook in tuple(REDUCE_HOOKS):
        hook(list(inputs), list(outputs), axes)


def transport(backend: str, device) -> str:
    """How a tensor on ``device`` moves over a group of ``backend``:
    ``"nccl"``, ``"gloo"`` (host tensors as they are), ``"gloo+host"``
    (a CUDA tensor through host copies) or ``"fake"`` (a ``meta`` tensor
    on a fake group: counted, nothing moved)."""
    device = torch.device(device)
    if backend == "fake":
        if device.type == "meta":
            return "fake"
        raise ValueError(f"a fake process group counts collectives of meta "
                         f"tensors and moves no data; got a tensor on "
                         f"{device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a tensor on {device} but no CUDA device is "
                           f"present")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL group moves CUDA tensors; got one "
                             f"on {device}")
        return "nccl"
    if backend == "gloo":
        if device.type == "cpu":
            return "gloo"
        if device.type == "cuda":
            return "gloo+host"
        raise ValueError(f"a gloo group moves host tensors (or CUDA "
                         f"tensors through host copies); got one on "
                         f"{device}")
    raise ValueError(f"no transport for process-group backend {backend!r}")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of the CUDA tensor ``t``, in page-locked memory (the
    copies run at the bus's rate; PyTorch caches the blocks)."""
    HOST_COPIES["bytes"] += t.numel() * t.element_size()
    HOST_COPIES["tensors"] += 1
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _to_card(t: torch.Tensor, device) -> torch.Tensor:
    HOST_COPIES["bytes"] += t.numel() * t.element_size()
    HOST_COPIES["tensors"] += 1
    return t.to(device)


def _backend(mesh, axes) -> str:
    return dist.get_backend(mesh.group(axes))


class PendingShift:
    """A ring shift in flight; ``wait()`` returns the received tensors."""

    def __init__(self, works, received: List[torch.Tensor], device, route):
        self._works, self._received = works, received
        self._device, self._route = device, route

    def wait(self) -> Tuple[torch.Tensor, ...]:
        for w in self._works:
            w.wait()
        if self._route == "gloo+host":
            return tuple(_to_card(t, self._device) for t in self._received)
        return tuple(self._received)


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axes, *,
               reverse: bool = False) -> PendingShift:
    """Start sending ``tensors`` to the next rank along ``axes`` (index
    + 1, mod the ring; index - 1 with ``reverse``) and receiving the
    previous rank's into new tensors of the same shapes (one
    ``batch_isend_irecv``); a ring of one sends nothing and returns the
    tensors themselves."""
    tensors = [t.contiguous() for t in tensors]
    ranks = mesh.ranks(axes)
    n = len(ranks)
    device = tensors[0].device
    if n == 1:
        return PendingShift([], tensors, device, "none")
    route = transport(_backend(mesh, axes), device)
    sent = sum(_nbytes(t) for t in tensors)
    step = -1 if reverse else 1
    _record("send_recv", mesh, axes, sent, sent,
            pairs=[(i, (i + step) % n) for i in range(n)])
    if route == "fake":
        return PendingShift([], [torch.empty_like(t) for t in tensors],
                            device, route)
    group = mesh.group(axes)
    me = mesh.axis_index(axes)
    nxt, prv = ranks[(me + step) % n], ranks[(me - step) % n]
    if route == "gloo+host":
        tensors = [_to_host(t) for t in tensors]
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in received]
    return PendingShift(dist.batch_isend_irecv(ops), received, device, route)


def all_gather_dim(x: torch.Tensor, mesh, axes,
                   dim: int = 1) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in the order of their
    index along ``axes`` (equal shapes on every rank)."""
    ranks = mesh.ranks(axes)
    if len(ranks) == 1:
        return x
    route = transport(_backend(mesh, axes), x.device)
    _record("all_gather", mesh, axes, _nbytes(x), len(ranks) * _nbytes(x))
    if route == "fake":
        return torch.cat([torch.empty_like(x)] * len(ranks), dim)
    src = _to_host(x) if route == "gloo+host" else x.contiguous()
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=mesh.group(axes))
    out = torch.cat(parts, dim)
    return _to_card(out, x.device) if route == "gloo+host" else out


def axis_mean(tensors: Sequence[torch.Tensor], mesh,
              axes) -> List[torch.Tensor]:
    """The mean of each tensor over the ranks along ``axes``, the same bits
    on every rank (``jax.lax.pmean``'s counterpart).

    Every rank's tensors, flattened into one buffer, are cut into N slices
    (N ranks); slice j of every rank goes to rank j (``all_to_all``), which
    adds them in rank order, ``((s_0 + s_1) + s_2) + ...``, and divides by
    N; the N mean slices are then all-gathered.  Every element is summed
    in rank order whatever the transport, so the bits are fixed by N
    alone: the same over gloo on host tensors, over gloo through host
    copies and over NCCL, from run to run and across a kill and a resume.
    An ``all_reduce(SUM)`` moves as many bytes, but adds in its
    algorithm's order (gloo's ring and NCCL's differ), so a run's bits
    would depend on the transport; an all-gather of the whole buffers
    would fix the order too, at twice the bytes.  Over a gloo group the
    slices are added on the host, where float32 addition and division
    give the card's bits, and only the mean goes back to the card.  One
    rank returns the tensors unchanged (``x / 1`` is ``x``).
    """
    tensors = list(tensors)
    ranks = mesh.ranks(axes)
    n = len(ranks)
    if n == 1:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"axis_mean takes tensors of one dtype; got "
                         f"{sorted(map(str, dtypes))}")
    device = tensors[0].device
    group = mesh.group(axes)
    route = transport(_backend(mesh, axes), device)
    nbytes = sum(_nbytes(t) for t in tensors)
    _record("all_reduce", mesh, axes, nbytes, nbytes)
    if route == "fake":
        out = [torch.empty_like(t) for t in tensors]
        _summed(tensors, out, axes)
        return out
    flat = torch.cat([t.reshape(-1) for t in tensors])
    size = flat.numel()
    if size % n:
        flat = torch.cat([flat, flat.new_zeros(n - size % n)])
    src = _to_host(flat) if route == "gloo+host" else flat
    received = torch.empty_like(src)
    dist.all_to_all_single(received, src, group=group)
    slices = received.view(n, -1)          # row j: rank j's slice of ours
    total = slices[0].clone()
    for s in slices[1:]:
        total += s
    mean = total / torch.full((), n, dtype=total.dtype, device=total.device)
    parts = [torch.empty_like(mean) for _ in ranks]
    dist.all_gather(parts, mean, group=group)
    mean = torch.cat(parts)[:size]
    if route == "gloo+host":
        mean = _to_card(mean, device)
    out, lo = [], 0
    for t in tensors:
        out.append(mean[lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
    _summed(tensors, out, axes)
    return out


# ---------------------------------------------------------------------------
# the sharded trainer's collectives: sums in rank order, and their autograd
# ---------------------------------------------------------------------------
#
# Every collective below moves bytes only (an all-gather or an all-to-all,
# bfloat16 as the same bits viewed as float16, a type every transport
# moves); every sum is taken on the receiving
# rank in rank order.  So a result's bits depend on the rank count alone,
# not on the transport or the run, as ``axis_mean``'s do: a killed and
# resumed sharded run repeats the uninterrupted one bit for bit.

_BITS16 = (torch.bfloat16,)


def _send(t: torch.Tensor, route: str) -> torch.Tensor:
    t = t.contiguous()
    if route == "gloo+host":
        t = _to_host(t)
    return t.view(torch.float16) if t.dtype in _BITS16 else t


def _received(t: torch.Tensor, dtype, device, route: str) -> torch.Tensor:
    if dtype in _BITS16:
        t = t.view(dtype)
    return _to_card(t, device) if route == "gloo+host" else t


def gather_parts(x: torch.Tensor, mesh, axes, *,
                 kind: str = "all_gather") -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axes``, in the order of their index
    (equal shapes on every rank); ``[x]`` on one rank.  ``kind`` is what
    the caller computes from the parts, as ``COLLECTIVES`` counts it: an
    ``all_gather`` or an ``all_reduce`` (a sum or a max of them)."""
    ranks = mesh.ranks(axes)
    if len(ranks) == 1:
        return [x]
    route = transport(_backend(mesh, axes), x.device)
    _record(kind, mesh, axes, _nbytes(x),
            _nbytes(x) * (len(ranks) if kind == "all_gather" else 1))
    if route == "fake":
        return [torch.empty_like(x) for _ in ranks]
    src = _send(x, route)
    # the parts land in one buffer (page-locked for a card's tensors),
    # which goes to the card in one copy
    out = torch.empty((len(ranks),) + tuple(src.shape), dtype=src.dtype,
                      device=src.device,
                      pin_memory=route == "gloo+host")
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group(axes))
    return list(_received(out, x.dtype, x.device, route).unbind(0))


def _rank_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    if parts[0].device.type == "meta":
        return parts[0].clone()      # a sum of meta parts: its shape alone
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def _all_to_all(x: torch.Tensor, mesh, axes, split_dim: int,
                kind: str) -> List[torch.Tensor]:
    """Cut ``x`` into N equal blocks along ``split_dim`` and send block j to
    the rank of index j; returns the N blocks received, in rank order.
    ``kind``: ``all_to_all``, or ``reduce_scatter`` when the caller sums
    the blocks (``COLLECTIVES``)."""
    n = len(mesh.ranks(axes))
    route = transport(_backend(mesh, axes), x.device)
    _record(kind, mesh, axes, _nbytes(x),
            _nbytes(x) // (n if kind == "reduce_scatter" else 1))
    blocks = x.movedim(split_dim, 0)
    blocks = blocks.reshape((n, blocks.shape[0] // n) + blocks.shape[1:])
    if route == "fake":
        return [b.movedim(0, split_dim)
                for b in torch.empty_like(blocks).unbind(0)]
    src = _send(blocks, route)
    recv = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                       pin_memory=route == "gloo+host")
    dist.all_to_all_single(recv, src, group=mesh.group(axes))
    recv = _received(recv, x.dtype, x.device, route)
    return [b.movedim(0, split_dim) for b in recv.unbind(0)]


def reduce_scatter_dim(x: torch.Tensor, mesh, axes,
                       dim: int) -> torch.Tensor:
    """This rank's block (its index along ``axes``) of the sum over the
    ranks of ``x`` cut into N blocks along ``dim``, summed in rank
    order."""
    if len(mesh.ranks(axes)) == 1:
        return x
    out = _rank_sum(_all_to_all(x, mesh, axes, dim, "reduce_scatter"))
    _summed([x], [out], axes)
    return out


def axis_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes``, in rank order, the
    same bits on every rank; ``x`` itself on one rank."""
    if _one_rank(mesh, axes):
        return x
    out = _rank_sum(gather_parts(x, mesh, axes, kind="all_reduce"))
    _summed([x], [out], axes)
    return out


def axis_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks along ``axes``."""
    if len(mesh.ranks(axes)) == 1:
        return x
    return torch.stack(gather_parts(x, mesh, axes,
                                    kind="all_reduce")).amax(0)


def reshard_dims(x: torch.Tensor, mesh, axes, split_dim: int,
                 cat_dim: int) -> torch.Tensor:
    """``x``, sharded along ``cat_dim`` over ``axes``, resharded along
    ``split_dim`` (one all-to-all): every rank's block j of ``split_dim``
    goes to rank j, which puts the blocks together along ``cat_dim``."""
    if len(mesh.ranks(axes)) == 1:
        return x
    return torch.cat(_all_to_all(x, mesh, axes, split_dim, "all_to_all"),
                     cat_dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(gather_parts(g, ctx.mesh, ctx.axes), ctx.dim), \
            None, None, None


class _SumForward(torch.autograd.Function):
    """Megatron's g: the sum over the ranks forward, the identity back."""
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return axis_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over the ranks back."""
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return axis_sum(g, ctx.mesh, ctx.axes), None, None


class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, cat_dim):
        ctx.args = (mesh, axes, split_dim, cat_dim)
        return reshard_dims(x, mesh, axes, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, cat_dim = ctx.args
        return reshard_dims(g, mesh, axes, cat_dim, split_dim), \
            None, None, None, None


def _one_rank(mesh, axes) -> bool:
    return mesh is None or not axes or len(mesh.ranks(axes)) == 1


def all_gather_grad(x, mesh, axes, dim: int):
    """Differentiable all-gather along ``dim``: the backward sums the
    gradient over the ranks and keeps this rank's block (reduce-scatter)."""
    return all_gather_many([x], [dim], mesh, axes)[0]


def reduce_scatter_grad(x, mesh, axes, dim: int):
    """Differentiable reduce-scatter along ``dim``: the backward gathers."""
    return x if _one_rank(mesh, axes) else _ReduceScatter.apply(x, mesh,
                                                                axes, dim)


def sum_forward(x, mesh, axes):
    """The sum over the ranks, its gradient passed through unchanged."""
    return x if _one_rank(mesh, axes) else _SumForward.apply(x, mesh, axes)


def sum_backward(x, mesh, axes):
    """``x`` unchanged, its gradient summed over the ranks."""
    return x if _one_rank(mesh, axes) else _SumBackward.apply(x, mesh, axes)


def sum_both(x, mesh, axes):
    """The sum over the ranks forward and back (an all-reduce whose
    gradient is all-reduced): for a sum that every rank's own, rank-local
    work consumes, so that each rank's gradient of it is a partial one
    (the gated RMSNorm's sum of squares over the heads' ranks)."""
    return sum_backward(sum_forward(x, mesh, axes), mesh, axes)


def max_nograd(x, mesh, axes):
    """The max over the ranks, outside the graph (logsumexp's shift, the
    int8 scale)."""
    x = x.detach()
    return x if _one_rank(mesh, axes) else axis_max(x, mesh, axes)


def reshard_grad(x, mesh, axes, split_dim: int, cat_dim: int):
    """Differentiable ``reshard_dims``; the backward reshards back."""
    return x if _one_rank(mesh, axes) else _Reshard.apply(
        x, mesh, axes, split_dim, cat_dim)


def _gather_many(xs, dims, mesh, axes):
    """Every rank's ``xs[i]`` concatenated along ``dims[i]``, for all i in
    one all-gather (the tensors flattened into one buffer, one dtype)."""
    flat = torch.cat([x.movedim(d, 0).reshape(-1) for x, d in zip(xs, dims)])
    parts = gather_parts(flat, mesh, axes)
    out, lo = [], 0
    for x, d in zip(xs, dims):
        size = x.numel()
        moved = x.movedim(d, 0).shape
        blocks = [p[lo:lo + size].view(moved).movedim(0, d) for p in parts]
        out.append(torch.cat(blocks, d))
        lo += size
    return out


def _reduce_scatter_many(gs, dims, mesh, axes):
    """``reduce_scatter_dim`` of every ``gs[i]`` along ``dims[i]`` in one
    all-to-all: block j of every tensor, flattened, goes to rank j."""
    n = len(mesh.ranks(axes))
    moved = [g.movedim(d, 0) for g, d in zip(gs, dims)]
    rows = torch.cat([m.reshape(n, -1) for m in moved], 1)   # (n, total)
    summed = reduce_scatter_dim(rows, mesh, axes, 0)[0]
    out, lo = [], 0
    for m, d in zip(moved, dims):
        size = m.numel() // n
        out.append(summed[lo:lo + size].view(
            (m.shape[0] // n,) + m.shape[1:]).movedim(0, d).contiguous())
        lo += size
    return out


class _AllGatherMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dims, *xs):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        out = tuple(_gather_many(xs, dims, mesh, axes))
        ctx.like = [(o.shape, o.dtype, o.device) for o in out]
        return out

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
              for g, (shape, dt, dev) in zip(gs, ctx.like)]
        return (None, None, None) + tuple(
            _reduce_scatter_many(gs, ctx.dims, ctx.mesh, ctx.axes))


def all_gather_many(xs, dims, mesh, axes):
    """``all_gather_grad`` of every ``xs[i]`` along ``dims[i]`` (one dtype)
    in one collective each way: the FSDP gather of a unit's leaves."""
    if _one_rank(mesh, axes) or not xs:
        return list(xs)
    return list(_AllGatherMany.apply(mesh, axes, tuple(dims), *xs))
