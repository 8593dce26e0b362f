"""Collectives over a mesh axis: the ring shift of a tuple of tensors and
the all-gather along one dimension that the sequence-parallel attention
needs (the sequence's, for K/V), and the mean over the ``data`` axis that
the data-parallel trainer takes of its loss and gradients.

The group's backend decides how a tensor moves:
  * ``nccl``: CUDA tensors move directly between cards (one rank a card);
  * ``gloo``: host tensors.  A CPU tensor moves as it is.  A CUDA tensor is
    copied to a host buffer before it is sent and back to its card after
    it is received: the transport for several ranks that share one card,
    where NCCL refuses to run (it takes one rank a device).  Those copies
    are explicit and counted in ``HOST_COPIES``.
Nothing retries one transport after another fails, and a tensor that the
group's backend cannot move raises.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

# bytes and tensors copied between a card and the host for a gloo group
HOST_COPIES = {"bytes": 0, "tensors": 0}


def reset_host_copies() -> None:
    for key in HOST_COPIES:
        HOST_COPIES[key] = 0


def transport(backend: str, device) -> str:
    """How a tensor on ``device`` moves over a group of ``backend``:
    ``"nccl"``, ``"gloo"`` (host tensors as they are) or ``"gloo+host"``
    (a CUDA tensor through host copies)."""
    device = torch.device(device)
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
    HOST_COPIES["bytes"] += t.numel() * t.element_size()
    HOST_COPIES["tensors"] += 1
    return t.to("cpu")


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


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axes) -> PendingShift:
    """Start sending ``tensors`` to the next rank along ``axes`` (index
    + 1, mod the ring) and receiving the previous rank's into new tensors
    of the same shapes (one ``batch_isend_irecv``); a ring of one sends
    nothing and returns the tensors themselves."""
    tensors = [t.contiguous() for t in tensors]
    ranks = mesh.ranks(axes)
    n = len(ranks)
    device = tensors[0].device
    if n == 1:
        return PendingShift([], tensors, device, "none")
    group = mesh.group(axes)
    route = transport(_backend(mesh, axes), device)
    me = mesh.axis_index(axes)
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
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
    return out
