"""The dry run's accounting of one step: matmul FLOPs, bytes and
collective bytes a rank (the port's counterpart of
``repro.launch.hlo_analysis``, by name only).

The reference parses the HLO text that XLA compiled.  The port has no
HLO: this module counts the port's own graph, op by op, as the step runs
(on ``meta`` tensors in the dry run, or on real ones):

  * ``dot_flops``: the matrix products that PyTorch dispatches (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, convolutions: ``torch.utils.
    flop_counter``'s formulas, 2 x out x contraction), plus rows 8 and 9
    of the TPU kernel table on their ``meta`` route (``flash_attention.
    META_WORK``: 4 D FLOPs per visible (query, key) pair and head);
  * ``bytes_accessed``: the operands and outputs of those products, of
    the row 8 and 9 calls and of the collectives, each read or written
    once.  Elementwise ops, norms, softmaxes, gathers and copies are not
    counted.  This is not the reference's TPU fusion model, and nothing
    compares the two;
  * ``collective_bytes`` and ``n_collectives`` by kind: the difference
    of ``launch.collectives.COLLECTIVES`` over the step (the wire bytes a
    rank by the reference's model; see that module).

The backward is counted as the port runs it: autograd's products, the
plain chunked recompute behind row 8 and the reverse ring behind row 9
(plain PyTorch, whose products count whole chunks, masked or not), and
each checkpointed unit's forward again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash_attention
from repro_torch.launch import collectives

COLLECTIVES = collectives.COLLECTIVE_KINDS


@dataclasses.dataclass
class GraphStats:
    """The reference's ``HLOStats`` fields (no loop trips: nothing is a
    loop here), counted on the port's graph."""
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    n_collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})
    # calls by kind and mesh axes ("data,model")
    collective_axes: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {c: {} for c in COLLECTIVES})
    flash_flops: float = 0.0      # the part of dot_flops from rows 8 / 9
    flash_calls: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def combine(self, other: "GraphStats", a: float,
                b: float) -> "GraphStats":
        """``a * self + b * other``, field by field (the extrapolation of
        repeated work)."""
        lin = lambda x, y: a * x + b * y   # noqa: E731
        return GraphStats(
            dot_flops=lin(self.dot_flops, other.dot_flops),
            bytes_accessed=lin(self.bytes_accessed, other.bytes_accessed),
            collective_bytes={c: lin(self.collective_bytes[c],
                                     other.collective_bytes[c])
                              for c in COLLECTIVES},
            n_collectives={c: int(lin(self.n_collectives[c],
                                      other.n_collectives[c]))
                           for c in COLLECTIVES},
            collective_axes={c: {k: int(lin(self.collective_axes[c].get(
                k, 0), other.collective_axes[c].get(k, 0))) for k in sorted(
                    set(self.collective_axes[c])
                    | set(other.collective_axes[c]))} for c in COLLECTIVES},
            flash_flops=lin(self.flash_flops, other.flash_flops),
            flash_calls=int(lin(self.flash_calls, other.flash_calls)))

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "bytes_accessed": self.bytes_accessed,
                "collective_bytes": dict(self.collective_bytes),
                "total_collective_bytes": self.total_collective_bytes,
                "n_collectives": dict(self.n_collectives),
                "collective_axes": {c: dict(v) for c, v in
                                    self.collective_axes.items()},
                "flash_flops": self.flash_flops,
                "flash_calls": self.flash_calls}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class GraphCounter(TorchDispatchMode):
    """Counts the matrix products' FLOPs and operand + output bytes of
    everything dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)))
        return out


def analyze(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counter; returns
    (its result, ``GraphStats``)."""
    flash_attention.reset_meta_work()
    before = collectives.collectives_snapshot()
    counter = GraphCounter()
    with counter:
        result = fn(*args, **kwargs)
    after = collectives.collectives_snapshot()
    stats = GraphStats()
    work = flash_attention.META_WORK.values()
    stats.flash_flops = float(sum(w["flops"] for w in work))
    stats.flash_calls = sum(w["calls"] for w in work)
    stats.dot_flops = float(counter.flops) + stats.flash_flops
    coll_io = 0
    for kind in COLLECTIVES:
        stats.collective_bytes[kind] = float(after[kind]["bytes"]
                                             - before[kind]["bytes"])
        stats.n_collectives[kind] = after[kind]["count"] - \
            before[kind]["count"]
        coll_io += after[kind]["io_bytes"] - before[kind]["io_bytes"]
        axes = after[kind]["axes"]
        stats.collective_axes[kind] = {
            k: n - before[kind]["axes"].get(k, 0) for k, n in axes.items()
            if n != before[kind]["axes"].get(k, 0)}
    stats.bytes_accessed = float(counter.bytes + sum(
        w["bytes"] for w in work) + coll_io)
    return result, stats
