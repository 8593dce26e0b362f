"""Logical-axis rules: one place that maps names -> mesh axes.

Port of ``repro.models.sharding``.  The active ``AxisRules`` (installed
with ``use_rules``) resolve logical names such as ``"batch"`` or ``"sp"``
to mesh axes; with no rules installed every layer runs on one device.

Default mapping (the reference's):
    batch    -> ("pod", "data")     data parallel (no "pod" axis here)
    fsdp     -> "data"              param & optimizer-state sharding
    tp       -> "model"             tensor parallel
    sp       -> "model"             sequence parallel (residual stream)
    kv_seq   -> "model"             decode-time KV-cache sequence sharding
    long_seq -> ("data", "model")   524k-token cache sharding
    experts  -> "model"             expert parallel
    vocab    -> "model"             the logits' vocabulary

The reference annotates global arrays with ``shard(x, ...)`` and leaves
the partitioning to GSPMD.  The port has no counterpart of ``shard``: each
rank holds its local shard explicitly, and the code that needs another
rank's data calls a collective (``repro_torch.launch.collectives``).
``local_shard`` and ``gather_shards`` cut a global tensor to this rank's
shard and put the shards back together, with the reference's per-dimension
policy: a dimension whose size does not divide by its axes' product stays
whole (replicated) on every rank.  The one exception is the residual
stream's sequence (``"sp"``): the reference runs a sequence that does not
divide replicated, on the one-device route, but a rank here cannot tell a
replicated sequence from its shard, whose positions start at
``index * S``, so such a sequence raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.collectives import all_gather_dim
from repro_torch.launch.mesh import axis_size

Axis = Union[str, Sequence[str], None]

_STATE = threading.local()


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    mesh: object            # repro_torch.launch.mesh.Mesh
    rules: dict

    def resolve(self, *logical: Axis) -> tuple:
        """Logical names -> one mesh-axis entry per dimension: None, an
        axis name, or a tuple of names (the reference's PartitionSpec)."""
        out = []
        for name in logical:
            if name is None:
                out.append(None)
                continue
            if isinstance(name, str):
                out.append(self.rules.get(name, None))
                continue
            # tuple of logical names -> concatenated mesh axes
            axes = []
            for n in name:
                m = self.rules.get(n, n) if isinstance(n, str) else n
                if m is None:
                    continue
                axes.extend((m,) if isinstance(m, str) else list(m))
            out.append(tuple(axes) if len(axes) > 1 else
                       (axes[0] if axes else None))
        return tuple(out)

    def axes_size(self, entry) -> int:
        return axis_size(self.mesh, entry)

    def _fixed(self, shape, logical):
        """The resolved spec with the dims that do not divide replicated;
        an ``"sp"`` dim that does not divide raises (module docstring)."""
        out = []
        for dim, ax, name in zip(shape, self.resolve(*logical), logical):
            if ax is not None and dim % self.axes_size(ax):
                if name == "sp":
                    raise ValueError(
                        f"a sequence of {dim} does not divide over the "
                        f"{self.axes_size(ax)} ranks of {ax!r}: the "
                        f"sequence-parallel forward holds it sharded; run "
                        f"it without rules, or pad it to a multiple")
                ax = None
            out.append(ax)
        return tuple(out)


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "tp": "model",
    "sp": "model",
    "kv_seq": "model",
    "long_seq": ("data", "model"),
    "experts": "model",
    "vocab": "model",
}


def make_rules(mesh, overrides: Optional[dict] = None) -> AxisRules:
    rules = dict(DEFAULT_RULES)

    # drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh)
    def filt(v):
        axes = tuple(a for a in _axes(v) if a in mesh.shape)
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    rules = {k: filt(v) for k, v in rules.items()}
    if overrides:
        rules.update({k: filt(v) for k, v in overrides.items()})
    return AxisRules(mesh=mesh, rules=rules)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


def seq_shards(rules: Optional[AxisRules] = None):
    """(seq_axes, n): the mesh axes the residual stream's sequence is
    sharded over under ``rules`` (default: the current ones), the
    reference's choice in ``_flash_shard_axes`` (``sp``, else ``tp``), and
    the product of their sizes; ((), 1) without rules."""
    rules = current_rules() if rules is None else rules
    if rules is None:
        return (), 1
    axes = _axes(rules.rules.get("sp") or rules.rules.get("tp"))
    return axes, rules.axes_size(axes)


def local_shard(x: torch.Tensor, rules: AxisRules,
                *logical: Axis) -> torch.Tensor:
    """This rank's shard of the global tensor ``x`` under ``logical``
    names, one per leading dimension (a view)."""
    for dim, ax in enumerate(rules._fixed(x.shape, logical)):
        if ax is None:
            continue
        n = rules.axes_size(ax)
        size = x.shape[dim] // n
        x = x.narrow(dim, rules.mesh.axis_index(ax) * size, size)
    return x


def gather_shards(x: torch.Tensor, rules: AxisRules, global_shape,
                  *logical: Axis) -> torch.Tensor:
    """The global tensor of shape ``global_shape`` from every rank's
    ``local_shard`` of it (an all-gather along each sharded dimension)."""
    for dim, ax in enumerate(rules._fixed(global_shape, logical)):
        if ax is not None:
            x = all_gather_dim(x, rules.mesh, ax, dim=dim)
    return x
