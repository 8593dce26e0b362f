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

from repro_torch.launch.collectives import (all_gather_dim, all_gather_grad,
                                            all_gather_many,
                                            reduce_scatter_grad, sum_forward)
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


def seq_rows(x: torch.Tensor, mesh, axes, s: int) -> torch.Tensor:
    """This rank's ``s`` rows of the whole sequence ``x`` (dim 1), the
    shard of index ``mesh.axis_index(axes)`` (a view); x itself without
    axes.  A block that gathers the sequence and runs it whole keeps its
    own rows so."""
    if not axes or s == x.shape[1]:
        return x
    return x.narrow(1, mesh.axis_index(axes) * s, s)


def batch_axes(rules: AxisRules) -> Tuple[str, ...]:
    """The mesh axes of the batch under ``rules``."""
    return _axes(rules.rules.get("batch"))


# ---------------------------------------------------------------------------
# trees of specs: the sharded trainer's layout
# ---------------------------------------------------------------------------
#
# A spec tree (``training.trainer.param_pspecs`` and friends) is shaped like
# a tree of tensors, a spec tuple (``AxisRules.resolve``'s) at each tensor's
# place.  Spec tuples are walked alongside the tensors' tree, never on
# their own: a spec is a tuple, and so are some of the trees' nodes.

def named_leaves(tree, path=()):
    """(path of dict keys, field names and tuple indices, tensor) for each
    tensor of ``tree``, in the reference's leaf order (dicts by sorted
    key)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], path + (k,))]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in named_leaves(getattr(tree, f), path + (f,))]
    return [x for i, t in enumerate(tree)
            for x in named_leaves(t, path + (i,))]


def spec_at(specs, path):
    """The spec at ``path`` (``named_leaves``') of a spec tree."""
    for key in path:
        specs = getattr(specs, key) if isinstance(key, str) and \
            hasattr(specs, "_fields") else specs[key]
    return specs


def named_specs(tree, specs):
    """(path, spec) at each tensor of ``tree``, from the spec tree."""
    return [(path, spec_at(specs, path)) for path, _ in named_leaves(tree)]


def map_specs(fn, tree, specs):
    """``tree`` rebuilt with ``fn(tensor, spec)`` at each tensor."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, getattr(tree, f),
                                      getattr(specs, f))
                            for f in tree._fields))
    return type(tree)(map_specs(fn, t, s) for t, s in zip(tree, specs))


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over."""
    return tuple(a for entry in (spec or ()) for a in _axes(entry))


def shard_bounds(shape, spec, mesh):
    """[(lo, hi)] per dim: this rank's slice of a global tensor of
    ``shape`` under ``spec`` (whose dims divide, as the spec functions
    make them)."""
    out = []
    for d, dim in enumerate(shape):
        ax = spec[d] if spec is not None and d < len(spec) else None
        if ax is None:
            out.append((0, dim))
            continue
        n = axis_size(mesh, ax)
        size = dim // n
        lo = mesh.axis_index(ax) * size
        out.append((lo, lo + size))
    return out


def shard_of(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's slice of the global tensor ``x`` under ``spec`` (a
    view)."""
    for d, (lo, hi) in enumerate(shard_bounds(x.shape, spec, mesh)):
        if hi - lo != x.shape[d]:
            x = x.narrow(d, lo, hi - lo)
    return x


def owns_replica(mesh, spec) -> bool:
    """True on the one rank of each replica set of a leaf under ``spec``:
    index 0 along every mesh axis the spec does not shard over."""
    held = spec_axes(spec)
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in held)


def shard_params(tree, rules: AxisRules, specs):
    """Each rank's slices of a tree of global tensors (the leading unit
    axis included), as tensors of their own."""
    return map_specs(lambda x, sp: shard_of(x, rules.mesh, sp).clone(),
                     tree, specs)


def gather_params(tree, rules: AxisRules, specs):
    """The global tensors of a tree of every rank's ``shard_params``
    slices: an all-gather along each sharded dim, on every rank."""
    def whole(x, spec):
        for d, ax in enumerate(spec or ()):
            if ax is not None:
                x = all_gather_dim(x, rules.mesh, ax, dim=d)
        return x

    return map_specs(whole, tree, specs)


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """The sharded layout of training and serving (FSDP x TP,
    Megatron-SP): ``rules`` over the mesh and the parameters' spec tree
    (``param_pspecs``).

    Each rank holds its slice of every parameter.  Just before a unit
    runs, its leaves' ``fsdp`` dims are all-gathered (``gather_tree``; the
    backward reduce-scatters the gradient), so a layer sees each leaf
    sharded over ``tp`` alone.  The residual stream is this rank's rows
    of the batch (``batch``) and its shard of the sequence (``sp``).

    ``one_token``: a decode step's residual stream, one token that cannot
    be split over ``sp``, whole on every rank (the reference degrades it
    to replicated): ``sp_axes`` is then empty, and the row-parallel
    projections' partial sums are summed over ``tp`` on every rank
    (``row_reduce``) instead of reduce-scattered."""
    rules: AxisRules
    specs: dict
    one_token: bool = False

    @property
    def mesh(self):
        return self.rules.mesh

    def axes(self, logical: str) -> Tuple[str, ...]:
        return _axes(self.rules.rules.get(logical))

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        return self.axes("tp")

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, self.tp_axes)

    @property
    def sp_axes(self) -> Tuple[str, ...]:
        return () if self.one_token else self.axes("sp")

    @property
    def sp(self) -> int:
        return axis_size(self.mesh, self.sp_axes)

    def tp_index(self) -> int:
        return self.mesh.axis_index(self.tp_axes) if self.tp_axes else 0

    def row_reduce(self, out: torch.Tensor) -> torch.Tensor:
        """A row-parallel projection's partial sums (B, S, D) -> this
        rank's part of the residual stream: reduce-scattered to the
        sequence shards over ``sp``, or under ``one_token`` summed over
        ``tp`` in rank order, the same bits on every rank."""
        if self.one_token:
            return sum_forward(out, self.mesh, self.tp_axes)
        return reduce_scatter_grad(out, self.mesh, self.sp_axes, 1)

    def gather_tree(self, tree, specs):
        """The leaves of a tree with their ``fsdp``-sharded dim gathered
        whole (differentiable: the backward reduce-scatters the gradient),
        just before use, so a layer sees each leaf sharded over ``tp``
        alone.  The leaves that share their gathered axes and dtype go in
        one collective (a unit's weights: one or two all-gathers, not one
        a leaf)."""
        fsdp = set(self.axes("fsdp"))
        named = named_leaves(tree)
        out = [t for _, t in named]
        groups = {}
        for i, (path, t) in enumerate(named):
            spec = spec_at(specs, path) or ()
            dims = [d for d, ax in enumerate(spec)
                    if _axes(ax) and set(_axes(ax)) <= fsdp]
            if dims:    # the reference's specs shard one dim over fsdp
                key = (_axes(spec[dims[0]]), t.dtype)
                groups.setdefault(key, []).append((i, dims[0]))
        for (axes, _), members in groups.items():
            got = all_gather_many([out[i] for i, _ in members],
                                  [d for _, d in members], self.mesh, axes)
            for (i, _), t in zip(members, got):
                out[i] = t
        it = iter(out)
        return map_specs(lambda _t, _s: next(it), tree, specs)

    def gather_tp(self, tree, specs):
        """The leaves of a tree (a block's, ``fsdp`` already gathered)
        with their ``tp``-sharded dim gathered whole (differentiable: the
        backward reduce-scatters the gradient): a block that runs whole on
        every rank of ``tp``."""
        def whole(t, spec):
            for d in range(len(spec or ())):
                if self.tp_sharded(spec, d):
                    return all_gather_grad(t, self.mesh, self.tp_axes, d)
            return t
        return map_specs(whole, tree, specs)

    def tp_sharded(self, spec, dim: int) -> bool:
        """True where dim ``dim`` of a leaf under ``spec`` is sharded over
        the ``tp`` axes (False on a one-rank ``tp``)."""
        if self.tp == 1 or spec is None:
            return False
        return bool(_axes(spec[dim])) and set(_axes(spec[dim])) == \
            set(self.tp_axes)

    def grad_axes(self, spec) -> Tuple[str, ...]:
        """The axes a leaf's gradient is summed over after the backward:
        those of the batch and of the sequence that its spec does not
        shard over (a sharded dim's sum is the gather's reduce-scatter)."""
        held = set(spec_axes(spec))
        want = self.axes("batch") + self.sp_axes
        return tuple(a for a in self.mesh.axis_names
                     if a in want and a not in held)


class CacheShards(tuple):
    """``init_caches(rules=)``'s caches: a tuple of entries, one a block
    of the pattern, each leaf this rank's shard; ``shapes`` holds the
    global caches' shapes and ``specs`` the specs they were cut by
    (``cache_pspecs``), in the entries' structure."""

    def __new__(cls, entries, shapes, specs):
        out = super().__new__(cls, entries)
        out.shapes, out.specs = shapes, specs
        return out
