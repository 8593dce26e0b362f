"""Collective audit over ``launch.collectives``' record (the counterpart
of ``repro.analysis.collectives``).

The reference walks each ``shard_map`` body for psums and ppermutes.  The
port's collectives are calls into ``launch/collectives.py``, which tells
its hooks of each one (kind, mesh axes, group size, a ring shift's
(source, destination) pairs) and of each sum's inputs and result.  A site
runs on the ``fake`` route (a fake process group, ``meta`` tensors: the
dry run's counting route) under ``audit_collectives``, which checks

  * every collective names axes of the site's mesh (an unbound axis
    raises in ``Mesh``; the audit turns that into a finding);
  * every ring shift is a true permutation of its axis
    (``check_permutation``, the reference's, as it is);
  * no sum consumes a value already summed over the same axes (a
    gradient reduced twice is scaled by the axis size): each op's result
    inherits the axes its inputs were summed over (a dispatch mode),
    and a sum over axes its input already carries is a finding;
  * where the site declares them, the tensors summed over its blessed
    axes (``expected_sums``, the reference's expected psum count: one
    per gradient leaf and one for the loss) and its counts by kind and
    axes (``expected_counts``).

``step_counts(cfg, rules)`` gives the counts a sharded LM train step's
layout implies (ROADMAP A13): the FSDP gathers a unit, forward and
recompute, and their reduce-scatters; the tp sums, gathers and
reduce-scatters a layer by block kind; the attention routes; the loss's
vocab sums; the gradient sums of ``to_param_layout``; the global norm.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.launch import collectives as coll
from ._dispatch import OpWatch, storage_key, tensors_in
from .report import Finding

__all__ = ["audit_collectives", "check_permutation", "record_collectives"]


def check_permutation(perm, size: int) -> List[str]:
    """Why ``perm`` is not a permutation of ``range(size)``; [] if it is."""
    errs: List[str] = []
    pairs = [tuple(p) for p in perm]
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    oob = [p for p in pairs
           if not (0 <= p[0] < size and 0 <= p[1] < size)]
    if oob:
        errs.append(f"pairs {oob[:4]} reference shards outside the axis "
                    f"size {size}")
    if len(set(srcs)) != len(srcs):
        errs.append(f"duplicate sources {sorted(set(s for s in srcs if srcs.count(s) > 1))}"
                    f" — a shard cannot send twice")
    if len(set(dsts)) != len(dsts):
        errs.append(f"duplicate destinations "
                    f"{sorted(set(d for d in dsts if dsts.count(d) > 1))}"
                    f" — two shards write the same receiver")
    if not errs and len(pairs) != size:
        errs.append(f"{len(pairs)} pairs for an axis of {size} shards — "
                    f"unmatched shards receive unspecified data")
    return errs


class _Recorder:
    """The calls and sums of a run, and the axes each storage's value was
    summed over."""

    def __init__(self):
        self.calls: List[dict] = []
        self.sums: List[tuple] = []     # (axes, tensors summed, twice over)
        self._taint: Dict[int, frozenset] = {}

    def taint_of(self, t) -> frozenset:
        return self._taint.get(storage_key(t), frozenset())

    def on_call(self, call):
        self.calls.append(call)

    def on_sum(self, inputs, outputs, axes):
        axes = frozenset((axes,) if isinstance(axes, str) else axes)
        twice = sorted({a for t in inputs for a in self.taint_of(t) & axes})
        self.sums.append((tuple(sorted(axes)), len(inputs), twice))
        for t in outputs:
            self._taint[storage_key(t)] = frozenset().union(
                axes, *(self.taint_of(i) for i in inputs))

    def after(self, func, args, kwargs, out):
        src = frozenset().union(*(self.taint_of(t)
                                  for t in tensors_in((args, kwargs))))
        for t in tensors_in(out):
            self._taint[storage_key(t)] = src


def record_collectives(fn, *args):
    """(the result, the calls, the sums) of ``fn(*args)``."""
    rec = _Recorder()
    coll.CALL_HOOKS.append(rec.on_call)
    coll.REDUCE_HOOKS.append(rec.on_sum)
    try:
        with OpWatch(after=rec.after):
            out = fn(*args)
    finally:
        coll.CALL_HOOKS.remove(rec.on_call)
        coll.REDUCE_HOOKS.remove(rec.on_sum)
    return out, rec.calls, rec.sums


def counts_of(calls) -> Dict[str, Dict[str, int]]:
    """{kind: {"axis,axis": calls}} of a record."""
    out: Dict[str, Dict[str, int]] = {}
    for c in calls:
        key = ",".join(c["axes"])
        out.setdefault(c["kind"], {})
        out[c["kind"]][key] = out[c["kind"]].get(key, 0) + 1
    return out


def audit_collectives(fn, args, *, name: str = "collective-site",
                      mesh_axes=None,
                      expected_sums: Optional[int] = None,
                      sum_axes=None,
                      expected_counts: Optional[dict] = None,
                      double_sums: bool = True) -> List[Finding]:
    """Run ``fn(*args)`` on the fake route and apply the checks above;
    ``double_sums=False`` leaves out the sum-of-a-sum check, for a site
    whose every sum ``expected_counts`` pins (a step whose backward sums
    gradients of values its forward summed over the same axes, as the
    tensor-parallel LM step does by design)."""
    findings: List[Finding] = []

    def emit(message, **details):
        findings.append(Finding(check="collectives", target=name,
                                message=message, details=details))
    try:
        _, calls, sums = record_collectives(fn, *args)
    except ValueError as e:
        if "carry no" in str(e):
            return [Finding(check="collectives", target=name, message=(
                f"{e}: a collective names an axis the site's mesh does "
                f"not bind; fix the axes or the mesh"))]
        raise
    if not calls:
        findings.append(Finding(
            check="collectives", target=name, severity="warning",
            message="no collective ran: the site audited nothing"))
    for c in calls:
        if mesh_axes is not None:
            for a in c["axes"]:
                if a not in mesh_axes:
                    emit(f"{c['kind']} names axis {a!r} but the site's mesh "
                         f"binds {sorted(mesh_axes)}")
        if c["pairs"] is not None:
            for err in check_permutation(c["pairs"], c["size"]):
                emit(f"ring shift over {c['axes']} is not a true "
                     f"permutation: {err}",
                     perm=[list(p) for p in c["pairs"]], size=c["size"])
    for axes, _, twice in sums:
        if twice and double_sums:
            emit(f"a sum over {axes} consumes a value already summed over "
                 f"{twice}: gradients reduced twice are scaled by the axis "
                 f"size; keep the one sum at the blessed point "
                 f"(trainer.microbatch_grads)", axes=list(axes))
    if expected_sums is not None:
        want = tuple(sorted(sum_axes or ()))
        got = sum(n for axes, n, _ in sums if axes == want)
        if got != expected_sums:
            emit(f"expected {expected_sums} tensor(s) summed over {want} "
                 f"(the loss and one per gradient leaf, at the blessed "
                 f"point) but found {got}: a reduction moved or doubled",
                 expected=expected_sums, found=got)
        stray = sorted({axes for axes, _, _ in sums if axes != want})
        if stray:
            emit(f"sums over {stray} besides the blessed {want}")
    if expected_counts is not None:
        got = counts_of(calls)
        if got != expected_counts:
            emit(f"collectives by kind and axes {got} differ from the "
                 f"{expected_counts} the site's layout implies",
                 got=got, want=expected_counts)
    return findings


# ---------------------------------------------------------------------------
# the collectives a sharded LM train step's layout implies
# ---------------------------------------------------------------------------

class _Tally:
    """Collectives by kind and mesh axes; a call over one rank (which the
    collectives skip) is not counted."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.counts: Dict[str, Dict[str, int]] = {}

    def add(self, kind: str, axes, n: int = 1) -> None:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes or n <= 0 or len(self.mesh.ranks(axes)) == 1:
            return
        key = ",".join(self.mesh._key(axes))
        row = self.counts.setdefault(kind, {})
        row[key] = row.get(key, 0) + n

    def add_all(self, events, n: int = 1) -> None:
        for kind, axes in events:
            self.add(kind, axes, n)


# a differentiable collective's forward and its backward
_AG, _RS, _AR, _A2A, _SR = ("all_gather", "reduce_scatter", "all_reduce",
                            "all_to_all", "send_recv")
_BACKWARD = {_AG: _RS, _RS: _AG, _A2A: _A2A}


def _block_events(cfg, layout, spec, kind: str, i: int, seq_len: int):
    """(forward events, backward events) of block ``i`` of a unit, each a
    list of (kind, axes) in issue order: ``models/model.py:_apply_block``
    and the tensor-parallel forms it calls, on a train step's layout."""
    from repro_torch.models.attention import _ring
    sp, tp, n_tp = layout.sp_axes, layout.tp_axes, layout.tp
    fwd, bwd = [], []

    def grad(ev_kind, axes):             # a collective with a backward
        fwd.append((ev_kind, axes))
        bwd.append((_BACKWARD[ev_kind], axes))

    def gather_tp(tree_spec):
        for sp_leaf in _spec_leaves(tree_spec):
            if any(layout.tp_sharded(sp_leaf, d) for d in range(len(sp_leaf))):
                grad(_AG, tp)

    def mlp_tp(mspec):
        if layout.tp_sharded(mspec["up"], -1):
            grad(_AG, sp)
            grad(_RS, sp)

    if n_tp == 1:
        return fwd, bwd
    mix = spec["mixer"]
    if kind in ("attn", "local"):
        h, g = cfg.n_heads, cfg.n_kv_heads
        grad(_AG, sp)                                     # xf
        for name in ("wk", "wv"):
            if not layout.tp_sharded(mix[name], -1):
                grad(_AG, sp)
            elif g % n_tp:
                grad(_AG, tp)
        if h % n_tp:
            cols = layout.tp_sharded(mix["wq"], -1)
            if cols:
                grad(_A2A, tp)
            if cfg.attn_impl == "flash" and seq_len > cfg.attn_chunk and \
                    _ring(cfg, seq_len, n_tp):
                fwd.extend([(_SR, tp)] * (n_tp - 1))
                bwd.extend([(_SR, tp)] * n_tp)
            if cols:
                grad(_A2A, tp)
                grad(_RS, sp)
        else:
            grad(_RS, sp)
    elif kind == "ssm":
        if _ssm_heads(cfg) % n_tp:
            gather_tp(mix)
            grad(_AG, sp)
        else:
            grad(_AG, sp)
            if layout.tp_sharded(mix["conv_w"], 1):
                grad(_AG, tp)
            fwd.append((_AR, tp))                          # sum_both
            bwd.append((_AR, tp))
            grad(_RS, sp)
    else:                                                  # the RG-LRU
        grad(_AG, sp)
        if (cfg.rnn_width or cfg.d_model) % n_tp:
            gather_tp(mix)
        else:
            grad(_AG, tp)                                  # the gates' x
            grad(_RS, sp)
    if kind == "ssm":
        return fwd, bwd
    if cfg.is_moe_block(i):
        mspec = spec["mlp"]
        batch = layout.axes("batch")
        grad(_AG, sp)                                      # xf
        fwd.append((_AR, tuple(batch) + tuple(sp)))        # aux statistics
        fwd.append((_AR, batch))                           # kept pairs
        if layout.tp_sharded(mspec["up"], 0):
            grad(_RS, sp)
        if cfg.moe.shared_expert:
            mlp_tp(mspec["shared"])
    else:
        mlp_tp(spec["mlp"])
    return fwd, bwd


def _ssm_heads(cfg) -> int:
    from repro_torch.models.ssm import _dims
    return _dims(cfg)[1]


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


def step_counts(cfg, rules, hp, *, rows: int, seq_len: int) -> dict:
    """{kind: {"axis,axis": calls}} of one sharded train step
    (``training.trainer.make_train_step(cfg, hp, rules)``) on a rank
    holding ``rows`` rows of the batch at ``seq_len`` tokens, from the
    layout alone:

      * each unit's FSDP gathers, one a (fsdp axes, dtype) group of its
        leaves, in the forward and again in the recompute, and their
        reduce-scatters in the backward;
      * each block's tensor-parallel collectives (``_block_events``): the
        sequence gathers and row-parallel reduce-scatters, the K/V
        gathers where the KV heads do not divide, the reshards and ring
        shifts of heads that do not divide, the SSM's sum of squares, the
        RG-LRU's gate gather, the MoE's statistics; in the forward, in
        the recompute of a remat unit (which stops before the unit's last
        reduce-scatter: a non-reentrant checkpoint stops once it has
        rebuilt the last tensor the backward saved) and, reversed, in the
        backward;
      * the embedding's gather over ``tp``; the vocabulary-sharded loss
        (the table's reshard, the sequence gather, three sums a loss
        chunk, again in its recompute) and its two sums over the batch;
      * a microbatch's gradient sums (``to_param_layout``: one a
        (gradient axes, dtype) group of the leaves);
      * and once a step the global norm's sum over every axis.

    ``hp.compress_grads`` is not covered."""
    from repro_torch.models import init_model
    from repro_torch.models.sharding import (TrainLayout, _axes,
                                             named_leaves, spec_at)
    from repro_torch.training.trainer import microbatch_count, param_pspecs
    if hp.compress_grads:
        raise NotImplementedError("step_counts: compressed gradients")
    layout = TrainLayout(rules, param_pspecs(cfg, rules))
    specs = layout.specs
    mesh = rules.mesh
    tally = _Tally(mesh)
    n_micro = microbatch_count(rows, hp.n_microbatches)
    compute, master = cfg.compute_dtype, cfg.master_dtype
    leaves = [(path, t.dtype if t.dtype != master else compute,
               spec_at(specs, path))
              for path, t in named_leaves(init_model(cfg, device="meta"))]

    micro = _Tally(mesh)
    # the embedding (a token table D-sharded over tp)
    if cfg.input_mode == "tokens" and layout.tp > 1 and \
            layout.tp_sharded(specs["embed"]["tokens"], 1):
        micro.add(_AG, layout.tp_axes)
        micro.add(_RS, layout.tp_axes)
    # the units: FSDP, then the blocks
    fsdp = set(layout.axes("fsdp"))
    groups = set()
    for path, dt, spec in leaves:
        if path[0] != "units":
            continue
        dims = [ax for ax in (spec or ())[1:]
                if _axes(ax) and set(_axes(ax)) <= fsdp]
        if dims:
            groups.add((_axes(dims[0]), dt))
    remat = 2 if cfg.remat else 1
    for axes, _ in groups:
        micro.add(_AG, axes, cfg.n_units * remat)
        micro.add(_RS, axes, cfg.n_units)
    unit_specs = {k: _drop_unit(v) for k, v in specs["units"].items()}
    unit_fwd, unit_bwd = [], []
    for i, kind in enumerate(cfg.block_pattern):
        f, b = _block_events(cfg, layout, unit_specs[f"block{i}"], kind, i,
                             seq_len)
        unit_fwd += f
        unit_bwd += b
    recompute = list(unit_fwd)
    if cfg.remat and recompute and recompute[-1][0] == _RS:
        recompute = recompute[:-1]
    micro.add_all(unit_fwd, cfg.n_units)
    if cfg.remat:
        micro.add_all(recompute, cfg.n_units)
    micro.add_all(unit_bwd, cfg.n_units)
    # the vocabulary-sharded loss and its sums over the batch
    tp, sp = layout.tp_axes, layout.sp_axes
    emb = specs["embed"]
    if layout.tp > 1:
        tied_sharded = cfg.tie_embeddings and layout.tp_sharded(
            emb["tokens"], 1)
        if cfg.padded_vocab % layout.tp:
            if tied_sharded:
                micro.add(_AG, tp)
                micro.add(_RS, tp)
            micro.add(_AR, sp, 2)
        else:
            if tied_sharded:
                micro.add(_A2A, tp, 2)
            micro.add(_AG, sp)
            micro.add(_RS, sp)
            chunks = -(-seq_len // min(cfg.loss_chunk, seq_len))
            micro.add(_AR, tp, 3 * chunks * 2)
    micro.add(_AR, layout.axes("batch"), 2)
    # a microbatch's gradient sums over the ranks that saw other data
    sums = set()
    for path, dt, spec in leaves:
        axes = layout.grad_axes(spec)
        if axes and rules.axes_size(axes) > 1:
            sums.add((axes, dt))
    for axes, _ in sums:
        micro.add(_AR, axes)
    for kind, row in micro.counts.items():
        for key, n in row.items():
            tally.add(kind, tuple(key.split(",")), n * n_micro)
    tally.add(_AR, mesh.axis_names)                        # global norm
    return tally.counts


def _drop_unit(tree):
    return {k: _drop_unit(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[1:]
