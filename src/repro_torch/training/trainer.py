"""The LM train step and the step functions (port of
``repro.training.trainer``).

``make_train_step`` is the reference's ``make_train_step(cfg, hp,
rules=None)``: differentiate a compute-dtype copy of the fp32 masters,
accumulate gradients over microbatches (``microbatch_grads``, the path
the streamed linear trainer rides too), optionally int8-compress them
with error feedback, fold the global-norm clip into the fused AdamW
update, round bf16 masters stochastically.  The step updates the state's
tensors in place (the reference donates them) and returns a new
``TrainState`` holding them.  ``make_serve_steps`` binds the LM's prefill
and decode, sharded under ``rules`` on the same layout.

Sharded training (``rules=``) follows the reference's layout (its
``DESIGN.md`` §5 and ``param_pspecs``): every 2-D projection shards its
input dim over ``data`` (FSDP) and its output dim over ``model`` (TP),
reversed for the row-parallel mats; the residual stream's sequence shards
over ``model`` (Megatron-SP), the batch over ``("pod", "data")``.  Each
rank holds its slices explicitly, and the code that needs other ranks'
data calls a collective (``launch.collectives``).  The spec functions
(``param_pspecs``, ``cache_pspecs``, ``state_pspecs``, ``input_specs``)
are the reference's, on shapes from the meta device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import optim
from repro_torch.core.linear_model import value_and_grad
from repro_torch.launch.collectives import axis_mean, axis_sum
from repro_torch.models import (decode_step, init_caches, init_model,
                                prefill, train_loss)
from repro_torch.models.config import ModelConfig, _torch_dtype
from repro_torch.models.model import check_supported
from repro_torch.models.sharding import (TrainLayout, named_leaves,
                                         owns_replica, shard_bounds,
                                         shard_of, spec_at)
from repro_torch.optim.compression import (error_feedback_compress,
                                           init_residual)

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    mu: Tree
    nu: Tree
    step: torch.Tensor                 # () int32
    ef_residual: Optional[Tree] = None   # error-feedback state (optional)


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    n_microbatches: int = 1
    compress_grads: bool = False
    b1: float = 0.9
    b2: float = 0.95


# ---------------------------------------------------------------------------
# parameter / cache / state / input sharding specs
# ---------------------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "gate", "up", "in_x", "in_gate"}
# RG-LRU gate matrices: tiny (W x W), column-parallel without FSDP
_GATE_MATS = {"w_a", "w_i"}
_ROW_PARALLEL = {"wo", "down", "out", "out_proj"}
_REPLICATED = {"scale", "conv_b", "a_log", "dt_bias", "d_skip",
               "norm_scale", "b_a", "b_i", "lam"}


class InputSpec(NamedTuple):
    """A model input's global shape, dtype and spec (the reference's
    ``ShapeDtypeStruct`` with its sharding); ``spec`` None: unsharded."""
    shape: tuple
    dtype: torch.dtype
    spec: Optional[tuple]


def _rebuild(tree, leaves):
    """``tree``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    vals = [_rebuild(t, leaves) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _degrade(shape, spec, rules) -> tuple:
    """The reference's per-dimension rule: a dim that does not divide by
    its axes' product is replicated."""
    return tuple(ax if ax is None or dim % rules.axes_size(ax) == 0
                 else None for dim, ax in zip(shape, spec))


def _param_spec(path, shape, rules) -> tuple:
    name = _leaf_name(path)
    prefix = (None,) if "units" in path else ()   # stacked-unit axis
    nd = len(shape) - len(prefix)

    def spec(*axes):
        return rules.resolve(*(prefix + axes))

    if name in ("tokens", "head"):   # (V, D): D over tp; (D, V): V over tp
        return spec(None, "tp")
    if name == "router":                       # (D, E)
        return spec("fsdp", None)
    if name in _REPLICATED:
        return spec(*([None] * nd))
    if name == "conv_w":                       # (W, C)
        return spec(None, "tp")
    if name == "in_proj":                      # ssm fused proj (D, X)
        return spec("fsdp", None)
    if name in _GATE_MATS:
        return spec(None, "tp")
    if name in _COL_PARALLEL or name in _ROW_PARALLEL:
        if nd == 3:                            # MoE expert stack (E, in, out)
            return spec("experts", "fsdp", None)
        return spec("fsdp", "tp") if name in _COL_PARALLEL \
            else spec("tp", "fsdp")
    return spec(*([None] * nd))


def param_pspecs(cfg: ModelConfig, rules) -> dict:
    """Every parameter's spec under ``rules`` (the reference's
    ``param_pspecs``): a tree shaped like ``init_model``'s whose leaves are
    ``AxisRules.resolve`` tuples, a dim that does not divide replicated.
    The shapes come from the meta device."""
    shapes = init_model(cfg, device="meta")
    named = named_leaves(shapes)
    return _rebuild(shapes, iter(
        _degrade(t.shape, _param_spec(path, t.shape, rules), rules)
        for path, t in named))


def cache_pspecs(cfg: ModelConfig, rules, *, batch: int, max_len: int,
                 long: bool = False) -> tuple:
    """The caches' specs (the reference's ``cache_pspecs``): KV heads over
    ``tp`` where they divide (not for ``long``), else the sequence over
    ``kv_seq`` (``long_seq`` for a long full cache); the SSM's heads and
    the RG-LRU's width over ``tp``; the batch over ``batch``."""
    shapes = init_caches(cfg, batch, max_len, device="meta")
    tp_n = rules.axes_size(rules.rules.get("tp"))
    kv_head_sharded = (cfg.n_kv_heads > 0 and tp_n > 1
                       and cfg.n_kv_heads % tp_n == 0)
    out = []
    for path, leaf in named_leaves(shapes):
        name, shape = _leaf_name(path), tuple(leaf.shape)
        if name in ("k", "v"):
            if kv_head_sharded and not long:
                sp = rules.resolve(None, "batch", None, "tp", None)
            else:
                seq_ax = "long_seq" if (long and shape[2] > cfg.window > 0
                                        or (long and cfg.window == 0)) \
                    else "kv_seq"
                sp = rules.resolve(None, "batch", seq_ax, None, None)
        elif name == "h" and len(shape) == 5:      # ssm state (U,B,H,P,N)
            sp = rules.resolve(None, "batch", "tp", None, None)
        elif name == "h" and len(shape) == 3:      # rglru state (U,B,W)
            sp = rules.resolve(None, "batch", "tp")
        elif name == "conv":
            sp = rules.resolve(None, "batch", None, None)
        else:                                       # lengths
            sp = rules.resolve(*([None] * len(shape)))
        out.append(_degrade(shape, sp, rules))
    return _rebuild(shapes, iter(out))


def state_pspecs(cfg: ModelConfig, rules, hp: "TrainHparams"):
    """The train state's specs: the moments and the residual as the
    parameters, the step replicated."""
    ps = param_pspecs(cfg, rules)
    return TrainState(params=ps, mu=ps, nu=ps, step=(),
                      ef_residual=ps if hp.compress_grads else None)


def input_specs(cfg: ModelConfig, rules, *, shape: str, seq_len: int,
                global_batch: int) -> dict:
    """Every model input's ``InputSpec`` for ``shape`` ("train",
    "prefill" or "decode"): the batch over ``batch``, a dim that does not
    divide (a batch of 1) replicated."""
    def rec(shape_, dtype, *axes):
        return InputSpec(tuple(shape_), dtype,
                         _degrade(shape_, rules.resolve(*axes), rules))

    b, s = global_batch, seq_len
    if cfg.input_mode == "embeddings":
        inputs = rec((b, s, cfg.d_model), torch.bfloat16, "batch", None, None)
        step_in = rec((b, 1, cfg.d_model), torch.bfloat16, "batch", None,
                      None)
    else:
        inputs = rec((b, s), torch.int32, "batch", None)
        step_in = rec((b, 1), torch.int32, "batch", None)
    labels = rec((b, s), torch.int32, "batch", None)
    if shape == "train":
        return {"inputs": inputs, "labels": labels}
    if shape == "prefill":
        return {"inputs": inputs}
    if shape == "decode":
        return {"tokens": step_in, "pos": InputSpec((), torch.int32, None)}
    raise ValueError(shape)


def make_serve_steps(cfg: ModelConfig, rules=None):
    """(prefill_step(params, inputs, caches), decode_one(params, tokens,
    pos, caches)) bound to ``cfg``; each returns (logits, caches).

    Under ``rules`` (the reference's ``make_serve_steps(cfg, rules)``) the
    steps run sharded on the train layout (``sharding.TrainLayout`` over
    ``param_pspecs``: FSDP x TP, Megatron-SP for a prompt): ``params``
    are this rank's slices (``interop.lm_params(rules=)``, or
    ``init_model(keep=)``), the inputs this rank's rows of the batch
    (``input_specs``: the batch over ``batch``, whole where it does not
    divide), the caches ``init_caches(rules=, long=)``'s shards; every
    rank returns the whole (B, V) logits.  Without rules, the unsharded
    steps."""
    layout = None
    if rules is not None:
        layout = TrainLayout(rules, param_pspecs(cfg, rules))
        check_supported(cfg, layout)

    def prefill_step(params, inputs, caches):
        return prefill(params, inputs, cfg, caches, layout=layout)

    def decode_one(params, tokens, pos, caches):
        return decode_step(params, tokens, pos, cfg, caches, layout=layout)

    return prefill_step, decode_one


def microbatch_grads(loss_fn: Callable, params, batch: dict, *,
                     n_micro: int = 1,
                     accum_dtype: torch.dtype = torch.float32,
                     constrain: Optional[Callable] = None,
                     axis_name: Optional[str] = None, mesh=None):
    """Gradients over ``n_micro`` microbatches, accumulated in
    ``accum_dtype`` in microbatch order, then averaged.

    ``loss_fn(params, inputs, labels) -> (loss, metrics)``; ``batch`` is
    ``{"inputs", "labels"}`` with a leading dim divisible by ``n_micro``.
    Returns ``(mean loss, last-microbatch metrics, mean grads)``;
    ``n_micro == 1`` is one ``value_and_grad`` on the whole batch.

    ``axis_name`` with ``mesh``: ``batch`` is this rank's shard, and the
    loss and gradients are averaged over the mesh axis
    (``collectives.axis_mean``) after the microbatch mean, where the
    reference's ``pmean`` sits; the results are then means over the
    global batch, the same bits on every rank.  A one-rank axis changes
    nothing.

    ``constrain(grads)`` brings one microbatch's gradient tree to the
    parameters' layout, where the reference's ``constrain_like_params``
    sits: the sharded LM trainer's sums over the ranks that saw other
    data (``to_param_layout``).  It is called once on each microbatch's
    gradients, before they are accumulated."""
    c = constrain or (lambda t: t)
    if axis_name is not None and mesh is None:
        raise ValueError("microbatch_grads: axis_name= needs the mesh= it "
                         "names an axis of")
    if n_micro == 1:
        (loss, metrics), grads = value_and_grad(
            loss_fn, params, batch["inputs"], batch["labels"])
        loss, grads = _mean_loss_grads(loss, c(grads), mesh, axis_name)
        return loss, metrics, grads

    micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
             for k, v in batch.items()}
    g = optim.tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                             device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=optim.tree_leaves(params)[0].device)
    metrics = {}
    for m in range(n_micro):
        (loss, metrics), grads = value_and_grad(
            loss_fn, params, micro["inputs"][m], micro["labels"][m])
        grads = c(grads)
        # the accumulator is this call's own: added to in place, leaf by
        # leaf, so no second copy of it is ever live
        optim.tree_map(lambda a, b: a.add_(b.to(accum_dtype)), g, grads)
        del grads
        loss_sum = loss_sum + loss
    # divide by a tensor: a true division on every device (see
    # repro_torch.optim.optimizers)
    div = lambda t: t.div_(torch.full((), n_micro, dtype=t.dtype,
                                      device=t.device))
    loss, grads = _mean_loss_grads(div(loss_sum), optim.tree_map(div, g),
                                   mesh, axis_name)
    return loss, metrics, grads


def microbatch_count(rows: int, n_micro: int) -> int:
    """The microbatches a rank's ``rows`` of the batch are cut into under
    ``n_micro`` (``TrainHparams.n_microbatches``): ``n_micro`` where it
    divides ``rows``, else the fewest that divide ``rows`` into equal
    parts of at most ``rows / n_micro`` rows each, one row each where
    ``rows < n_micro``.  So no microbatch holds more rows than under
    ``n_micro`` microbatches (or one row, if that is more), and every
    rank of a sharded step, all holding the same rows, takes the same
    count.  The mean over equal microbatches is the batch's mean, and the
    sharded step's loss and gradient stay the global batch's."""
    if rows < 1 or n_micro < 1:
        raise ValueError(f"microbatch_count: {rows} rows, {n_micro} "
                         f"microbatches")
    count = min(n_micro, rows)
    while rows % count:
        count += 1
    return count


def _mean_loss_grads(loss, grads, mesh, axis_name: Optional[str]):
    """(loss, grads) averaged over the mesh axis ``axis_name``, in one
    collective; unchanged without an axis."""
    if axis_name is None:
        return loss, grads
    leaves = []
    optim.tree_map(leaves.append, grads)      # tree_map's own leaf order
    mean = axis_mean([loss.reshape(1)] + leaves, mesh, axis_name)
    rest = iter(mean[1:])
    return mean[0].reshape(()), optim.tree_map(lambda _: next(rest), grads)


# ---------------------------------------------------------------------------
# the LM train step
# ---------------------------------------------------------------------------

def make_optimizer(cfg: ModelConfig, hp: TrainHparams) -> optim.Transform:
    """The reference's transform-style AdamW for ``cfg`` and ``hp`` (the
    train step itself runs ``fused_adamw_apply``)."""
    sched = optim.linear_warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    return optim.adamw(sched, b1=hp.b1, b2=hp.b2,
                       weight_decay=hp.weight_decay,
                       moment_dtype=_torch_dtype(cfg.moment_dtype))


def init_train_state(cfg: ModelConfig, hp: TrainHparams, *,
                     generator: Optional[torch.Generator] = None,
                     device=None, rules=None) -> TrainState:
    """Fresh masters (``init_model``: drawn from ``generator`` on
    ``device``, the card unless told otherwise), zero moments in
    ``cfg.moment_dtype``, step 0, and a zero fp32 residual when
    ``hp.compress_grads``.  ``device="meta"`` gives the shapes alone.

    Under ``rules`` the state is this rank's slices (``state_pspecs``):
    each leaf is drawn whole from the same generator, one block at a
    time, and only this rank's slice is kept, so the sharded state is the
    unsharded state's slices bit for bit."""
    keep = None
    if rules is not None:
        specs = param_pspecs(cfg, rules)
        keep = lambda path, t: shard_of(t, rules.mesh,  # noqa: E731
                                        spec_at(specs, path)).clone()
    params = init_model(cfg, generator, device, keep=keep)
    st = make_optimizer(cfg, hp).init(params)
    ef = init_residual(params) if hp.compress_grads else None
    dev = optim.tree_leaves(params)[0].device
    return TrainState(params=params, mu=st.mu, nu=st.nu,
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      ef_residual=ef)


def to_param_layout(layout, grads):
    """One microbatch's gradients brought to the parameters' layout: each
    leaf summed over the axes whose ranks saw other data and that its spec
    does not shard over (``TrainLayout.grad_axes``: the batch's always,
    the sequence's for a leaf replicated over it), in rank order; leaves
    that share those axes and a dtype go in one collective."""
    named = named_leaves(grads)
    groups = {}
    for i, (path, g) in enumerate(named):
        axes = layout.grad_axes(spec_at(layout.specs, path))
        if axes and layout.rules.axes_size(axes) > 1:
            groups.setdefault((axes, g.dtype), []).append(i)
    out = [g for _, g in named]
    for (axes, _), idx in groups.items():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        flat = axis_sum(flat, layout.mesh, axes)
        lo = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[lo:lo + n].view(out[i].shape)
            lo += n
    return optim.tree_map(lambda _, it=iter(out): next(it), grads)


def make_train_step(cfg: ModelConfig, hp: TrainHparams, rules=None, *,
                    on_grads: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` for ``batch =
    {"inputs", "labels"}`` (tensors on the state's device, a leading dim
    divisible by ``hp.n_microbatches``; under ``rules`` a rank's rows in
    ``microbatch_count(rows, hp.n_microbatches)`` microbatches, so a rank
    with fewer rows than ``hp.n_microbatches`` takes one row at a time);
    metrics ``loss``, ``grad_norm``,
    ``nll``, ``tokens`` and the MoE aux terms (of the last microbatch,
    as the reference's).  The state's tensors are updated in place.
    ``on_grads(grads)`` sees the averaged gradients before compression
    and the update.

    Under ``rules`` the step is sharded, FSDP x TP (``sharding.
    TrainLayout`` over ``param_pspecs``): the state holds this rank's
    slices (``init_train_state(rules=)``), the batch is this rank's rows
    (``input_specs``: the batch over ``batch``, the sequence whole), the
    loss the global batch's mean.  The gradients are brought to the
    parameters' layout (``to_param_layout``), the int8 scales are maxima
    over whole leaves, the global norm counts each element once, and the
    fused AdamW rounds each shard as the whole leaf would be rounded.  A
    one-rank mesh gives the unsharded step's bits."""
    layout = None
    if rules is not None:
        layout = TrainLayout(rules, param_pspecs(cfg, rules))
        check_supported(cfg, layout)
        named = named_leaves(init_model(cfg, device="meta"))
        specs = [spec_at(layout.specs, path) for path, _ in named]
        counted = [owns_replica(rules.mesh, sp) for sp in specs]
        shards = [(tuple(t.shape), tuple(lo for lo, _ in shard_bounds(
            t.shape, sp, rules.mesh))) for (_, t), sp in zip(named, specs)]
    mesh = None if layout is None else rules.mesh
    accum_dtype = _torch_dtype(cfg.grad_accum_dtype)
    sched = optim.linear_warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    master = cfg.master_dtype
    stochastic = master == torch.bfloat16

    def loss_fn(p, inputs, labels):
        return train_loss(p, inputs, labels, cfg, layout=layout)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        # mixed precision: differentiate a compute-dtype copy, so the
        # backward emits compute-dtype gradients; the masters stay fp32
        if cfg.compute_dtype != master:
            diff = optim.tree_map(
                lambda p: p.to(cfg.compute_dtype) if p.dtype == master
                else p, params)
        else:
            diff = params
        n_micro = hp.n_microbatches if layout is None else \
            microbatch_count(batch["inputs"].shape[0], hp.n_microbatches)
        loss, metrics, grads = microbatch_grads(
            loss_fn, diff, batch, n_micro=n_micro,
            accum_dtype=accum_dtype,
            constrain=None if layout is None else
            (lambda g: to_param_layout(layout, g)))
        del diff
        if on_grads is not None:
            on_grads(grads)

        ef = state.ef_residual
        if hp.compress_grads and ef is not None:
            # int8 + error feedback on the gradient payload
            grads, ef = error_feedback_compress(grads, ef, mesh=mesh)

        # the global-norm clip as a scalar folded into the fused update
        gnorm = optim.global_norm(grads) if layout is None else \
            optim.global_norm(grads, counted=counted, mesh=mesh)
        scale = torch.clamp(torch.full_like(gnorm, hp.clip_norm) /
                            (gnorm + 1e-9), max=1.0)
        optim.fused_adamw_apply(
            params, grads, state.mu, state.nu, state.step,
            lr=sched(state.step), b1=hp.b1, b2=hp.b2,
            weight_decay=hp.weight_decay, stochastic_round=stochastic,
            sr_key=state.step if stochastic else None, g_scale=scale,
            shards=None if layout is None else shards)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, mu=state.mu, nu=state.nu,
                          step=state.step + 1, ef_residual=ef), metrics

    return train_step
