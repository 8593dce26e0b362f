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
and decode.  Sharded LM training (``rules=``, the reference's
``param_pspecs`` / ``state_pspecs`` / ``input_specs`` and the
``constrain=`` layout) waits for ROADMAP A12.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import optim
from repro_torch.core.linear_model import value_and_grad
from repro_torch.launch.collectives import axis_mean
from repro_torch.models import decode_step, init_model, prefill, train_loss
from repro_torch.models.config import ModelConfig, _torch_dtype
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


def make_serve_steps(cfg: ModelConfig):
    """(prefill_step(params, inputs, caches), decode_one(params, tokens,
    pos, caches)) bound to ``cfg``; each returns (logits, caches)."""
    def prefill_step(params, inputs, caches):
        return prefill(params, inputs, cfg, caches)

    def decode_one(params, tokens, pos, caches):
        return decode_step(params, tokens, pos, cfg, caches)

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
    nothing."""
    if constrain is not None:
        raise NotImplementedError(
            "microbatch_grads: constrain= is the LM trainer's GSPMD layout, "
            "which waits for the LM training stack (ROADMAP A12)")
    if axis_name is not None and mesh is None:
        raise ValueError("microbatch_grads: axis_name= needs the mesh= it "
                         "names an axis of")
    if n_micro == 1:
        (loss, metrics), grads = value_and_grad(
            loss_fn, params, batch["inputs"], batch["labels"])
        loss, grads = _mean_loss_grads(loss, grads, mesh, axis_name)
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
                     device=None) -> TrainState:
    """Fresh masters (``init_model``: drawn from ``generator`` on
    ``device``, the card unless told otherwise), zero moments in
    ``cfg.moment_dtype``, step 0, and a zero fp32 residual when
    ``hp.compress_grads``.  ``device="meta"`` gives the shapes alone."""
    params = init_model(cfg, generator, device)
    st = make_optimizer(cfg, hp).init(params)
    ef = init_residual(params) if hp.compress_grads else None
    dev = optim.tree_leaves(params)[0].device
    return TrainState(params=params, mu=st.mu, nu=st.nu,
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      ef_residual=ef)


def make_train_step(cfg: ModelConfig, hp: TrainHparams,
                    rules=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` for ``batch =
    {"inputs", "labels"}`` (tensors on the state's device, a leading dim
    divisible by ``hp.n_microbatches``); metrics ``loss``, ``grad_norm``,
    ``nll``, ``tokens`` and the MoE aux terms (of the last microbatch,
    as the reference's).  The state's tensors are updated in place."""
    if rules is not None:
        raise NotImplementedError(
            "make_train_step(rules=...): sharded LM training (param_pspecs, "
            "state_pspecs, input_specs) is not ported yet (ROADMAP A12)")
    accum_dtype = _torch_dtype(cfg.grad_accum_dtype)
    sched = optim.linear_warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    master = cfg.master_dtype
    stochastic = master == torch.bfloat16

    def loss_fn(p, inputs, labels):
        return train_loss(p, inputs, labels, cfg)

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
        loss, metrics, grads = microbatch_grads(
            loss_fn, diff, batch, n_micro=hp.n_microbatches,
            accum_dtype=accum_dtype)
        del diff

        ef = state.ef_residual
        if hp.compress_grads and ef is not None:
            # int8 + error feedback on the gradient payload
            grads, ef = error_feedback_compress(grads, ef)

        # the global-norm clip as a scalar folded into the fused update
        gnorm = optim.global_norm(grads)
        scale = torch.clamp(torch.full_like(gnorm, hp.clip_norm) /
                            (gnorm + 1e-9), max=1.0)
        optim.fused_adamw_apply(
            params, grads, state.mu, state.nu, state.step,
            lr=sched(state.step), b1=hp.b1, b2=hp.b2,
            weight_decay=hp.weight_decay, stochastic_round=stochastic,
            sr_key=state.step if stochastic else None, g_scale=scale)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, mu=state.mu, nu=state.nu,
                          step=state.step + 1, ef_residual=ef), metrics

    return train_step
