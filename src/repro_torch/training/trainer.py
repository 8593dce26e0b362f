"""Step functions (port of ``repro.training.trainer``: the serving steps
and the gradient-accumulation path).

``make_serve_steps`` binds the LM's prefill and decode;
``microbatch_grads`` is the gradient path the streamed linear trainer
rides, with the mean over the mesh's ``data`` axis at the reference's
point (``axis_name=``).  The LM training step, its optimizer and
compression, and ``constrain=`` (the LM trainer's GSPMD layout) wait for
ROADMAP A12.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import optim
from repro_torch.core.linear_model import value_and_grad
from repro_torch.launch.collectives import axis_mean
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


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
        g = optim.tree_map(lambda a, b: a + b.to(accum_dtype), g, grads)
        loss_sum = loss_sum + loss
    # divide by a tensor: a true division on every device (see
    # repro_torch.optim.optimizers)
    div = lambda t: t / torch.full((), n_micro, dtype=t.dtype,
                                   device=t.device)
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
