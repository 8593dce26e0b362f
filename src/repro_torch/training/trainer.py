"""Step functions (port of ``repro.training.trainer``: the serving steps
and the gradient-accumulation path).

``make_serve_steps`` binds the LM's prefill and decode;
``microbatch_grads`` is the gradient path the streamed linear trainer
rides, unsharded.  The LM training step, its optimizer and compression
wait for ROADMAP A12, the sharded forms (``axis_name``, ``constrain``)
for A11.  One device: there are no axis rules to install.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import optim
from repro_torch.core.linear_model import value_and_grad
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
                     axis_name: Optional[str] = None):
    """Gradients over ``n_micro`` microbatches, accumulated in
    ``accum_dtype`` in microbatch order, then averaged.

    ``loss_fn(params, inputs, labels) -> (loss, metrics)``; ``batch`` is
    ``{"inputs", "labels"}`` with a leading dim divisible by ``n_micro``.
    Returns ``(mean loss, last-microbatch metrics, mean grads)``;
    ``n_micro == 1`` is one ``value_and_grad`` on the whole batch."""
    if constrain is not None or axis_name is not None:
        raise NotImplementedError(
            "microbatch_grads: constrain= and axis_name= are the sharded "
            "forms, which wait for the data axis (ROADMAP A11)")
    if n_micro == 1:
        (loss, metrics), grads = value_and_grad(
            loss_fn, params, batch["inputs"], batch["labels"])
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
    return div(loss_sum), metrics, optim.tree_map(div, g)
