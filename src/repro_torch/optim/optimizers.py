"""Gradient-transform optimizers (port of ``repro.optim.optimizers``,
the transforms the linear tier uses).

A transform is a pair ``(init_fn, update_fn)``:
  state = init_fn(params)
  updates, state = update_fn(updates, state, params, step)

over trees of tensors (tuples, NamedTuples, lists and dicts).  The
arithmetic follows the reference operation by operation, in float32:
the schedule value and Adam's bias corrections are float32 tensors, as
they are in the reference's jitted step, and every division is a
tensor-by-tensor division on the tensors' device.  (PyTorch turns
``python_float / tensor`` into a reciprocal times the float, and on
CUDA ``tensor / python_float`` into a multiply by the reciprocal: each
rounds differently from the reference's division.)  Square roots are
taken in float64 and rounded once to float32, which is the correctly
rounded float32 root the reference takes (PyTorch's vectorized CPU sqrt
is not correctly rounded).  The global norm is accumulated in float64,
so that it rounds to the same float32 on every device.  ``torch.optim.AdamW``
is not used: its default b2 is 0.999, not 0.95, and it orders its
operations differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

Tree = Any

__all__ = ["Transform", "AdamState", "adamw", "sgd", "clip_by_global_norm",
           "chain", "apply_updates", "cosine_schedule",
           "linear_warmup_cosine", "constant_schedule", "tree_leaves",
           "tree_map"]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree: Tree) -> list:
    """The tensors of a tree, in the reference's leaf order (NamedTuple
    fields in order, dict values by sorted key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, AdamState):
        return tree_leaves(tree.mu) + tree_leaves(tree.nu)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, AdamState):
        return AdamState(tree_map(fn, tree.mu, *(r.mu for r in rest)),
                         tree_map(fn, tree.nu, *(r.nu for r in rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):     # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


class Transform(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Any], tuple]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _f32(step) -> torch.Tensor:
    """The step as a float32 0-dim tensor: on the CPU for a Python int, on
    its own device for a tensor."""
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float) -> Callable[[Any], torch.Tensor]:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return f


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def clip_by_global_norm(max_norm: float) -> Transform:
    def init(params):
        return ()

    def update(updates, state, params, step):
        # the squares summed in float64: a float32 sum rounds in each
        # device's reduction order, this one to the same float32 norm on
        # every device (but on a tie at 2^-53)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.double()))
                               for g in tree_leaves(updates))).float()
        # max_norm / (gnorm + 1e-9) as a true division (see the module
        # docstring), then min(1, .)
        scale = torch.clamp(
            torch.full_like(gnorm, max_norm) / (gnorm + 1e-9), max=1.0)
        updates = tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           updates)
        return updates, state

    return Transform(init, update)


@dataclasses.dataclass
class AdamState:
    mu: Tree
    nu: Tree


def adamw(learning_rate: float | Callable, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype: torch.dtype | None = torch.float32) -> Transform:
    """AdamW with float32 (or ``moment_dtype``) moments and decoupled
    decay; updates are computed in float32."""
    sched = (learning_rate if callable(learning_rate)
             else constant_schedule(learning_rate))

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype or p.dtype,
                                      device=p.device)
        return AdamState(mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(updates, state, params, step):
        lr = sched(step)
        count = _f32(step) + 1.0
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count

        def upd(g, m, v, p):
            # the divisors on the leaf's device: a tensor division there
            c1d, c2d = (c.to(g.device, non_blocking=True) for c in (c1, c2))
            g32, m32, v32 = g.float(), m.float(), v.float()
            m32 = b1 * m32 + (1.0 - b1) * g32
            v32 = b2 * v32 + (1.0 - b2) * torch.square(g32)
            mhat = m32 / c1d
            vhat = v32 / c2d
            # float64 holds a float32 exactly and has more than 2 x 24 + 2
            # bits, so its root rounded once is the float32 root
            step_dir = mhat / (torch.sqrt(vhat.double()).float() + eps)
            if weight_decay:
                step_dir = step_dir + weight_decay * p.float()
            return -lr.to(g.device, non_blocking=True) * step_dir, \
                m32.to(m.dtype), v32.to(v.dtype)

        leaves = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(updates), tree_leaves(state.mu),
            tree_leaves(state.nu), tree_leaves(params))]
        return (_unflatten(updates, [o[0] for o in leaves]),
                AdamState(mu=_unflatten(updates, [o[1] for o in leaves]),
                          nu=_unflatten(updates, [o[2] for o in leaves])))

    return Transform(init, update)


def _unflatten(like: Tree, leaves: list) -> Tree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def sgd(learning_rate: float | Callable, momentum: float = 0.0) -> Transform:
    sched = (learning_rate if callable(learning_rate)
             else constant_schedule(learning_rate))

    def init(params):
        if momentum:
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
        return ()

    def update(updates, state, params, step):
        lr = sched(step)
        if momentum:
            new_state = tree_map(lambda m, g: momentum * m + g.float(),
                                 state, updates)
            upd = tree_map(lambda m: -lr.to(m.device) * m, new_state)
            return upd, new_state
        upd = tree_map(lambda g: -lr.to(g.device) * g.float(), updates)
        return upd, state

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params, step):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params, step)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)
