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

from repro_torch.launch.collectives import axis_sum

Tree = Any

__all__ = ["Transform", "AdamState", "adamw", "sgd", "clip_by_global_norm",
           "chain", "apply_updates", "cosine_schedule",
           "linear_warmup_cosine", "constant_schedule", "tree_leaves",
           "tree_map", "fused_adamw_apply", "global_norm"]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree: Tree) -> list:
    """The tensors of a tree, in the reference's leaf order (NamedTuple
    fields in order, dict values by sorted key; ``None`` is an empty
    subtree, as in jax)."""
    if tree is None:
        return []
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
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``,
    called in ``tree_leaves``' order (dicts by sorted key), so that
    ``tree_map(lambda _: next(it), tree)`` rebuilds a tree from its
    leaves; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, AdamState):
        return AdamState(tree_map(fn, tree.mu, *(r.mu for r in rest)),
                         tree_map(fn, tree.nu, *(r.nu for r in rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
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

def global_norm(tree: Tree, *, counted=None, mesh=None) -> torch.Tensor:
    """The float32 global L2 norm of a tree's leaves, its squares summed
    in float64 (a float32 sum rounds in each device's reduction order,
    this one to the same float32 norm on every device, but on a tie at
    2^-53), a slice of 2^24 elements at a time, so that no float64 copy
    of a whole large leaf exists.

    Over shards (``mesh``): the tree holds this rank's slices, and
    ``counted`` (one bool a leaf, in ``tree_leaves``' order) marks the
    leaves this rank counts, so that a leaf replicated over ranks counts
    on one rank of each replica set; the float64 sums of every rank are
    then added in rank order (one collective).  On one rank this is the
    unsharded norm."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float64)
    for i, g in enumerate(leaves):
        if counted is not None and not counted[i]:
            continue
        for part in g.reshape(-1).split(1 << 24):
            total = total.to(part.device) + torch.sum(
                torch.square(part.double()))
    if mesh is not None:
        if leaves:
            total = total.to(leaves[0].device)
        total = axis_sum(total.reshape(1), mesh, mesh.axis_names)[0]
    return torch.sqrt(total).float()


def clip_by_global_norm(max_norm: float) -> Transform:
    def init(params):
        return ()

    def update(updates, state, params, step):
        gnorm = global_norm(updates)
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


# ---------------------------------------------------------------------------
# the LM trainer's fused AdamW
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit ``c``,
    in two halves so that no product leaves int64 (CPU PyTorch's uint32
    lacks the multiply and shifts)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _murmur_bits(shape, seed, device=None) -> torch.Tensor:
    """The reference's counter-based uniform 32-bit words: the murmur3
    finalizer over (flat index mod 2^32) * 2654435761 + ``seed``.  Returned
    as int64 in [0, 2^32) of ``shape``; ``seed`` is an int or an int64
    tensor of one element."""
    n = 1
    for dim in shape:
        n *= int(dim)
    x = torch.arange(n, dtype=torch.int64, device=device) & _M32
    return _mix32(x, seed).reshape(tuple(shape))


def _mix32(x: torch.Tensor, seed) -> torch.Tensor:
    """The murmur3 finalizer over ``x * 2654435761 + seed`` (int64 in
    [0, 2^32)), mod 2^32."""
    x = (_mul32(x, 2654435761) + seed) & _M32
    x ^= x >> 16
    x = _mul32(x, 0x85EBCA6B)
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    x ^= x >> 16
    return x


def _global_index(shape, offsets, gshape, row0: int) -> torch.Tensor:
    """The flat index, in a C-ordered array of ``gshape``, of each element
    of a slice of ``shape`` starting at ``offsets`` (dim 0 counted from
    ``row0``), as int64 mod 2^32: the reference's per-axis iotas times
    their strides, so a shard's noise is the slice of the whole leaf's."""
    idx = torch.zeros((), dtype=torch.int64)
    stride = 1
    for d in range(len(gshape) - 1, -1, -1):
        start = offsets[d] - (row0 if d == 0 else 0)
        coord = torch.arange(start, start + shape[d], dtype=torch.int64)
        idx = idx + (coord * (stride % (1 << 32))).reshape(
            (-1,) + (1,) * (len(gshape) - 1 - d))
        stride *= max(int(gshape[d]), 1)
    return idx.expand(tuple(shape)) & _M32


def _stochastic_round_bf16(x32: torch.Tensor, seed,
                           index=None) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: the reference's 16
    noise bits added to the float's bits, the low half cleared.  ``index``
    (int64, x32's shape): each element's flat index in the array the
    reference draws its noise over (default: x32's own)."""
    bits = x32.contiguous().view(torch.int32).to(torch.int64) & _M32
    if index is None:
        noise = _murmur_bits(x32.shape, seed, x32.device) & 0xFFFF
    else:
        noise = _mix32(index.to(x32.device), seed) & 0xFFFF
    r = (bits + noise) & 0xFFFF0000
    r = (r - ((r >> 31) << 32)).to(torch.int32)     # back to signed bits
    return r.view(torch.float32).to(torch.bfloat16)


def _leaf_adamw_(p, g, m, v, *, lr, c1, c2, b1, b2, eps, weight_decay,
                 decay_this, stochastic_round, seed, g_scale=None,
                 index=None):
    """One leaf (or one dim-0 slice of it), the reference's
    ``_leaf_adamw`` operation by operation, written into p, m and v."""
    g32 = g.float()
    if g_scale is not None:   # clip-by-global-norm folded into the update
        g32 = g32 * g_scale
    m32 = b1 * m.float() + (1.0 - b1) * g32
    v32 = b2 * v.float() + (1.0 - b2) * torch.square(g32)
    # the float32 root, correctly rounded (see the module docstring)
    step_dir = (m32 / c1) / (torch.sqrt((v32 / c2).double()).float() + eps)
    if weight_decay and decay_this:
        step_dir = step_dir + weight_decay * p.float()
    p32 = p.float() - lr * step_dir
    if stochastic_round and p.dtype == torch.bfloat16:
        p.copy_(_stochastic_round_bf16(p32, seed, index))
    else:
        p.copy_(p32)
    m.copy_(m32)
    v.copy_(v32)


def fused_adamw_apply(params: Tree, grads: Tree, mu: Tree, nu: Tree, step,
                      *, lr, b1: float = 0.9, b2: float = 0.95,
                      eps: float = 1e-8, weight_decay: float = 0.0,
                      stochastic_round: bool = False, sr_key=None,
                      chunks: int = 16, chunk_threshold: int = 1 << 24,
                      g_scale=None, shards=None):
    """The reference's memory-bounded fused AdamW, IN PLACE: each leaf's
    p, m and v are read and written in one pass, and the reference's
    donated carry is the tensors themselves.  A leaf of at least
    ``chunk_threshold`` elements whose dim 0 divides by ``chunks`` is
    updated slice by slice of dim 0, so its fp32 transients are a
    ``chunks``-th of the leaf.  ``g_scale`` (a 0-dim tensor) is the global
    clip folded in; ``decay_this`` is ``ndim >= 2``.

    With ``stochastic_round`` a bf16 leaf rounds stochastically, seeded
    as the reference seeds it: ``base * 0x9E3779B9 + i * 101 + 1`` for
    leaf ``i`` of ``tree_leaves`` (``base``: ``sr_key``, else the step),
    plus ``ci * 7919`` for slice ``ci``, all mod 2^32.

    ``shards`` (one ``(global shape, offsets)`` a leaf, in
    ``tree_leaves``' order, or None) says that the trees hold this rank's
    slices of larger leaves: the dim-0 chunking is then the global leaf's,
    and each element's noise is drawn at its global flat index in its
    global chunk, so a shard's update is the slice of the unsharded
    update bit for bit (GSPMD's global iota in the reference).

    Returns (params, mu, nu), the trees passed in."""
    count = _f32(step) + 1.0
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    base = sr_key if sr_key is not None else step
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for i, (p, g, m, v) in enumerate(zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(mu),
            tree_leaves(nu))):
        dev = p.device
        on = lambda t: t.to(dev, non_blocking=True)
        base_d = torch.as_tensor(base, device=dev).to(torch.int64) & _M32
        leaf_seed = (base_d * 0x9E3779B9 + (i * 101 + 1)) & _M32
        kw = dict(lr=on(lr), c1=on(c1), c2=on(c2), b1=b1, b2=b2, eps=eps,
                  weight_decay=weight_decay, decay_this=p.ndim >= 2,
                  stochastic_round=stochastic_round,
                  g_scale=None if g_scale is None else on(g_scale))
        shard = None if shards is None else shards[i]
        if shard is not None and tuple(shard[0]) != tuple(p.shape):
            _shard_adamw_(p, g, m, v, shard, leaf_seed, chunks,
                          chunk_threshold, kw)
        elif p.numel() >= chunk_threshold and p.shape[0] % chunks == 0:
            csz = p.shape[0] // chunks
            for ci in range(chunks):
                sl = slice(ci * csz, (ci + 1) * csz)
                _leaf_adamw_(p[sl], g[sl], m[sl], v[sl],
                             seed=(leaf_seed + ci * 7919) & _M32, **kw)
        else:
            _leaf_adamw_(p, g, m, v, seed=leaf_seed, **kw)
    return params, mu, nu


def _shard_adamw_(p, g, m, v, shard, leaf_seed, chunks, chunk_threshold,
                  kw):
    """One rank's slice of a leaf: the global leaf's dim-0 chunks that the
    slice overlaps, in turn, each with its chunk's seed and the elements'
    flat indices in that chunk (noise only for a bf16 leaf that rounds
    stochastically)."""
    gshape, offsets = tuple(shard[0]), tuple(shard[1])
    n = 1
    for dim in gshape:
        n *= int(dim)
    noisy = kw["stochastic_round"] and p.dtype == torch.bfloat16
    if n >= chunk_threshold and gshape[0] % chunks == 0:
        csz = gshape[0] // chunks
        cshape = (csz,) + gshape[1:]
        pieces = [(ci, ci * csz) for ci in range(chunks)]
    else:
        csz, cshape, pieces = gshape[0], gshape, [(None, 0)]
    lo, hi = offsets[0], offsets[0] + p.shape[0]
    for ci, row0 in pieces:
        a, b = max(lo, row0), min(hi, row0 + csz)
        if a >= b:
            continue
        sl = slice(a - lo, b - lo)
        seed = leaf_seed if ci is None else (leaf_seed + ci * 7919) & _M32
        index = None
        if noisy:
            index = _global_index((b - a,) + tuple(p.shape[1:]),
                                  (a,) + offsets[1:], cshape, row0)
        _leaf_adamw_(p[sl], g[sl], m[sl], v[sl], seed=seed, index=index,
                     **kw)


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
