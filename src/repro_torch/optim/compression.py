"""Gradient compression for the data-parallel all-reduce (port of
``repro.optim.compression``).

int8 quantization with a per-tensor scale, and error feedback: the
quantization residual is carried to the next step, so the compressed
optimizer stays unbiased in the long run.  The trainer compresses the
gradients before the update and keeps the residual in its state, so it
checkpoints like everything else.

The arithmetic is the reference's operation by operation in float32:
``torch.round`` rounds half to even, as ``jnp.round`` does, and the
divisions are tensor-by-tensor divisions (see
``repro_torch.optim.optimizers``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.collectives import max_nograd
from repro_torch.optim.optimizers import tree_leaves, tree_map

Tree = Any

__all__ = ["int8_compress_decompress", "error_feedback_compress",
           "init_residual"]


def _quantize_int8(x: torch.Tensor, amax=None):
    """(int8 codes, scale); ``amax`` (a 0-dim tensor): the max |x| over
    the whole leaf when ``x`` is a shard of it."""
    x32 = x.float()
    if amax is None:
        amax = x32.abs().amax()
    scale = torch.clamp_min(amax, 1e-30) / torch.full(
        (), 127.0, device=x.device)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Round-trip a tensor through int8 (the wire format)."""
    q, s = _quantize_int8(x)
    return _dequantize_int8(q, s)


def error_feedback_compress(grads: Tree, residual: Tree, *, mesh=None):
    """Compress ``grads + residual`` to int8; return (compressed,
    new_residual).  ``compressed`` holds the dequantized values in the
    gradients' dtypes (on a wire: the int8 payload and its scale, a
    quarter of the fp32 bytes); ``new_residual`` (fp32) goes into the
    train state.

    Over shards (``mesh``: the trees hold this rank's slices) each leaf's
    per-tensor scale is the max over the whole leaf, every leaf's in one
    collective (a max over the mesh's ranks), so a shard's quantization
    is the slice of the whole leaf's."""
    pairs = list(zip(tree_leaves(grads), tree_leaves(residual)))
    amax = [None] * len(pairs)
    if mesh is not None and pairs:
        local = torch.stack([(g.float() + r).abs().amax() for g, r in pairs])
        amax = max_nograd(local, mesh, mesh.axis_names).unbind(0)

    def one(g, r, a):
        g32 = g.float() + r
        q, s = _quantize_int8(g32, a)
        deq = _dequantize_int8(q, s)
        return deq.to(g.dtype), g32 - deq

    out = [one(g, r, a) for (g, r), a in zip(pairs, amax)]
    comp, res = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(comp), grads),
            tree_map(lambda _: next(res), grads))


def init_residual(grads_like: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
