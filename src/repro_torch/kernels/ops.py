"""Public kernel ops: one call per logical kernel, dispatched by device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version (``repro_torch.kernels.cws_hash``, ``repro_torch.kernels.
minmax_gram``, ``repro_torch.kernels.flash_attention``).  ``seq_attention``
picks a sequence-parallel attention schedule by name.
"""
from __future__ import annotations

import torch

from repro_torch.core.cws import CWSParams
from repro_torch.kernels import registry


def cws_encode(x: torch.Tensor, params: CWSParams, *, b_i: int,
               b_t: int = 0) -> torch.Tensor:
    """x (n, D) nonneg -> (n, k) int32 indices into k * 2^{b_i+b_t}."""
    fn = registry.resolve("cws_encode", x.device)
    return fn(x, params, b_i=b_i, b_t=b_t)


def cws_encode_rng(x: torch.Tensor, key, num_hashes: int, *, b_i: int,
                   b_t: int = 0) -> torch.Tensor:
    """As ``cws_encode`` with parameters regenerated from two key words."""
    fn = registry.resolve("cws_encode_rng", x.device)
    return fn(x, key, num_hashes, b_i=b_i, b_t=b_t)


def cws_encode_packed(x: torch.Tensor, params: CWSParams, *, b_i: int,
                      b_t: int = 0) -> torch.Tensor:
    """x (n, D) nonneg -> (n, ceil(k*b/32)) uint32, b = b_i + b_t."""
    fn = registry.resolve("cws_encode_packed", x.device)
    return fn(x, params, b_i=b_i, b_t=b_t)


def cws_encode_rng_packed(x: torch.Tensor, key, num_hashes: int, *,
                          b_i: int, b_t: int = 0) -> torch.Tensor:
    fn = registry.resolve("cws_encode_rng_packed", x.device)
    return fn(x, key, num_hashes, b_i=b_i, b_t=b_t)


def cws_hash(x: torch.Tensor, params: CWSParams):
    """x (n, D) nonneg -> (i*, t*) each (n, k) int32."""
    return registry.resolve("cws_hash", x.device)(x, params)


def cws_hash_rng(x: torch.Tensor, key, num_hashes: int):
    """As ``cws_hash`` with parameters regenerated from two key words."""
    return registry.resolve("cws_hash_rng", x.device)(x, key, num_hashes)


def min_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (m, D), y (n, D) -> (m, n) float32 sum_d min(x, y)."""
    return registry.resolve("min_sum", x.device)(x, y)


def minmax_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Min-max Gram (m, n) of the nonnegative parts of x and y."""
    return registry.resolve("minmax_gram", x.device)(x, y)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, q_base: int = 0,
                    chunk: int = 256) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, G, D) -> (B, Sq, H, D) causal (and,
    with ``window > 0``, sliding-window) attention, rows at global
    positions ``q_base + i``.  When a gradient is wanted the call goes
    through ``flash_attention.FlashAttention``, whose backward recomputes
    through the plain chunked path at ``chunk``, the rows at their global
    positions; otherwise straight to the registry's route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        from repro_torch.kernels.flash_attention import FlashAttention
        return FlashAttention.apply(q, k, v, window, chunk, q_base)
    return registry.resolve("flash_attention", q.device)(
        q, k, v, window=window, q_base=q_base)


def flash_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         carry, *, q_base: int, k_base: int,
                         window: int = 0):
    """Fold the K/V shard ``k``/``v`` (global row 0 at ``k_base``) into the
    fp32 carry (m, l, acc) of q's rows (``None``: a fresh one); returns
    the updated carry, un-normalized."""
    return registry.resolve("flash_attention_step", q.device)(
        q, k, v, carry, q_base=q_base, k_base=k_base, window=window)


# --- sequence-parallel attention schedules ----------------------------------
#
# The reference's registry names (kernels/ops.py:218-250): ``reference`` (the
# naive oracle), ``flash`` (the one-device kernel), ``flash_allgather`` (K/V
# gathered over the seq axes) and ``flash_ring`` (K/V rotated around them).
# With a mesh, q, k and v are this rank's sequence shards and so is the
# output; ``reference`` and ``flash`` then gather q, k and v whole, run on
# one rank's worth of work, and keep this rank's rows.

def _whole(mesh, seq_axes, *ts):
    from repro_torch.launch.collectives import all_gather_dim
    if mesh is None:
        return ts
    return tuple(all_gather_dim(t, mesh, seq_axes, dim=1) for t in ts)


def _own_rows(out, mesh, seq_axes, sq_local):
    if mesh is None:
        return out
    return out.narrow(1, mesh.axis_index(seq_axes) * sq_local, sq_local)


def _attention_reference(q, k, v, *, window, mesh, seq_axes):
    from repro_torch.models.attention import _naive_grouped
    qa, ka, va = _whole(mesh, seq_axes, q, k, v)
    b, s, h, d = qa.shape
    g = ka.shape[2]
    out = _naive_grouped(qa.reshape(b, s, g, h // g, d), ka, va,
                         window=window).reshape(b, s, h, d)
    return _own_rows(out, mesh, seq_axes, q.shape[1])


def _attention_flash(q, k, v, *, window, mesh, seq_axes):
    qa, ka, va = _whole(mesh, seq_axes, q, k, v)
    out = flash_attention(qa, ka, va, window=window)
    return _own_rows(out, mesh, seq_axes, q.shape[1])


def _attention_allgather(q, k, v, *, window, mesh, seq_axes):
    from repro_torch.kernels.flash_attention import sharded_flash_attention
    return sharded_flash_attention(q, k, v, window=window, mesh=mesh,
                                   seq_axes=seq_axes)


def _attention_ring(q, k, v, *, window, mesh, seq_axes):
    from repro_torch.kernels.flash_attention import ring_flash_attention
    return ring_flash_attention(q, k, v, window=window, mesh=mesh,
                                seq_axes=seq_axes)


SEQ_ATTENTION = {"reference": _attention_reference,
                 "flash": _attention_flash,
                 "flash_allgather": _attention_allgather,
                 "flash_ring": _attention_ring}


def seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, impl: str | None = None, mesh=None,
                  seq_axes=("model",)) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, G, D) -> (B, Sq, H, D), this rank's
    sequence shards when a mesh is given.  ``impl=None`` picks ``flash``
    without a mesh and routes ring vs all-gather through ``use_ring`` (on
    the global k/v length) with one; a name pins a schedule."""
    if impl is None:
        if mesh is None:
            impl = "flash"
        else:
            from repro_torch.kernels.flash_attention import (axes_size,
                                                             use_ring)
            n = axes_size(mesh, seq_axes)
            impl = ("flash_ring" if use_ring(n * k.shape[1], n)
                    else "flash_allgather")
    if impl not in SEQ_ATTENTION:
        raise KeyError(f"no attention schedule {impl!r}; the schedules are "
                       f"{sorted(SEQ_ATTENTION)}")
    if mesh is None and impl in ("flash_allgather", "flash_ring"):
        raise ValueError(f"the {impl} schedule runs over a mesh")
    return SEQ_ATTENTION[impl](q, k, v, window=window, mesh=mesh,
                               seq_axes=tuple(seq_axes))
