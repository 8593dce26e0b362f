"""The min-sum Gram kernel: CUDA launcher beside its plain version.

Port of ``repro/kernels/minmax_gram.py``.  ``S[m, n] = sum_d min(x[m, d],
y[n, d])`` is the kernel (``csrc/minmax_gram.cu``); the min-max Gram

    K = S / max(sum x + sum y - S, 1e-30)      (nonnegative x, y)

follows from it in PyTorch, as the reference also computes it outside its
Pallas kernel.  ``min_sum_plain`` / ``minmax_gram_plain`` are the
definitions the kernel is held to (chunked over rows so the (rows, n, D)
temporary stays bounded); the ``_cuda`` launchers check their inputs,
allocate with ``torch.empty``, launch on the current stream, raise on a
launch error and bump ``LAUNCHES["min_sum"]``.  ``repro_torch.kernels.ops``
chooses between the two by the tensors' device; a launcher never falls
back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import minmax_gram_library

LAUNCHES = {"min_sum": 0}

# Elements of one (rows, n, D) temporary in the plain version (128 MiB).
_CHUNK_ELEMS = 1 << 25
_TILE_ROWS = 64            # rows of x per block in the kernel
_GRID_Y_MAX = 65535
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nonneg(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.to(torch.float32), 0.0)


def _minmax_epilogue(x, y, mins):
    maxs = x.sum(-1)[:, None] + y.sum(-1)[None, :] - mins
    return mins / torch.clamp_min(maxs, 1e-30)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def min_sum_plain(x, y):
    """x (m, D), y (n, D) -> (m, n) float32 sums of elementwise minima."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rb = max(1, _CHUNK_ELEMS // max(n * d, 1))
    for r0 in range(0, m, rb):
        out[r0:r0 + rb] = torch.minimum(x[r0:r0 + rb, None, :],
                                        y[None, :, :]).sum(-1)
    return out


def minmax_gram_plain(x, y):
    """Min-max Gram (m, n) of the nonnegative parts of x (m, D), y (n, D)."""
    x, y = _nonneg(x), _nonneg(y)
    return _minmax_epilogue(x, y, min_sum_plain(x, y))


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _check(x, y):
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"the CUDA min-sum kernel takes CUDA tensors; "
                             f"{name} is not one")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D (rows, D); got "
                             f"{tuple(t.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"x has D = {x.shape[1]} but y has D = "
                         f"{y.shape[1]}")
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if max(x.shape + y.shape) > _INT_MAX:
        raise ValueError("min-sum shapes exceed int32")
    if -(-x.shape[0] // _TILE_ROWS) > _GRID_Y_MAX:
        raise ValueError(f"x has {x.shape[0]} rows; the kernel takes at "
                         f"most {_TILE_ROWS * _GRID_Y_MAX}")
    return x, y


def min_sum_cuda(x, y):
    """Min-sum Gram kernel (replaces ``_min_sum_pallas``)."""
    x, y = _check(x, y)
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = minmax_gram_library().lib.min_sum_launch(
            x.data_ptr(), y.data_ptr(), m, n, d, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"min_sum kernel launch failed: cudaError {rc}")
    LAUNCHES["min_sum"] += 1
    return out


def minmax_gram_cuda(x, y):
    """Min-max Gram: the min-sum kernel, then the epilogue in PyTorch
    (replaces ``_minmax_gram_pallas``)."""
    x, y = _check(x, y)
    x, y = _nonneg(x), _nonneg(y)
    return _minmax_epilogue(x, y, min_sum_cuda(x, y))
