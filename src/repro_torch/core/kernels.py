"""The paper's kernels (Eqs. 1-5) as Gram matrices (port of
``repro.core.kernels``).

For nonnegative u, v:
    min-max       K_MM  = sum_i min(u_i,v_i) / sum_i max(u_i,v_i)      (1)
    resemblance   K_R   = |u>0 & v>0| / |u>0 | v>0|                    (2)
    intersection  K_I   = sum_i min(u_i,v_i),  with sum-to-one inputs  (3)
    n-min-max     K_NMM = K_MM on sum-to-one inputs                    (4)
    linear        K_rho = <u,v>, with unit-L2 inputs                   (5)

For nonnegative data ``max(u,v) = u + v - min(u,v)``, so one min-sum pass
and two row sums give the min-max Gram.  The min-sum Grams go through
``repro_torch.kernels.ops``: on CUDA tensors they launch the min-sum kernel
(``csrc/minmax_gram.cu``), on CPU tensors they run its plain chunked
version.  The linear Gram is a plain ``torch.matmul``, as the reference
leaves it to XLA; on the card it runs in full fp32 (TF32 off, the PyTorch
default, which ``linear_gram`` checks).
"""
from __future__ import annotations

import torch


def _ops():
    # imported at call time: repro_torch.kernels imports repro_torch.core,
    # whose package imports this module
    from repro_torch.kernels import ops
    return ops


def _nonneg(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.to(torch.float32), 0.0)


def sum_to_one(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    x = _nonneg(x)
    s = x.sum(dim=dim, keepdim=True)
    return x / torch.clamp_min(s, 1e-30)


def unit_l2(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = torch.sqrt(torch.square(x).sum(dim=dim, keepdim=True))
    return x / torch.clamp_min(n, 1e-30)


def minmax_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K_MM Gram matrix (m, n) between the nonnegative parts of the rows
    of x (m, D) and y (n, D)."""
    return _ops().minmax_gram(x, y)


def nminmax_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return minmax_gram(sum_to_one(x), sum_to_one(y))


def intersection_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _ops().min_sum(sum_to_one(x), sum_to_one(y))


def linear_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("linear_gram needs full fp32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return unit_l2(x.to(torch.float32)) @ unit_l2(y.to(torch.float32)).T


def resemblance_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return minmax_gram((x > 0).to(torch.float32), (y > 0).to(torch.float32))


def minmax_pair(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K_MM for a single pair of vectors (the word-pair study)."""
    u, v = _nonneg(u), _nonneg(v)
    mins = torch.minimum(u, v).sum()
    maxs = torch.maximum(u, v).sum()
    return mins / torch.clamp_min(maxs, 1e-30)


def resemblance_pair(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return minmax_pair((u > 0).to(torch.float32), (v > 0).to(torch.float32))


GRAM_FNS = {
    "linear": linear_gram,
    "min-max": minmax_gram,
    "n-min-max": nminmax_gram,
    "intersection": intersection_gram,
    "resemblance": resemblance_gram,
}
