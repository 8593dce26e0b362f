"""Naive oracles for the kernels (port of ``repro.kernels.ref``).

Deliberately the naive formulations, 3-D broadcasts with no tiling or
chunking, so the kernels and their chunked plain versions are checked
against code that shares none of their tiling logic.  Memory grows as
n * D * k (or m * n * D): for small shapes only.
"""
from __future__ import annotations

import math

import torch


def cws_hash_ref(x, r, log_c, beta):
    """x (n, D) nonneg; r/log_c/beta (D, k) -> (i*, t*) each (n, k) int32.

    log a_i = log c_i - r_i (floor(log u_i / r_i + beta_i) - beta_i + 1)
    """
    x = x.to(torch.float32)
    logu = torch.where(x > 0, torch.log(torch.clamp_min(x, 1e-38)),
                       -math.inf)
    lu = logu[:, :, None]                                  # (n, D, 1)
    t = torch.floor(lu / r[None] + beta[None])             # (n, D, k)
    log_a = log_c[None] - r[None] * (t - beta[None] + 1.0)
    log_a = torch.where(torch.isfinite(lu), log_a, math.inf)
    i_star = torch.argmin(log_a, dim=1)
    t_star = torch.gather(t, 1, i_star[:, None, :])[:, 0, :]
    t_star = torch.clamp(t_star, -2.0 ** 30, 2.0 ** 30).to(torch.int32)
    all_zero = ~torch.isfinite(logu).any(dim=1)[:, None]
    i_star = torch.where(all_zero, -1, i_star).to(torch.int32)
    t_star = torch.where(all_zero, 0, t_star).to(torch.int32)
    return i_star, t_star


def minmax_gram_ref(x, y):
    """x (m, D), y (n, D) nonneg -> K_MM (m, n) float32, from sum of
    minima over sum of maxima (no min-sum identity)."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    mins = torch.minimum(x[:, None, :], y[None, :, :]).sum(-1)
    maxs = torch.maximum(x[:, None, :], y[None, :, :]).sum(-1)
    return mins / torch.clamp_min(maxs, 1e-30)


def min_sum_ref(x, y):
    x, y = x.to(torch.float32), y.to(torch.float32)
    return torch.minimum(x[:, None, :], y[None, :, :]).sum(-1)
