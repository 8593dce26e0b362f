"""Quickstart: min-max kernels + 0-bit CWS in 60 seconds (port of
``examples/quickstart.py``).

Two nonnegative, sparse, heavy-tailed vectors (D = 512) and k = 2,048 CWS
samples of each: the exact min-max kernel against its full, 0-bit and
8-bit-bucketed collision estimates, then the min-max Gram of four random
rows (on the card, the min-sum kernel).  The inputs and the CWS matrices
come from a numpy seed (``inputs``), so the reference's functions can be
held to the same arrays.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (CWSParams, collision_estimate, cws_hash,
                              encode, full_collision_estimate, minmax_gram,
                              minmax_pair)
from repro_torch.device import resolve_device

D, K = 512, 2048


def inputs(seed: int = 0, dim: int = D, k: int = K) -> dict:
    """u, v, a (4, dim) batch and the (dim, k) CWS matrices (r and c
    Gamma(2, 1) as two exponentials, beta uniform), float32."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    u = np.exp(rng.standard_normal(dim)) * (rng.random(dim) < 0.4)
    v = u * np.exp(0.4 * rng.standard_normal(dim)) * (rng.random(dim) < 0.85)
    gamma2 = lambda: rng.standard_exponential((dim, k)) + \
        rng.standard_exponential((dim, k))
    r, c = gamma2(), gamma2()
    return {"u": f32(u), "v": f32(v),
            "batch": f32(np.exp(rng.standard_normal((4, dim)))),
            "r": f32(r), "log_c": f32(np.log(f32(c))),
            "beta": f32(rng.random((dim, k)))}


def run(arrays: dict, device=None, log=print) -> dict:
    dev = resolve_device(device)
    t = {name: torch.from_numpy(a).to(dev) for name, a in arrays.items()}
    u, v = t["u"], t["v"]
    out = {"k_true": float(minmax_pair(u, v))}
    log(f"exact min-max kernel K(u,v)      = {out['k_true']:.4f}")

    # CWS: k independent samples per vector
    params = CWSParams(t["r"], t["log_c"], t["beta"])
    k = params.num_hashes
    i_star, t_star = cws_hash(torch.stack([u, v]), params)   # (2, k) each
    out["est_full"] = float(full_collision_estimate(
        i_star[0], t_star[0], i_star[1], t_star[1]))
    out["est_0bit"] = float(collision_estimate(i_star[0], i_star[1]))
    log(f"full CWS estimate  (i*, t*)      = {out['est_full']:.4f}")
    log(f"0-bit CWS estimate (i* only)     = {out['est_0bit']:.4f}   "
        f"<- the paper")

    # b-bit bucketing for linear learning
    codes = encode(i_star, t_star, b_i=8)
    out["est_8bit"] = float(collision_estimate(codes[0], codes[1]))
    log(f"8-bit-bucketed estimate          = {out['est_8bit']:.4f} "
        f"(feature dim = {k} x 256)")

    # Gram matrix of a small batch
    gram = minmax_gram(t["batch"], t["batch"])
    out["gram"] = gram.cpu().numpy()
    log("\nmin-max Gram of 4 random vectors:")
    log(np.round(out["gram"], 3))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(inputs(), args.device)


if __name__ == "__main__":
    main()
