#!/usr/bin/env python3
"""Check and time the linear head of the port (``bag_logits``) on the card.

    python3 tools/bag_head.py

1. Rounding.  ``chip_smoke.py``'s train-phase fits A (regen parameters,
   b_i = 8) and B (stored parameters, packed b_i = 4) at the paper
   configuration's full width, 600-row batches for 500 steps, on the
   card, with every forward's gathered rows summed in float64 a second
   time on the CPU: the logits counted, those whose float64 sums differ
   between the two devices (the sums were inexact and the devices added
   in other orders), and those whose float32 roundings differ, which the
   head promises do not occur but on a tie within float64's rounding.
2. Time.  The head's forward on fit A's trained table at the serving
   buckets and the training batch, three ways: the port's (one float64
   reduction), a fixed tree of float32 adds (log2 k elementwise
   launches, device-independent by construction) and a float32 ``sum``
   (one reduction that rounds in each device's order): device ms between
   CUDA events (``chip_smoke.time_ms``) and wall ms a call (the host's
   enqueue included, the card synchronized once after the calls), timed
   in turns (port, tree, float32, float32, tree, port) and averaged per
   way.

Prints one line a part and a shape, the card's name and power limit, then
a JSON summary.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.core import linear_model as LM  # noqa: E402
from repro_torch.core.regen import prng_key  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_template_classification)
from repro_torch.pipeline import FeaturePipeline, FeatureSpec  # noqa: E402
from repro_torch.training import fit_linear_streamed  # noqa: E402

SHAPES = C.BUCKETS + (C.TRAIN_BATCH,)
REPS = 200


def _rows(params, idx):
    n, k = idx.shape
    flat = idx.to(torch.int64).clamp(0, params.w.shape[0] - 1).reshape(-1)
    return params.w.index_select(0, flat).view(n, k, params.w.shape[1])


def tree_head(params, idx):
    """The k rows summed as ((x0 + x1) + (x2 + x3)) + ... in float32."""
    x = _rows(params, idx).transpose(0, 1)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pairs = x[0:2 * half:2] + x[1:2 * half:2]
        x = torch.cat([pairs, x[2 * half:]]) if x.shape[0] % 2 else pairs
    return x[0] + params.b


def f32_head(params, idx):
    return _rows(params, idx).sum(1) + params.b


HEADS = {"float64": LM.bag_logits, "tree": tree_head, "float32": f32_head}


def wall_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def fits(dev, steps):
    """Fits A and B with the head's rows also summed on the CPU: (fit A's
    table, its pipeline, the test rows, the rounding counts)."""
    ds = make_template_classification(1, n_classes=C.N_CLASSES, density=0.15,
                                      mult_noise=1.2, spike_prob=0.08,
                                      dim=C.DIM, **C.TRAIN_DATA)
    xtr, ytr = (torch.from_numpy(a).to(dev) for a in (ds.x_train,
                                                      ds.y_train))
    stored = C.stored_params(np.random.default_rng(C.TRAIN_SEED), C.DIM,
                             C.NUM_HASHES, dev)
    pipes = {"A": FeaturePipeline.create_regen(
                 prng_key(0), C.DIM, FeatureSpec(C.NUM_HASHES, C.B_I),
                 device=dev),
             "B": FeaturePipeline(stored, FeatureSpec(
                 C.NUM_HASHES, C.TRAIN_B_PACKED, packed=True))}
    cfg = LM.TrainCfg(n_classes=C.N_CLASSES, steps=steps, lr=C.CONFIG.lr,
                      l2=C.CONFIG.l2, batch_size=C.TRAIN_BATCH)
    stats = {"logits": 0, "float64_differ": 0, "float32_differ": 0}
    forward = LM._BagLogits.forward

    def checked(ctx, table, bias, idx):
        n, k = idx.shape
        rows = table.index_select(0, idx.reshape(-1)).view(n, k, -1)
        card = rows.sum(1, dtype=torch.float64).cpu()
        host = rows.cpu().sum(1, dtype=torch.float64)
        stats["logits"] += card.numel()
        stats["float64_differ"] += int((card != host).sum())
        stats["float32_differ"] += int((card.float() != host.float()).sum())
        return forward(ctx, table, bias, idx)

    LM._BagLogits.forward = staticmethod(checked)
    try:
        out = {name: fit_linear_streamed(
            LM.init_bag(pipe.num_features, C.N_CLASSES, device=dev), pipe,
            xtr, ytr, cfg=cfg, shuffle_key=prng_key(0))
            for name, pipe in pipes.items()}
    finally:
        LM._BagLogits.forward = staticmethod(forward)
    return out["A"], pipes["A"], torch.from_numpy(ds.x_test).to(dev), stats


@torch.no_grad()
def times(params, pipe, xte, reps):
    idx_all = pipe.features(xte)
    rows = {}
    for n in SHAPES:
        idx = idx_all[torch.arange(n, device=idx_all.device) %
                      idx_all.shape[0]]
        want = LM.bag_logits(params, idx)
        err = {k: float((f(params, idx) - want).abs().max())
               for k, f in HEADS.items()}
        got = {k: {"ms": [], "wall_ms": []} for k in HEADS}
        for k in ("float64", "tree", "float32", "float32", "tree",
                  "float64"):
            fn = lambda k=k: HEADS[k](params, idx)
            got[k]["ms"].append(C.time_ms(fn, reps))
            got[k]["wall_ms"].append(wall_ms(fn, reps))
        rows[n] = {k: {m: float(np.mean(v)) for m, v in t.items()}
                   for k, t in got.items()}
        rows[n]["max_abs_vs_float64"] = err
        print(f"head n={n} (k={C.NUM_HASHES}, {C.N_CLASSES} classes): "
              + "; ".join(f"{k} {rows[n][k]['ms']:.4f} ms device, "
                          f"{rows[n][k]['wall_ms']:.4f} ms wall"
                          for k in HEADS)
              + f"; max |logit - float64 head| tree {err['tree']:.3g} "
              f"float32 {err['float32']:.3g}")
    return rows


def main(dev=torch.device("cuda"), steps=C.TRAIN_STEPS, reps=REPS):
    smi = C.nvidia_smi()
    t0 = time.perf_counter()
    params, pipe, xte, stats = fits(dev, steps)
    print(f"rounding [{smi}]: fits A and B, {steps} steps of "
          f"{C.TRAIN_BATCH} rows: {stats['logits']} logits, float64 sums "
          f"differing card vs CPU {stats['float64_differ']}, float32 "
          f"logits differing {stats['float32_differ']} "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = times(params, pipe, xte, reps)
    print(smi)
    print(json.dumps({"card": smi, "rounding": stats, "times": rows}))


if __name__ == "__main__":
    main()
