"""Online serving: latency, throughput and warm-bucket discipline per
bundle mode (twin of ``benchmarks/bench_serve.py``).

Boots a ``ServingService`` for each served pipeline mode, fires a fixed
stream of ragged requests through its gateway and reads the numbers off
the monitor's ``snapshot()`` (the ``/stats`` schema):

  * warmup_ms           launching every bucket shape once
  * p50_ms / p99_ms     request latency percentiles (submit -> logits)
  * qps, rows_per_s     sustained over the whole run
  * compile_count       bucket shapes warmed: must equal len(buckets)
  * buckets             per-bucket batches, real rows and pad rows

The modes and their kernels: ``stored`` (``make_cws_params_jax(
prng_key(0), 64, 32)``, TPU row 2), ``regen`` (row 1) and ``packed``
(``create_regen``, as the reference builds it: row 3), all at D = 64,
k = 32, b_i = 4, buckets (8, 32, 128), weights from
``np.random.default_rng(1)`` (the same in both packages), and the
reference's ``default_rng(7)`` stream of 1-96-row requests at 30 %
density, 60 a mode at ``--fast`` and 400 otherwise, at most 64
outstanding.  Gates after saving (``claims``): ``compile_count ==
len(buckets)`` and dispatched rows equal to submitted rows in every
mode; at ``--fast`` also the reference's request and row counts and
compile count.  Batch counts and pad rows depend on timing and are
reported, as are the latencies.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (check, emit, load_reference,
                                           meta, save_json)
from repro_torch.core import CWSParams, make_cws_params_jax
from repro_torch.core.linear_model import LinearParams
from repro_torch.core.regen import prng_key
from repro_torch.device import resolve_device
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.serving import ServingService

RECORDS = ("BENCH_serve",)
DIM = 64
N_CLASSES = 10
K = 32
B_I = 4
BUCKETS = (8, 32, 128)
MAX_ROWS = 96          # ragged sizes spanning every bucket
WINDOW = 64            # requests outstanding at most (closed loop)
MODES = ("stored", "regen", "packed")
# the kernel each mode launches
KERNEL = {"stored": "cws_encode", "regen": "cws_encode_rng",
          "packed": "cws_encode_rng_packed"}


def make_pipeline(mode: str, dev: torch.device) -> FeaturePipeline:
    spec = FeatureSpec(num_hashes=K, b_i=B_I, packed=(mode == "packed"))
    if mode == "stored":
        p = make_cws_params_jax(prng_key(0), DIM, K)
        return FeaturePipeline(CWSParams(*(m.to(dev) for m in (
            p.r, p.log_c, p.beta))), spec)
    return FeaturePipeline.create_regen(prng_key(0), DIM, spec, device=dev)


def make_weights(pipe: FeaturePipeline) -> LinearParams:
    rng = np.random.default_rng(1)
    w = rng.standard_normal((pipe.num_features, N_CLASSES))
    return LinearParams(
        torch.as_tensor(w, dtype=torch.float32, device=pipe.device),
        torch.zeros((N_CLASSES,), dtype=torch.float32, device=pipe.device))


def requests(n_requests: int):
    """The reference's request stream: (m, D) float32 rows, m in [1, 96],
    |N(0, 1)| at 30 % density."""
    rng = np.random.default_rng(7)
    sizes = rng.integers(1, MAX_ROWS + 1, n_requests)
    reqs = []
    for m in sizes:
        x = np.abs(rng.standard_normal((int(m), DIM))).astype(np.float32)
        reqs.append(x * (rng.random((int(m), DIM)) < 0.3))
    return reqs


def run_mode(mode: str, n_requests: int, dev: torch.device) -> dict:
    pipe = make_pipeline(mode, dev)
    svc = ServingService(make_weights(pipe), pipe, buckets=BUCKETS)
    try:
        reqs = requests(n_requests)
        t0 = time.perf_counter()
        futures = []
        for i, x in enumerate(reqs):
            if i >= WINDOW:
                futures[i - WINDOW].result(timeout=120.0)
            futures.append(svc.submit(x))
        for f in futures[max(0, len(futures) - WINDOW):]:
            f.result(timeout=120.0)
        wall = time.perf_counter() - t0

        s = svc.stats()
        lat = s["latency_ms"]
        out = {
            "requests": n_requests,
            "rows": int(s["rows"]),
            "warmup_ms": svc.warmup_s * 1e3,
            "p50_ms": lat["p50"],
            "p99_ms": lat["p99"],
            "max_ms": lat["max"],
            "qps": n_requests / wall,
            "rows_per_s": s["rows"] / wall,
            "compile_count": int(s["compile_count"]),
            "pad_rows": int(s.get("pad_rows", 0)),
            "buckets": s["buckets"],
        }
        emit(f"serve_{mode}_p50", lat["p50"] * 1e3,
             f"{out['qps']:.0f} req/s")
        return out
    finally:
        svc.stop()


def run(fast: bool = False, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    n_requests = 60 if fast else 400
    rec = {"buckets": list(BUCKETS), "dim": DIM, "num_hashes": K,
           "n_classes": N_CLASSES, "requests_per_mode": n_requests,
           "max_rows": MAX_ROWS, "modes": {}}
    for mode in MODES:
        rec["modes"][mode] = run_mode(mode, n_requests, dev)
    rec.update(meta(dev, "jax", fast))
    save_json(RECORDS[0], rec, out)
    return {RECORDS[0]: rec}


_COUNTS = ("requests", "rows", "compile_count")


def claims(records: dict) -> dict:
    """Every mode warmed exactly its buckets and dispatched the rows its
    clients submitted; at ``--fast`` the reference's counts."""
    rec = records[RECORDS[0]]
    out = {}
    for mode, r in rec["modes"].items():
        out[f"{mode}: compile_count == len(buckets)"] = (
            r["compile_count"] == len(rec["buckets"]))
        out[f"{mode}: dispatched rows == submitted rows"] = (
            sum(b["rows"] for b in r["buckets"].values()) == r["rows"])
    if rec["fast"]:
        ref = load_reference(RECORDS[0])["modes"]
        out["requests, rows and compile counts equal the reference's"] = all(
            rec["modes"][m][c] == ref[m][c] for m in ref for c in _COUNTS)
    return out


def check_claims(records: dict) -> dict:
    return check("serve", claims(records))


def launches(records: dict) -> dict:
    """One launch of each mode's kernel a warmed bucket and a batch."""
    modes = records[RECORDS[0]]["modes"]
    return {KERNEL[m]: r["compile_count"] + sum(
        b["batches"] for b in r["buckets"].values())
            for m, r in modes.items()}
