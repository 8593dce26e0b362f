"""Serving driver: boot a replica from a served-model bundle and drive
synthetic request traffic through its gateway.

    PYTHONPATH=src python -m repro_torch.launch.serve --bundle DIR \
        --requests 200 --max-rows 48 --stats-port 0 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def synthetic_rows(rng: np.random.Generator, m: int, dim: int) -> np.ndarray:
    """``m`` sparse nonnegative rows, about 30% nonzero."""
    x = np.abs(rng.standard_normal((m, dim))).astype(np.float32)
    x *= rng.random((m, dim)) < 0.3
    return x


def serve_bundle(args) -> dict:
    """Load the bundle, warm the buckets, fire synthetic traffic, print the
    monitoring snapshot; returns it with the wall time and request rate."""
    from repro_torch.serving import ServingService

    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    svc = ServingService.from_bundle(
        args.bundle, device=args.device, buckets=buckets,
        default_deadline_s=args.deadline_s,
        hard_timeout_s=args.hard_timeout_s)
    try:
        if args.stats_port is not None:
            url = svc.start_stats_server(port=args.stats_port).url
            print(f"stats endpoint: {url}")
        print(f"warmed {len(svc.runner.buckets)} buckets "
              f"{svc.runner.buckets} in {svc.warmup_s * 1e3:.1f} ms")

        rng = np.random.default_rng(args.seed)
        dim = svc.runner.pipe.dim
        futures = []
        t0 = time.perf_counter()
        for _ in range(args.requests):
            m = int(rng.integers(1, args.max_rows + 1))
            futures.append(svc.submit(synthetic_rows(rng, m, dim)))
        for f in futures:
            f.result(timeout=args.deadline_s + 30.0)
        wall = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        svc.stop()
    lat = stats["latency_ms"]
    print(f"{args.requests} requests ({stats['rows']} rows) in "
          f"{wall:.3f}s -> {args.requests / wall:,.1f} req/s; latency "
          f"p50 {lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms")
    print(json.dumps(stats, indent=1, sort_keys=True))
    return {"stats": stats, "wall_s": wall,
            "req_per_s": args.requests / wall}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bundle", required=True,
                    help="served-model bundle directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                    "PyTorch kernels)")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--max-rows", type=int, default=32,
                    help="synthetic request sizes draw from [1, max-rows]")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket ladder override")
    ap.add_argument("--deadline-s", type=float, default=30.0)
    ap.add_argument("--hard-timeout-s", type=float, default=0.0)
    ap.add_argument("--stats-port", type=int, default=None,
                    help="expose GET /stats on this port (0 = pick free)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    serve_bundle(parser().parse_args(argv))


if __name__ == "__main__":
    main()
