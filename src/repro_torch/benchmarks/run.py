"""Benchmark harness of the twins: one module per paper table / figure
and per benchmark of the reference's ``benchmarks/``.

Prints ``name,us_per_call,derived`` CSV rows and writes each suite's JSON
records under ``--out`` (default ``src/repro_torch/benchmarks/results``),
then checks the suite's paper claims; a failed claim fails the run, as
the reference's asserts do.  ``--fast`` runs the reference's reduced
sizes.  Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast]
      [--only table1|table2|fig45|fig6|fig78|fault_tolerance|
              packed_features|serve|cws_kernel|ring_attention]
      [--device cuda|cpu]
      [--out DIR]
"""
from __future__ import annotations

import argparse
import time
import traceback

from repro_torch.benchmarks import (bench_cws_kernel, bench_fault_tolerance,
                                    bench_packed_features,
                                    bench_ring_attention, bench_serve,
                                    fig45_cws_mse, fig6_tstar_only,
                                    fig78_linear_svm, table1_kernel_svm,
                                    table2_wordpairs)
from repro_torch.device import resolve_device

SUITES = {
    "table1": table1_kernel_svm,
    "table2": table2_wordpairs,
    "fig45": fig45_cws_mse,
    "fig6": fig6_tstar_only,
    "fig78": fig78_linear_svm,
    "fault_tolerance": bench_fault_tolerance,
    "packed_features": bench_packed_features,
    "serve": bench_serve,
    "cws_kernel": bench_cws_kernel,
    "ring_attention": bench_ring_attention,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default="", choices=("",) + tuple(SUITES))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    records, failures, failed_claims = {}, [], {}
    for name, mod in SUITES.items():
        if args.only and args.only != name:
            continue
        print(f"# === {name} ===", flush=True)
        t0 = time.perf_counter()
        try:
            out = mod.run(fast=args.fast, device=dev, out=args.out)
            print(f"# {name}: {time.perf_counter() - t0:.1f} s", flush=True)
            records.update(out)
            claims = mod.claims(out)
            print(f"# {name} claims: " + "; ".join(
                f"{c}: {'pass' if ok else 'FAIL'}"
                for c, ok in claims.items()), flush=True)
            failed_claims[name] = [c for c, ok in claims.items() if not ok]
            mod.check_claims(out)
        except Exception as e:
            failures.append((name, e))
            traceback.print_exc()
    if failures:
        print(f"# {len(failures)} benchmark suites FAILED:"
              f" {[n for n, _ in failures]}; failed claims: "
              f"{ {k: v for k, v in failed_claims.items() if v} }")
        raise SystemExit(1)
    print("# all benchmark suites passed")
    return records


if __name__ == "__main__":
    main()
