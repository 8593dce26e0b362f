"""Kernel-contract lint (``repro_torch.analysis``'s command line, twin of
the reference's ``tools/kernel_lint.py``).

Runs the eight-check suite over the registry and prints the check
matrix, and optionally writes the JSON report:

    python -m repro_torch.tools.kernel_lint --all --strict
    python -m repro_torch.tools.kernel_lint --families cws,cws_packed
    python -m repro_torch.tools.kernel_lint --checks numerics
    python -m repro_torch.tools.kernel_lint --all --json build/lint.json

``--strict`` exits 1 on any error finding (an op missing an impl, a
model or a probe; a shared-memory model over sm_90's block limit or off
its pinned bytes; an output element written twice or never; an alias or
an undeclared in-place write; an unbound axis, a non-permutation ring or
a gradient summed twice; an unblessed narrowing or a sub-fp32 product
cuBLAS may reduce at that precision; an int32 wrap or an out-of-table
gather; a global-generator draw, an unblessed float scatter or drifted
impl signatures).  ``--checks`` takes a comma-separated subset;
``numerics`` expands to dtype_flow,int_range,determinism.
``--exhaustive`` audits every candidate plan at more shapes and every
head dim of the flash bodies.  It runs on the CPU (the plain versions
and ``meta`` tensors) and needs no card; what only the card can say is
``chip_smoke.py``'s contracts phase.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kernel_lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="audit every kernel family (the default when "
                         "--families is not given)")
    ap.add_argument("--families", default="",
                    help="comma-separated kernel families to audit")
    ap.add_argument("--checks", "--check", default="",
                    help="comma-separated subset of checks; 'numerics' "
                         "expands to dtype_flow,int_range,determinism")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any error finding")
    ap.add_argument("--exhaustive", action="store_true",
                    help="every candidate plan at more shapes, every "
                         "flash head dim")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the machine-readable report to PATH")
    args = ap.parse_args(argv)

    from repro_torch.analysis import CHECKS, NUMERICS_CHECKS, run_suite

    families = [f for f in args.families.split(",") if f] or None
    checks = []
    for tok in (c for c in args.checks.split(",") if c):
        checks.extend(NUMERICS_CHECKS if tok == "numerics" else (tok,))
    checks = tuple(dict.fromkeys(checks)) or CHECKS
    unknown = sorted(set(checks) - set(CHECKS))
    if unknown:
        ap.error(f"unknown checks {unknown}; the checks are {CHECKS}")
    report = run_suite(families, checks=checks, exhaustive=args.exhaustive)

    print(report.to_text())
    if args.json:
        report.save(args.json)
        print(f"report written to {args.json}")
    if args.strict and report.failures:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
