"""Measured plan autotune for the kernel registry's plan table (twin of
``tools/autotune_blocks.py``).

Sweeps every legal plan of each kernel family at each shape on the card,
times each launch with CUDA events after a warm-up, and persists the
winners in the plan table's format (``registry.save_block_table`` JSON,
replayed by ``registry.load_block_table``):

  * ``cws``, ``cws_rng``, ``cws_packed``, ``cws_rng_packed``: the split
    body's ``SplitPlan`` fields (rows per thread, row warps, splits) of
    TPU rows 2, 1, 4 and 3 (b_i = 8 encodes, as the reference sweeps);
  * ``min_sum``: the Gram's ``GramPlan`` choice (tile, slices of D, or the
    small-output mode) of row 7.

Every candidate's output is held against the default plan's first: bit
for bit on the CWS rows, within 2·D·2^-24·S on row 7 (two fp32 sums of D
nonnegative terms in other orders); a candidate that differs raises, it
does not lose.  Shapes are ``n x D x k`` for the CWS families and ``m x D
x n`` for min_sum, on the reference's rows (``rand_nonneg``); winners are
keyed on the pow2-bucketed shape (``registry.table_key``).

    # measure and persist (on the card)
    python -m repro_torch.tools.autotune_blocks \\
        --families cws,cws_rng,cws_packed,cws_rng_packed,min_sum \\
        --shapes 1024x512x512 4096x1024x1024 --out build/plan_table.json

    # enumerate candidates and the default plans: no timing, no file
    python -m repro_torch.tools.autotune_blocks --dry-run
"""
from __future__ import annotations

import argparse
import pathlib

import torch

from repro_torch.benchmarks.common import rand_nonneg
from repro_torch.core import CWSParams, make_cws_params_jax
from repro_torch.core.regen import prng_key
from repro_torch.device import sm_count
from repro_torch.kernels import cws_hash, minmax_gram, registry

DEFAULT_SHAPES = ("1024x512x512", "4096x1024x1024")
B_I = 8
H100_SMS = 132        # the default plans a dry run on the CPU shows
QUEUE_AHEAD_CYCLES = 20_000_000    # ~10 ms of sleep ahead of a timing
REPEATS = 20                       # launches timed a candidate
U32 = 2.0 ** -24


def parse_shape(s: str):
    n, d, k = (int(v) for v in s.lower().split("x"))
    return n, d, k


def candidates(op: str, n: int, d: int, k: int):
    """Every plan entry the family's kernel can launch at this shape
    (``registry.plan_candidates``)."""
    return registry.plan_candidates(op, (n, d, k))


def to_plan(op: str, n: int, d: int, k: int, entry: dict, sms: int):
    """The kernel's plan object for a table entry
    (``registry.plan_of``)."""
    return registry.plan_of(op, (n, d, k), entry, sms)


def default_entry(op: str, n: int, d: int, k: int, sms: int) -> dict:
    """The entry of the plan the kernel takes with no table loaded."""
    fam = registry.family(op)
    if fam == "min_sum":
        p = minmax_gram.gram_plan(n, k, d, sms)
        return {"tile": p.tile, "splits": p.splits, "small": p.small}
    p = cws_hash.split_plan(n, d, k, sms,
                            stored=fam in ("cws", "cws_packed"))
    return {"rows_per_thread": p.rows_per_thread, "row_warps": p.row_warps,
            "splits": p.splits}


def launcher(op: str, n: int, d: int, k: int, dev: torch.device):
    """(plan -> output) for one family at one shape, on the card."""
    fam = registry.family(op)
    x = rand_nonneg(prng_key(0), (n, d), device=dev)
    if fam == "min_sum":
        y = rand_nonneg(prng_key(2), (k, d), device=dev)
        return lambda plan: minmax_gram.min_sum_cuda(x, y, plan=plan)
    key = prng_key(1)
    if fam in ("cws_rng", "cws_rng_packed"):
        fn = (cws_hash.cws_encode_rng_cuda if fam == "cws_rng" else
              cws_hash.cws_encode_rng_packed_cuda)
        return lambda plan: fn(x, key, k, b_i=B_I, plan=plan)
    p = make_cws_params_jax(key, d, k)
    params = CWSParams(*(m.to(dev) for m in (p.r, p.log_c, p.beta)))
    fn = (cws_hash.cws_encode_cuda if fam == "cws" else
          cws_hash.cws_encode_packed_cuda)
    return lambda plan: fn(x, params, b_i=B_I, plan=plan)


def time_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn()`` over ``repeats`` calls between CUDA
    events, a sleep kernel queued ahead so that the host's enqueueing is
    not what is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def check_same(op: str, entry: dict, got, want, d: int) -> None:
    """``got`` (a candidate's output) against the default plan's: equal on
    the CWS rows; on row 7 within 2·D·2^-24·S + 1e-30 of each S."""
    if registry.family(op) == "min_sum":
        err = (got.double() - want.double()).abs()
        bound = 2 * d * U32 * want.double() + 1e-30
        if got.shape != want.shape or not bool((err <= bound).all()):
            raise AssertionError(f"{op} plan {entry}: |S - S_default| up to "
                                 f"{float((err / bound).max()):.3g} of "
                                 f"2·D·2^-24·S")
    elif not torch.equal(got, want):
        raise AssertionError(f"{op} plan {entry}: output differs from the "
                             f"default plan's")


def tune(op: str, n: int, d: int, k: int, *, sms: int,
         dry_run: bool = False, dev: torch.device | None = None):
    """Sweep one (family, shape) cell: (winner entry, its ms, [(entry,
    ms), ...]); a dry run returns the default entry and no timings."""
    cands = candidates(op, n, d, k)
    heur = default_entry(op, n, d, k, sms)
    print(f"[{op}] {n}x{d}x{k}: {len(cands)} candidates, default {heur}",
          flush=True)
    if dry_run:
        return heur, float("nan"), []
    run = launcher(op, n, d, k, dev)
    want = run(to_plan(op, n, d, k, heur, sms))
    rows, best, best_ms = [], None, float("inf")
    for entry in cands:
        plan = to_plan(op, n, d, k, entry, sms)
        check_same(op, entry, run(plan), want, d)
        ms = time_ms(lambda: run(plan), REPEATS)
        rows.append((entry, ms))
        mark = ""
        if ms < best_ms:
            best, best_ms, mark = entry, ms, "  <-- best"
        print(f"  {entry}: {ms * 1e3:.1f} us{mark}", flush=True)
    return best, best_ms, rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.autotune_blocks",
        description=__doc__.splitlines()[0])
    ap.add_argument("--families",
                    default="cws,cws_rng,cws_packed,cws_rng_packed,min_sum")
    ap.add_argument("--shapes", nargs="*", default=list(DEFAULT_SHAPES),
                    help="problem shapes as NxDxK")
    ap.add_argument("--out", default="build/plan_table.json")
    ap.add_argument("--dry-run", action="store_true",
                    help="candidates and default plans only: no card, no "
                         "timing, nothing written")
    args = ap.parse_args(argv)

    dev = None
    if args.dry_run:
        sms = (sm_count(torch.cuda.current_device())
               if torch.cuda.is_available() else H100_SMS)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the autotune sweep times kernels on a CUDA "
                               "card; --dry-run runs without one")
        dev = torch.device("cuda", torch.cuda.current_device())
        sms = sm_count(dev.index)
    print(f"sms={sms} shapes={args.shapes}", flush=True)

    entries, sweeps = {}, {}
    for op in (f.strip() for f in args.families.split(",")):
        if registry.family(op) not in registry.PLAN_FAMILIES:
            raise ValueError(f"no plans for family {op!r}; families: "
                             f"{registry.PLAN_FAMILIES}")
        for s in args.shapes:
            n, d, k = parse_shape(s)
            best, best_ms, rows = tune(op, n, d, k, sms=sms,
                                       dry_run=args.dry_run, dev=dev)
            sweeps[(op, s)] = rows
            if not args.dry_run:
                entries[registry.table_key(op, n, d, k)] = best
                print(f"[{op}] {s}: winner {best} @ {best_ms * 1e3:.1f} us",
                      flush=True)
    if args.dry_run:
        print("dry-run: no entries written")
        return {"entries": {}, "sweeps": sweeps}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    registry.save_block_table(out, entries)
    print(f"wrote {len(entries)} measured entries -> {out}")
    return {"entries": entries, "sweeps": sweeps, "path": str(out)}


if __name__ == "__main__":
    main()
