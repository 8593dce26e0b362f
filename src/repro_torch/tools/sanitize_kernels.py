"""Rows 1-9 under NVIDIA's compute-sanitizer (memcheck, racecheck).

Without ``--tools`` this launches each of the nine kernels through its
launcher at the ragged shapes of ``repro_torch.analysis.coverage``
(n x D x k = 77 x 150 x 70 for rows 1-6 on their default plan and on one
with eight cluster ranks; m x D x n = 150 x 99 x 90 for row 7 on its
default plan, a sliced plan and the small-output mode; rows 8-9 on the
wgmma body at D = 128 and 64 and the SIMT body at D = 40, Sq = Sk = 100),
compares each with its plain version and exits non-zero on a mismatch.
With ``--tools memcheck,racecheck`` it builds the kernels, then runs
itself once under ``compute-sanitizer --tool <tool>`` for each tool and
prints each run's errors or hazards and seconds:

    python -m repro_torch.tools.sanitize_kernels --tools memcheck,racecheck

It needs a card and the CUDA toolkit's ``compute-sanitizer``.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import time

import torch

CWS_SHAPE = (77, 150, 70)
GRAM_SHAPE = (150, 99, 90)
FLASH_SHAPES = ((1, 100, 8, 2, 128, torch.bfloat16),
                (1, 100, 4, 4, 64, torch.bfloat16),
                (1, 100, 6, 2, 40, torch.float32))
U32 = 2.0 ** -24
TOOL_TIMEOUT_S = 900      # one tool's run of the launches


def _rows(n, d, gen, dev):
    x = torch.rand((n, d), generator=gen, device=dev)
    return torch.where(x < 0.4, torch.zeros_like(x), x)


def launch_all(dev) -> int:
    """Each row at its ragged shapes against its plain version; returns
    the launches made."""
    from repro_torch.core.cws import make_cws_params
    from repro_torch.core.regen import prng_key
    from repro_torch.kernels import cws_hash as K
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import minmax_gram as G
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d, k = CWS_SHAPE
    x = _rows(n, d, gen, dev)
    params = make_cws_params(torch.Generator(device=dev).manual_seed(8), d, k)
    key = prng_key(9)
    launches = 0
    for op in ("cws_encode_rng", "cws_encode", "cws_encode_rng_packed",
               "cws_encode_packed", "cws_hash", "cws_hash_rng"):
        args = (x, key, k) if "rng" in op else (x, params)
        kw = {} if op.startswith("cws_hash") else {"b_i": 8}
        plans = [None]
        if op != "cws_hash_rng":        # its launcher takes no plan
            plans.append(K.SplitPlan(n, d, k, 1, 16, 8))
        for plan in plans:
            extra = {} if plan is None else {"plan": plan}
            got = getattr(K, op + "_cuda")(*args, **kw, **extra)
            want = getattr(K, op + "_plain")(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"{op} {plan}: differs from plain")
            launches += 1
    m, d, nn = GRAM_SHAPE
    xg, yg = _rows(m, d, gen, dev), _rows(nn, d, gen, dev)
    want = G.min_sum_plain(xg, yg).double()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for plan in (None, G.gram_plan(m, nn, d, sms, tile=(64, 64), splits=4),
                 G.gram_plan(m, nn, d, sms, small=True)):
        got = G.min_sum_cuda(xg, yg, plan=plan).double()
        if not bool(((got - want).abs() <= 2 * d * U32 * want + 1e-30)
                    .all()):
            raise AssertionError(f"min_sum {plan}: differs from plain")
        launches += 1
    for b, s, h, g, dd, dtype in FLASH_SHAPES:
        q = torch.randn((b, s, h, dd), generator=gen, device=dev).to(dtype)
        kv = [torch.randn((b, s, g, dd), generator=gen, device=dev).to(dtype)
              for _ in range(2)]
        out = fa.flash_attention_fwd_cuda(q, *kv)
        ref = fa.flash_attention_fwd_plain(q, *kv)
        tol = 2e-5 + (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5) * \
            ref.float().abs()
        if not bool(((out.float() - ref.float()).abs() <= tol).all()):
            raise AssertionError(f"flash row 8 {tuple(q.shape)}: differs")
        carry = fa.flash_attention_step_cuda(q, *kv, None, q_base=0,
                                             k_base=0)
        ref = fa.flash_attention_step_plain(q, *kv, None, q_base=0,
                                            k_base=0)
        if not all(torch.isfinite(c).all() for c in carry) or not \
                torch.allclose(fa.finalize(carry, torch.float32)[0],
                               fa.finalize(ref, torch.float32)[0],
                               rtol=2.0 ** -7, atol=2e-5):
            raise AssertionError(f"flash row 9 {tuple(q.shape)}: differs")
        launches += 2
    torch.cuda.synchronize()
    return launches


_SUMMARY = {"memcheck": re.compile(r"ERROR SUMMARY: (\d+) error"),
            "racecheck": re.compile(r"RACECHECK SUMMARY: (\d+) hazard"),
            "initcheck": re.compile(r"ERROR SUMMARY: (\d+) error"),
            "synccheck": re.compile(r"ERROR SUMMARY: (\d+) error")}


def sanitizer() -> str:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    default = "/usr/local/cuda/bin/compute-sanitizer"
    if os.path.exists(default):
        return default
    raise RuntimeError("compute-sanitizer not found: it comes with the CUDA "
                       "toolkit")


def run_tools(tools, timeout: float) -> list:
    """Build the kernels, then run this module's launches under each
    tool; [(tool, exit code, errors or hazards, seconds, the tail)]."""
    from repro_torch.kernels import build as B
    for lib in (B.cws_split_library, B.minmax_gram_library,
                B.flash_attention_library, B.flash_attention_wgmma_library):
        lib()
    out = []
    for tool in tools:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sanitizer(), "--tool", tool, sys.executable, "-m",
             "repro_torch.tools.sanitize_kernels"],
            capture_output=True, text=True, timeout=timeout)
        text = proc.stdout + proc.stderr
        m = _SUMMARY.get(tool, _SUMMARY["memcheck"]).search(text)
        said = [ln for ln in text.splitlines() if ln.startswith("=====")]
        out.append((tool, proc.returncode, int(m.group(1)) if m else None,
                    time.perf_counter() - t0, "\n".join(said[:40])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tools", default="",
                    help="comma-separated compute-sanitizer tools")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sanitize_kernels: no CUDA device")
    if not args.tools:
        print(f"sanitize_kernels: {launch_all(torch.device('cuda'))} "
              f"launches, all equal to their plain versions")
        return 0
    bad = 0
    for tool, rc, count, secs, tail in run_tools(
            [t for t in args.tools.split(",") if t], TOOL_TIMEOUT_S):
        print(f"{tool}: exit {rc}, {count} error(s) or hazard(s), "
              f"{secs:.1f} s\n{tail}")
        bad += rc != 0 or count != 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
