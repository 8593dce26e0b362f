#!/usr/bin/env python3
"""Measure the SIMT issue rates the min-sum Gram kernel lives on.

    python3 tools/fmnmx_rate.py

Row 7 (``csrc/minmax_gram.cu``) spends an FMNMX (``fminf``) and an FADD
(``__fadd_rn``) on every (m, n, d) triple, and its bound counts both at one
instruction a lane a cycle.  This script builds a small CUDA source under
``build/rates/`` (git-ignored) and times, on every SM at once, 16
independent chains a thread of:

  * ``min``: two FMNMX an iteration (t = max(min(t, p), q));
  * ``add``: one FADD an iteration (a = a + p);
  * ``min+add``: the kernel's own pair, a = a + min(a, p) (no chain
    settles, so no iteration can be folded away);

at 2, 4 and 8 warps an SM sub-partition (256, 512 and 1,024 threads a
block, one block an SM).  It prints each rate as instructions a cycle of an
SM (the card's maximum SM clock from ``nvidia-smi``): 128 is one a lane a
cycle, so a pipe at half that rate shows as 64.  Then the card's name and
power limit, then a JSON summary.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402

SOURCE = r'''
#include <cuda_runtime.h>

template <int MODE>
__global__ void chains(float* out, int iters, float p, float q) {
  float t[16], a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    t[i] = threadIdx.x * 1e-3f + i;
    a[i] = t[i];
  }
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (MODE == 0) {
        t[i] = fmaxf(fminf(t[i], p), q);
      } else if (MODE == 1) {
        a[i] = __fadd_rn(a[i], p);
      } else {
        a[i] = __fadd_rn(a[i], fminf(a[i], p));
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += t[i] + a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int chains_launch(int mode, int blocks, int threads, int iters,
                             float* out, cudaStream_t stream) {
  if (mode == 0) chains<0><<<blocks, threads, 0, stream>>>(out, iters, 1e30f, -1e30f);
  if (mode == 1) chains<1><<<blocks, threads, 0, stream>>>(out, iters, 1e-30f, 0.0f);
  if (mode == 2) chains<2><<<blocks, threads, 0, stream>>>(out, iters, -1e-30f, 0.0f);
  return cudaGetLastError();
}
'''
# mode: (its index in the source, instructions an iteration of a thread)
MODES = {"min": (0, 32), "add": (1, 16), "min+add": (2, 32)}
ITERS = 4096


def main():
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    work = ROOT / "build" / "rates"
    work.mkdir(parents=True, exist_ok=True)
    (work / "chains.cu").write_text(SOURCE)
    proc = subprocess.run([B.nvcc_path(), *B.EXACT_FLAGS, "-o",
                           str(work / "chains.so"), str(work / "chains.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(work / "chains.so"))
    lib.chains_launch.argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,
                                                        ctypes.c_void_p)
    lib.chains_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(C.nvidia_smi("clocks.max.sm", units=False))
    rows = []
    for threads in (256, 512, 1024):
        out = torch.empty(sms * threads, device="cuda")
        for name, (mode, per_iter) in MODES.items():
            def run():
                rc = lib.chains_launch(mode, sms, threads, ITERS,
                                       out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
            ms = C.time_ms(run, reps=10)
            warp_insns = threads // 32 * ITERS * per_iter
            rate = warp_insns * 32 / (ms * 1e-3 * mhz * 1e6)
            rows.append({"threads": threads, "mode": name, "ms": ms,
                         "insns_per_sm_cycle": rate})
            print(f"{name:8s} {threads // 128} warps an SM sub-partition: "
                  f"{ms:.4f} ms, {rate:.1f} instructions a cycle of an SM "
                  f"(at {mhz:.0f} MHz)")
    print(C.nvidia_smi())
    print(json.dumps({"sm_mhz": mhz, "sms": sms, "rates": rows}))


if __name__ == "__main__":
    main()
