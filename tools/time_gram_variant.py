#!/usr/bin/env python3
"""Time a variant source of the min-sum Gram kernel beside the repo's.

    git show REV:src/repro_torch/csrc/minmax_gram.cu \\
        > build/variants/minmax_gram_variant.cu
    python3 tools/time_gram_variant.py build/variants/minmax_gram_variant.cu

The variant is a CUDA source with the single-pass launcher
``min_sum_launch(x, y, m, n, d, out, stream)`` (x (m, d), y (n, d) and out
(m, n) dense fp32).  It is built with the repo's flags
(``kernels.build.EXACT_FLAGS``) under ``build/variants/`` (git-ignored),
checked against ``min_sum_plain`` within the bound ``chip_smoke.py`` holds
the kernel to, then timed with CUDA events in turns with the repo's kernel
(repo, variant, variant, repo) at row 7's timing shapes (``chip_smoke.
GRAM_TIMING``: the kernel machine's train and test Grams, the estimator's
(1, 1, D), (12,000, 12,000, 784)).  Prints one line a shape, then the card's
name and power limit, then a JSON summary.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.data.synthetic import CLASSIFICATION_SUITES  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import minmax_gram as G  # noqa: E402


def build_variant(source: pathlib.Path):
    out = ROOT / "build" / "variants" / (source.stem + ".so")
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([B.nvcc_path(), *B.EXACT_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.min_sum_launch.argtypes = (p, p, i, i, i, p, p)
    lib.min_sum_launch.restype = ctypes.c_int
    return lib


def variant_call(lib, x, y):
    (m, d), n = x.shape, y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = lib.min_sum_launch(x.data_ptr(), y.data_ptr(), m, n, d,
                            out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: cudaError {rc}")
    return out


def inputs(shape, dev):
    suite = CLASSIFICATION_SUITES["template"]()
    train = torch.from_numpy(suite.x_train).to(dev)
    if shape == "estimator":
        est = torch.from_numpy(C.compacted_pair("CREDIT-CARD", C.N_DOCS))
        return est[:1].to(dev), est[1:].to(dev)
    if shape == (train.shape[0], *train.shape):
        return train, train
    if shape == (suite.x_test.shape[0], *train.shape):
        return torch.from_numpy(suite.x_test).to(dev), train
    x = torch.from_numpy(C.gram_rows(np.random.default_rng(7), shape[0],
                                     shape[2])).to(dev)
    return x, x


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    dev = torch.device("cuda")
    lib = build_variant(pathlib.Path(argv[1]).resolve())
    rows = []
    for shape in C.GRAM_TIMING:
        x, y = inputs(shape, dev)
        (m, d), n = x.shape, y.shape[0]
        want = G.min_sum_plain(x, y).double()
        for name, fn in (("repo", G.min_sum_cuda),
                         ("variant", lambda a, b: variant_call(lib, a, b))):
            err = (fn(x, y).double() - want).abs()
            ratio = float((err / (2 * d * C.U32 * want + 1e-30)).max())
            if ratio > 1:
                raise AssertionError(f"{name} at ({m}, {n}, {d}): "
                                     f"{ratio:.3g} of the bound")
        run = {"repo": lambda: G.min_sum_cuda(x, y),
               "variant": lambda: variant_call(lib, x, y)}
        reps = 5 if m * n > 10 ** 7 else 50
        readings = {"repo": [], "variant": []}
        for name in ("repo", "variant", "variant", "repo"):
            readings[name].append(C.time_ms(run[name], reps=reps))
        ms = {k: sum(v) / len(v) for k, v in readings.items()}
        rows.append({"shape": [m, n, d], "ms": ms, "readings": readings})
        print(f"min_sum ({m}, {n}, {d}): repo {ms['repo']:.4f} ms, variant "
              f"{ms['variant']:.4f} ms, variant / repo "
              f"{ms['variant'] / ms['repo']:.2f} (in turns: {readings})")
    print(C.nvidia_smi())
    print(json.dumps({"variant": argv[1], "times": rows}))


if __name__ == "__main__":
    main(sys.argv)
