"""Shared plumbing of the benchmark twins: CSV rows, JSON records, the
card's label, the paper claims and the comparison with the reference's
records (port of ``benchmarks/common.py``)."""
from __future__ import annotations

import json
import pathlib
import subprocess
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.regen import bernoulli, normal, split

HERE = pathlib.Path(__file__).resolve().parent
RESULTS = HERE / "results"       # the card's full-size records
REFERENCE = HERE / "reference"   # the reference's --fast records
# the reference's own records, which no twin overwrites
_REFERENCE_RESULTS = HERE.parents[2] / "benchmarks" / "results"
META = ("device", "draws", "fast")


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def save_json(name: str, obj, out=None) -> pathlib.Path:
    """Write ``obj`` as ``<out>/<name>.json`` (``out`` defaults to
    ``RESULTS``); never into the reference's ``benchmarks/results``."""
    out = pathlib.Path(out).resolve() if out is not None else RESULTS
    if out == _REFERENCE_RESULTS or _REFERENCE_RESULTS in out.parents:
        raise ValueError(f"{out} holds the reference's records; write the "
                         f"twins' records elsewhere")
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.json"
    path.write_text(json.dumps(obj, indent=1))
    return path


def load_reference(name: str) -> dict:
    return json.loads((REFERENCE / f"{name}.json").read_text())


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``torch.cuda.get_device_name`` where it cannot run), or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def meta(dev: torch.device, draws, fast: bool) -> dict:
    return {"device": device_label(dev), "draws": draws, "fast": bool(fast)}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Wall microseconds of a block, the device drained at both ends."""

    def __init__(self, dev: torch.device):
        self.dev, self.us = dev, 0.0

    def __enter__(self):
        sync(self.dev)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.dev)
        self.us = (time.perf_counter() - self._t0) * 1e6


def timed(dev: torch.device, fn, *args, repeats: int = 1, **kw):
    """(fn's last output, mean wall microseconds of ``repeats`` calls)
    after one untimed call, the device drained before and after the
    timed calls (``benchmarks/common.py:timed``)."""
    out = fn(*args, **kw)
    with Timer(dev) as t:
        for _ in range(repeats):
            out = fn(*args, **kw)
    return out, t.us / repeats


def rand_nonneg(key, shape, sparsity: float = 0.5,
                device=None) -> torch.Tensor:
    """exp(N(0, 1)) entries, each kept with probability 1 - sparsity, on
    the reference's draws (``bench_cws_kernel.py:rand_nonneg``): the same
    float32 rows from the same key."""
    k1, k2 = split(key)
    x = torch.exp(normal(k1, shape)) * bernoulli(k2, 1 - sparsity, shape)
    return x if device is None else x.to(device)


def f32_share(count: int, n: int) -> float:
    """count / n as the reference's float32 mean of 0/1 values gives it
    (``linear_accuracy``): a correctly rounded float32 quotient."""
    return float(np.float32(count) / np.float32(n))


def check(suite: str, claims: Dict[str, bool]) -> Dict[str, bool]:
    """Raise ``AssertionError`` naming every claim that failed."""
    failed = [name for name, ok in claims.items() if not ok]
    if failed:
        raise AssertionError(f"{suite}: paper claims failed: {failed}")
    return claims


def numeric_leaves(ref, got, path: Tuple[str, ...] = ()
                   ) -> Iterator[Tuple[Tuple[str, ...], float, float]]:
    """(path, reference value, twin value) for every number of ``ref``
    (the reference's keys only; the twins' extra entries are skipped).
    A key the twin lacks raises ``KeyError``."""
    if isinstance(ref, dict):
        for key, val in ref.items():
            yield from numeric_leaves(val, got[key], path + (key,))
    elif isinstance(ref, (int, float)) and not isinstance(ref, bool):
        yield path, float(ref), float(got)
    elif ref != got:
        raise ValueError(f"{'/'.join(path)}: {ref!r} != {got!r}")


def as_json(obj):
    """``obj`` as its JSON record reads back (integer keys as strings)."""
    return json.loads(json.dumps(obj))
