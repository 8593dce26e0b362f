"""Table 1: kernel-SVM test accuracy for linear / min-max / n-min-max /
intersection kernels, best over the paper's C grid (twin of
``benchmarks/table1_kernel_svm.py``).

The claim under test is the ordering min-max >= linear on nonnegative data
with heavy-tailed, relational class structure.  Every suite is the
reference's own draws (``hist-mix`` through ``regen``'s Dirichlet and
Gamma samplers), and the record's ``draws`` says so.  The min-sum Grams
(min-max, n-min-max, intersection) go through the min-sum kernel on the
card; dual coordinate descent solves the C grid."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (Timer, check, emit, meta,
                                           save_json)
from repro_torch.core import GRAM_FNS
from repro_torch.core.kernel_svm import best_accuracy_over_C
from repro_torch.data.synthetic import CLASSIFICATION_SUITES
from repro_torch.device import resolve_device

RECORDS = ("table1_kernel_svm",)
KERNELS = ("linear", "min-max", "n-min-max", "intersection")
SUITES = ("template", "template-hard", "ratio-xor", "hist-mix")
C_GRID = (0.01, 0.1, 1.0, 10.0, 100.0, 1000.0)
SWEEPS = 20


def kernel_accuracies(x_train, y_train, x_test, y_test, n_classes: int,
                      dev: torch.device) -> dict:
    """One suite's row: the best test accuracy over ``C_GRID`` (percent,
    one decimal) of the kernel machine on each kernel's Grams."""
    xtr, xte, ytr, yte = (torch.as_tensor(a).to(dev)
                          for a in (x_train, x_test, y_train, y_test))
    row = {}
    for k in KERNELS:
        ktr = GRAM_FNS[k](xtr, xtr)
        kte = GRAM_FNS[k](xte, xtr)
        acc, _ = best_accuracy_over_C(ktr, kte, ytr, yte,
                                      n_classes=n_classes, sweeps=SWEEPS,
                                      Cs=C_GRID)
        row[k] = round(acc * 100, 1)
    return row


def run(fast: bool = False, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    rows = {}
    suites = SUITES[:2] if fast else SUITES
    for name in suites:
        ds = CLASSIFICATION_SUITES[name]()
        with Timer(dev) as t:
            row = kernel_accuracies(ds.x_train, ds.y_train, ds.x_test,
                                    ds.y_test, ds.n_classes, dev)
        rows[name] = row
        emit(f"table1/{name}", t.us,
             " ".join(f"{k}={v}" for k, v in row.items()))
    rows.update(meta(dev, dict.fromkeys(suites, "jax"), fast))
    save_json(RECORDS[0], rows, out)
    return {RECORDS[0]: rows}


def claims(records: dict) -> dict:
    rows = {s: r for s, r in records[RECORDS[0]].items() if s in SUITES}
    # the paper's headline ordering must hold on the suites built for it
    return {"min-max >= linear on every suite":
            bool(rows) and all(r["min-max"] >= r["linear"]
                               for r in rows.values())}


def check_claims(records: dict) -> dict:
    return check("table1", claims(records))
