"""Table 2: resemblance (R) vs min-max (MM) for 13 word-frequency pairs
over 2^16 documents (twin of ``benchmarks/table2_wordpairs.py``).

The word pairs are numpy in both packages, the same bits; R and MM are
float32 sums on the run's device, rounded to four decimals."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (Timer, check, emit, meta,
                                           save_json)
from repro_torch.core import minmax_pair, resemblance_pair
from repro_torch.data.synthetic import WORD_PAIRS, word_pair
from repro_torch.device import resolve_device

RECORDS = ("table2_wordpairs",)


def run(fast: bool = False, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    rows = {}
    names = list(WORD_PAIRS)
    if fast:
        names = names[:4]
    for name in names:
        u, v = word_pair(name)
        with Timer(dev) as t:
            ut, vt = (torch.from_numpy(a).to(dev) for a in (u, v))
            r = float(resemblance_pair(ut, vt))
            mm = float(minmax_pair(ut, vt))
        f1, f2 = int((u > 0).sum()), int((v > 0).sum())
        rows[name] = {"f1": f1, "f2": f2, "R": round(r, 4),
                      "MM": round(mm, 4)}
        emit(f"table2/{name}", t.us, f"f1={f1} f2={f2} R={r:.4f} MM={mm:.4f}")
    rows.update(meta(dev, "numpy", fast))
    save_json(RECORDS[0], rows, out)
    return {RECORDS[0]: rows}


def claims(records: dict) -> dict:
    rows = [r for r in records[RECORDS[0]].values() if isinstance(r, dict)]
    # binarization inflates overlap on count data
    return {"MM <= R on every pair":
            bool(rows) and all(r["MM"] <= r["R"] + 1e-6 for r in rows)}


def check_claims(records: dict) -> dict:
    return check("table2", claims(records))
