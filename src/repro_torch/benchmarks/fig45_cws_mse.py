"""Figures 4-5: bias and MSE of min-max estimation by full / 0-bit / 1-bit
CWS vs k, against the binomial reference K(1-K)/k (twin of
``benchmarks/fig45_cws_mse.py``).

Each pair is compacted to its union support (capped at 2,000 coordinates
by ``numpy.random.default_rng(0)``, as the reference), then hashed
``pair_reps`` times at k = 1024 through ``pipe.with_key(key).hashes(x)``
with the keys ``split(prng_key(0), pair_reps)``: one launch of the
regenerated-parameter raw hash kernel (``cws_hash_rng``) a rep, where the
reference maps the reps through ``jax.lax.map``.  The estimators are
numpy, as there."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import (Timer, as_json, check, emit,
                                           meta, save_json)
from repro_torch.benchmarks.fig6_tstar_only import rep_hashes
from repro_torch.core import minmax_pair
from repro_torch.data.synthetic import word_pair
from repro_torch.device import resolve_device

RECORDS = ("fig45_cws_mse",)
KS = (1, 4, 16, 64, 256, 1024)
PAIRS = ("HONG-KONG", "CREDIT-CARD", "SAN-FRANCISCO", "PIPELINE-FLUSH")
SUPPORT_CAP = 2000


def compacted_pair(pair: str, n_docs: int) -> np.ndarray:
    """The pair on its union support, capped at ``SUPPORT_CAP``
    coordinates: (2, D) float32.  Coordinates where both are zero never
    win the argmin and the parameters are iid per coordinate, so this is
    statistically exact."""
    u, v = word_pair(pair, n_docs=n_docs)
    support = np.flatnonzero((u > 0) | (v > 0))
    if len(support) > SUPPORT_CAP:
        support = np.random.default_rng(0).choice(support, SUPPORT_CAP,
                                                  replace=False)
    return np.stack([u[support], v[support]])


def pair_reps(reps: int, dim: int) -> int:
    """The reference's adaptive budget (MSE-of-MSE ~ sqrt(2/reps))."""
    return max(200, min(reps, int(reps * 1000 / max(dim, 1))))


def estimates(i_all: np.ndarray, t_all: np.ndarray, k_true: float) -> dict:
    """Bias and MSE of the three estimators at each k of ``KS``, from
    (reps, 2, kmax) hashes."""
    row = {}
    for k in KS:
        iu, iv = i_all[:, 0, :k], i_all[:, 1, :k]
        tu, tv = t_all[:, 0, :k], t_all[:, 1, :k]
        ests = {"full": ((iu == iv) & (tu == tv)).mean(axis=1),
                "0bit": (iu == iv).mean(axis=1),
                "1bit": ((iu == iv) & ((tu & 1) == (tv & 1))).mean(axis=1)}
        d = {f"bias_{s}": float(e.mean() - k_true) for s, e in ests.items()}
        d.update({f"mse_{s}": float(((e - k_true) ** 2).mean())
                  for s, e in ests.items()})
        d["theory"] = k_true * (1 - k_true) / k
        row[k] = d
    return row


def run(fast: bool = False, pairs=PAIRS, reps: int = 2000,
        n_docs: int = 2 ** 16, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    if fast:
        pairs = pairs[:2]
        reps = 300
        n_docs = 4096
    res = {}
    kmax = max(KS)
    for pair in pairs:
        x = torch.from_numpy(compacted_pair(pair, n_docs)).to(dev)
        k_true = float(minmax_pair(x[0], x[1]))
        n_reps = pair_reps(reps, x.shape[1])
        with Timer(dev) as t:
            i_all, t_all = (a.cpu().numpy()
                            for a in rep_hashes(x, 0, n_reps, kmax))
        row = {"K": k_true, "ks": estimates(i_all, t_all, k_true),
               "reps": n_reps, "D": int(x.shape[1])}
        res[pair] = row
        big = row["ks"][kmax]
        emit(f"fig45/{pair}", t.us,
             f"K={k_true:.4f} mse0bit@{kmax}={big['mse_0bit']:.2e} "
             f"theory={big['theory']:.2e} bias0bit={big['bias_0bit']:+.1e}")
    res.update(meta(dev, {"data": "numpy", "keys": "jax"}, fast))
    save_json(RECORDS[0], res, out)
    return {RECORDS[0]: res}


def claims(records: dict) -> dict:
    # (a) 0-bit MSE tracks theory within MC noise; (c) 0-bit bias small
    out = {}
    for pair, row in as_json(records[RECORDS[0]]).items():
        if not isinstance(row, dict) or "ks" not in row:
            continue
        for k in (64, 256, 1024):
            d = row["ks"][str(k)]
            out[f"{pair} k={k} mse_0bit < 3 theory + 1e-6"] = (
                d["mse_0bit"] < 3.0 * d["theory"] + 1e-6)
            out[f"{pair} k={k} |bias_0bit| < 0.03"] = (
                abs(d["bias_0bit"]) < 0.03)
    return out


def check_claims(records: dict) -> dict:
    return check("fig45", claims(records))
