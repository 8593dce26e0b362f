"""Figure 6: keeping all of t* and only 0/1/2/4 bits of i* does not
estimate the min-max kernel (twin of ``benchmarks/fig6_tstar_only.py``).

Each Monte-Carlo rep is ``pipe.with_key(key).hashes(x)`` on a param-free
pipeline: one launch of the regenerated-parameter raw hash kernel
(``cws_hash_rng``) a rep, with the reference's keys
``split(prng_key(1), reps)``.  The codes are encoded on the hashes'
device and compared in numpy, as there."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import (Timer, check, emit, meta,
                                           save_json)
from repro_torch.core import minmax_pair
from repro_torch.core.hashing import encode_tstar_only
from repro_torch.core.regen import prng_key, split
from repro_torch.data.synthetic import word_pair
from repro_torch.device import resolve_device
from repro_torch.pipeline import FeaturePipeline, FeatureSpec

RECORDS = ("fig6_tstar_only",)
B_IS = (0, 1, 2, 4)


def rep_hashes(x: torch.Tensor, seed: int, reps: int, k: int):
    """(i*, t*) of ``reps`` Monte-Carlo reps, (reps, n, k) int32 on x's
    device: rep r hashes x with the key words
    ``split(prng_key(seed), reps)[r]``, one kernel launch a rep."""
    pipe = FeaturePipeline.create_regen(prng_key(seed), x.shape[1],
                                        FeatureSpec(num_hashes=k, b_i=1),
                                        device=x.device)
    i_all = torch.empty((reps, x.shape[0], k), dtype=torch.int32,
                        device=x.device)
    t_all = torch.empty_like(i_all)
    for r, key in enumerate(split(prng_key(seed), reps)):
        i_all[r], t_all[r] = pipe.with_key(key).hashes(x)
    return i_all, t_all


def run(fast: bool = False, pair: str = "CREDIT-CARD", reps: int = 500,
        k: int = 256, n_docs: int = 4096, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    if fast:
        reps = 100
    u, v = word_pair(pair, n_docs=n_docs)
    x = torch.from_numpy(np.stack([u, v])).to(dev)
    k_true = float(minmax_pair(x[0], x[1]))

    with Timer(dev) as t:
        i_all, t_all = rep_hashes(x, 1, reps, k)

    res = {"K": k_true, "bias_by_bi": {}}
    for b_i in B_IS:
        cu, cv = (encode_tstar_only(i_all[:, j], t_all[:, j],
                                    b_i=b_i).cpu().numpy() for j in (0, 1))
        est = (cu == cv).mean(axis=1)
        res["bias_by_bi"][b_i] = float(est.mean() - k_true)
    res.update(meta(dev, {"data": "numpy", "keys": "jax"}, fast), reps=reps)
    save_json(RECORDS[0], res, out)
    emit(f"fig6/{pair}", t.us,
         " ".join(f"bias(b_i={b})={v:+.3f}"
                  for b, v in res["bias_by_bi"].items()))
    return {RECORDS[0]: res}


def claims(records: dict) -> dict:
    bias = {int(b): v for b, v in records[RECORDS[0]]["bias_by_bi"].items()}
    # t*-only (b_i = 0) must be badly biased; adding i* bits must shrink it
    return {"|bias(b_i=0)| > 5 |bias(b_i=4)|":
            abs(bias[0]) > 5 * abs(bias[4])}


def check_claims(records: dict) -> dict:
    return check("fig6", claims(records))
