"""Bit-packed feature encoding: accuracy, model bytes and bandwidth over
b (twin of ``benchmarks/bench_packed_features.py``).

The packed emit shrinks feature traffic from 4 bytes a hash to b/8 bytes
(b = b_i in {1, 2, 4, 8}).  On the paper's training recipe (streamed
minibatch SGD over the fused pipeline) this records, against the int32
baseline at b = 8 (TPU row 2, ``cws_encode``):

  * test accuracy per b, packed (TPU row 4, ``cws_encode_packed``);
  * the truncated k * 2^b table's bytes;
  * feature bytes, modelled (exact counts) and measured (wall time of a
    featurization pass over the test split).

On the reference's own draws: ``template-hard`` seed 1,
stored parameters ``make_cws_params_jax(prng_key(0), D, 128)`` for every
pipeline, zero tables, ``TrainCfg(lr=0.05, l2=1e-5)`` at batch 256 for 60
(``--fast``) or 250 steps, shuffled from ``prng_key(7)``.  Gates, checked
after the record is saved (``claims``): >= 8x modelled reduction at b = 4,
<= 0.5 pp gap at b = 8, and beyond the reference, packed and unpacked
training at b = 8 bit-identical (their tables equal).  At ``--fast`` the
accuracies are also held to the reference's record: 1.0 pp a cell, 0.5 pp
mean (fig78's limits: the trainer follows the reference's source, not
XLA's rewrites of it, so a test row may flip).
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (check, emit, load_reference,
                                           meta, save_json, timed)
from repro_torch.benchmarks.fig78_linear_svm import dataset
from repro_torch.core import CWSParams, make_cws_params_jax
from repro_torch.core.linear_model import TrainCfg, init_bag, init_bag_packed
from repro_torch.core.regen import prng_key
from repro_torch.device import resolve_device
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.training import fit_linear_streamed, streamed_accuracy

RECORDS = ("BENCH_packed_features",)
BS = (1, 2, 4, 8)
K = 128          # k % (32 / b) == 0 for every b: the modelled ratio is 32 / b
BATCH = 256
FEATURIZE_REPEATS = 2
CELL_PP, MEAN_PP = 1.0, 0.5     # against the reference's --fast record


def steps_for(fast: bool) -> int:
    return 60 if fast else 250


def params_for(dim: int, dev: torch.device) -> CWSParams:
    """The stored parameters every pipeline of the sweep shares."""
    p = make_cws_params_jax(prng_key(0), dim, K)
    return CWSParams(*(m.to(dev) for m in (p.r, p.log_c, p.beta)))


def _fit_eval(pipe, table, xtr, ytr, xte, yte, *, n_classes, steps):
    cfg = TrainCfg(n_classes=n_classes, steps=steps, lr=0.05, l2=1e-5,
                   batch_size=BATCH)
    p = fit_linear_streamed(table, pipe, xtr, ytr, cfg=cfg,
                            shuffle_key=prng_key(7))
    return streamed_accuracy(p, pipe, xte, yte), p


def _nbytes(p) -> int:
    return sum(t.numel() * t.element_size() for t in (p.w, p.b))


def run(fast: bool = False, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    ds = dataset()
    xtr, xte, ytr, yte = (torch.from_numpy(a).to(dev) for a in (
        ds.x_train, ds.x_test, ds.y_train, ds.y_test))
    n_classes, steps = ds.n_classes, steps_for(fast)
    n_te, dim = int(xte.shape[0]), int(xtr.shape[1])
    params = params_for(dim, dev)

    # the int32 baseline: the unpacked pipeline at the widest swept b
    b_base = max(BS)
    base_pipe = FeaturePipeline(params, FeatureSpec(K, b_i=b_base))
    base_acc, base_p = _fit_eval(
        base_pipe, init_bag(base_pipe.num_features, n_classes, device=dev),
        xtr, ytr, xte, yte, n_classes=n_classes, steps=steps)
    _, base_us = timed(dev, lambda: base_pipe.features(xte),
                       repeats=FEATURIZE_REPEATS)
    base_bytes = n_te * K * 4            # (n, k) int32
    emit("packed/baseline-int32", base_us,
         f"b={b_base} acc={base_acc*100:.1f} feat_bytes={base_bytes}")

    rec = {"k": K, "n_test": n_te, "steps": steps,
           "baseline": {"b": b_base, "accuracy": base_acc,
                        "feature_bytes": base_bytes,
                        "model_bytes": _nbytes(base_p),
                        "featurize_us": base_us},
           "per_b": {}}
    for b in BS:
        spec = FeatureSpec(K, b_i=b, packed=True)
        pipe = FeaturePipeline(params, spec)
        acc, p = _fit_eval(pipe, init_bag_packed(K, b, n_classes, device=dev),
                           xtr, ytr, xte, yte, n_classes=n_classes,
                           steps=steps)
        _, us = timed(dev, lambda: pipe.features(xte),
                      repeats=FEATURIZE_REPEATS)
        feat_bytes = n_te * spec.packed_words * 4      # (n, words) uint32
        ratio = base_bytes / feat_bytes                # modelled: 32 / b
        rec["per_b"][str(b)] = {
            "accuracy": acc,
            "accuracy_gap_pp": (base_acc - acc) * 100,
            "feature_bytes": feat_bytes,
            "modeled_bandwidth_reduction": ratio,
            "model_bytes": _nbytes(p),
            "featurize_us": us,
        }
        if b == b_base:
            rec["packed_b8_bit_identical"] = bool(
                torch.equal(p.w, base_p.w) and torch.equal(p.b, base_p.b))
        emit(f"packed/b{b}", us,
             f"acc={acc*100:.1f} bytes={feat_bytes} ratio={ratio:.1f}x")
    rec.update(meta(dev, "jax", fast))
    save_json(RECORDS[0], rec, out)
    return {RECORDS[0]: rec}


def reference_cells(records: dict):
    """(cell, reference accuracy, twin accuracy) in percent for the
    baseline and every b, against the reference's --fast record."""
    rec, ref = records[RECORDS[0]], load_reference(RECORDS[0])
    cells = [("baseline", ref["baseline"]["accuracy"],
              rec["baseline"]["accuracy"])]
    cells += [(f"b={b}", ref["per_b"][b]["accuracy"],
               rec["per_b"][b]["accuracy"]) for b in ref["per_b"]]
    return [(c, 100 * a, 100 * g) for c, a, g in cells]


_EXACT = ("feature_bytes", "model_bytes", "modeled_bandwidth_reduction")


def claims(records: dict) -> dict:
    """The reference's two gates, b = 8 packed bit-identical to unpacked,
    and at ``--fast`` the record against the reference's: accuracies
    within ``CELL_PP`` a cell and ``MEAN_PP`` mean, byte counts and
    ratios equal."""
    rec = records[RECORDS[0]]
    out = {
        ">= 8x modelled bandwidth reduction at b = 4":
            rec["per_b"]["4"]["modeled_bandwidth_reduction"] >= 8.0,
        "packed b = 8 within 0.5 pp of the unpacked baseline":
            rec["per_b"]["8"]["accuracy_gap_pp"] <= 0.5,
        "packed b = 8 training bit-identical to unpacked":
            bool(rec["packed_b8_bit_identical"]),
    }
    if rec["fast"]:
        ref = load_reference(RECORDS[0])
        diffs = [abs(a - g) for _, a, g in reference_cells(records)]
        out[f"accuracies within {CELL_PP} pp a cell of the reference's"] = (
            max(diffs) <= CELL_PP)
        out[f"accuracies within {MEAN_PP} pp mean of the reference's"] = (
            sum(diffs) / len(diffs) <= MEAN_PP)
        out["byte counts and ratios equal the reference's"] = (
            rec["baseline"]["feature_bytes"] == ref["baseline"][
                "feature_bytes"]
            and rec["baseline"]["model_bytes"] == ref["baseline"][
                "model_bytes"]
            and all(rec["per_b"][b][f] == ref["per_b"][b][f]
                    for b in ref["per_b"] for f in _EXACT))
    return out


def check_claims(records: dict) -> dict:
    return check("packed_features", claims(records))


def launches(records: dict) -> dict:
    """The kernel launches ``run`` makes, by kernel: per pipeline one a
    step, one for the evaluation (the test split is one chunk) and one a
    featurization pass timed (one untimed first)."""
    rec = records[RECORDS[0]]
    per_pipe = rec["steps"] + 1 + (1 + FEATURIZE_REPEATS)
    return {"cws_encode": per_pipe, "cws_encode_packed": len(BS) * per_pipe}
