"""End to end: the paper's full pipeline as one command (port of
``examples/cws_classification.py``):

  synthetic nonnegative dataset
    -> exact kernel machines (linear vs min-max) for the reference accuracy
    -> 0-bit CWS hashing (k hashes, b_i-bit buckets)
    -> embedding-bag LINEAR classifier on hashed features
    -> accuracy as a function of k: approaches the min-max kernel machine.

On the reference's own draws: the dataset (``make_template_classification``
on its ``jax.random`` stream) and the CWS matrices
(``make_cws_params_jax(prng_key(0), D, kmax)``, the reference's
``FeaturePipeline.create(PRNGKey(0), ...)``).  On the card the exact
min-max Gram launches the min-sum kernel (``csrc/minmax_gram.cu``) and
every streamed step the stored CWS encode kernel (``csrc/cws_split.cu``).

    PYTHONPATH=src python -m repro_torch.examples.cws_classification
        [--fast] [--b-i 8] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import GRAM_FNS, CWSParams, make_cws_params_jax
from repro_torch.core.kernel_svm import best_accuracy_over_C
from repro_torch.core.linear_model import (TrainCfg, fit_linear, init_bag,
                                           linear_accuracy)
from repro_torch.core.regen import prng_key
from repro_torch.data.synthetic import make_template_classification
from repro_torch.device import resolve_device
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.training import fit_linear_streamed, streamed_accuracy

KS, FAST_KS = (32, 128, 512, 1024), (32, 128)
STEPS, FULL_STEPS, BATCH = 400, 1000, 256


def dataset(**kw):
    """The example's dataset; ``kw`` (``n_train``, ``n_test``) cuts it."""
    return make_template_classification(
        1, n_classes=10, density=0.15, mult_noise=1.2, spike_prob=0.08, **kw)


def cws_params(dim: int, kmax: int, device) -> CWSParams:
    """One hash set of ``kmax`` hashes; every k takes its prefix."""
    p = make_cws_params_jax(prng_key(0), dim, kmax)
    return CWSParams(*(m.to(device) for m in (p.r, p.log_c, p.beta)))


def run(ds, ks=KS, b_i: int = 8, device=None, *, steps: int = STEPS,
        full_steps: int = FULL_STEPS, log=print) -> dict:
    """The example on ``ds``: the exact machines, the streamed fit at each
    k of ``ks``, the full-batch fit at the largest.  Returns the
    accuracies (shares of the test rows) and each streamed k's seconds."""
    dev = resolve_device(device)
    xtr, xte, ytr, yte = (torch.from_numpy(a).to(dev) for a in (
        ds.x_train, ds.x_test, ds.y_train, ds.y_test))
    log(f"dataset: {xtr.shape[0]} train / {xte.shape[0]} test, "
        f"D={xtr.shape[1]}, {ds.n_classes} classes")
    out = {"exact": {}, "streamed": {}, "seconds": {}}

    # exact kernel machines (the paper's Table-1 comparison)
    for kern in ("linear", "min-max"):
        acc, _ = best_accuracy_over_C(
            GRAM_FNS[kern](xtr, xtr), GRAM_FNS[kern](xte, xtr), ytr, yte,
            n_classes=ds.n_classes, sweeps=20)
        out["exact"][kern] = acc
        log(f"exact {kern:8s} kernel SVM: {acc * 100:.1f}%")

    # 0-bit CWS -> linear classifier, streamed: each batch hashed by one
    # encode launch inside the loop, the (n, k) index matrix never whole
    kmax = max(ks)
    params = cws_params(xtr.shape[1], kmax, dev)
    for k in ks:
        # the k-prefix of one hash set
        pipe = FeaturePipeline(params, FeatureSpec(num_hashes=k, b_i=b_i))
        cfg = TrainCfg(n_classes=ds.n_classes, steps=steps, lr=0.05,
                       l2=1e-5, batch_size=min(BATCH, xtr.shape[0]))
        p0 = init_bag(pipe.num_features, ds.n_classes, device=dev)
        t0 = time.perf_counter()
        p = fit_linear_streamed(p0, pipe, xtr, ytr, cfg=cfg)
        acc = streamed_accuracy(p, pipe, xte, yte)
        out["seconds"][k] = time.perf_counter() - t0
        out["streamed"][k] = acc
        log(f"0-bit CWS + streamed linear (k={k:5d}, b_i={b_i}): "
            f"{acc * 100:.1f}%  [{out['seconds'][k]:.1f}s]")

    # full-batch reference at the largest k: the streamed learner must
    # land on the same accuracy
    pipe = FeaturePipeline(params, FeatureSpec(kmax, b_i=b_i))
    feat_tr, feat_te = pipe.features(xtr), pipe.features(xte)
    cfg = TrainCfg(n_classes=ds.n_classes, steps=full_steps, lr=0.05,
                   l2=1e-5)
    p0 = init_bag(pipe.num_features, ds.n_classes, device=dev)
    p = fit_linear(p0, feat_tr, ytr, cfg=cfg, kind="bag")
    out["full_batch"] = linear_accuracy(p, feat_te, yte, kind="bag")
    log(f"full-batch reference      (k={kmax:5d}, b_i={b_i}): "
        f"{out['full_batch'] * 100:.1f}%")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.cws_classification")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--b-i", type=int, default=8)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(dataset(), FAST_KS if args.fast else KS, args.b_i,
               args.device)


if __name__ == "__main__":
    main()
