"""Figures 7-8: a linear classifier on 0-bit CWS features (twin of
``benchmarks/fig78_linear_svm.py``).

Fig 7: accuracy vs k (32 ... 1024) and b_i (1/2/4/8), approaching the
exact min-max kernel machine from below, above the linear kernel's.
Fig 8: b_t = 2 vs b_t = 0.  Then the streamed-versus-full-batch record
``BENCH_linear_stream``: the streamed minibatch trainer must match full
batch within 0.5 pp.

On the reference's own data (``template-hard``) and
stored CWS parameters (``make_cws_params_jax(prng_key(0), 256, kmax)``):
one raw hash pass (``cws_hash``, stored) of the train and test rows,
whose (i*, t*) every (k, b_i, b_t) cell encodes; each cell fits
``fit_linear`` (bag, 250 steps) at three l2.  The streamed record
featurizes each batch inside ``fit_linear_streamed`` (the stored encode
kernel, ``cws_encode``).

``mesh=True`` (the reference's ``--mesh``) adds the data-parallel run:
the same streamed fit over the process group's ``data`` axis
(``make_local_mesh``; one rank without a process group), the batch cut
down to a multiple of the axis, held against the unsharded streamed run
at that batch (``gap_sharded_pp``, within 0.5 pp).  Every rank of the
group calls ``run``; rank 0 saves the records."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (Timer, check, emit, f32_share,
                                           meta, save_json)
from repro_torch.core import GRAM_FNS, CWSParams, make_cws_params_jax
from repro_torch.core.kernel_svm import best_accuracy_over_C
from repro_torch.core.linear_model import (TrainCfg, fit_linear, init_bag,
                                           linear_accuracy)
from repro_torch.core.regen import prng_key
from repro_torch.data.synthetic import make_template_classification
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import data_axis_size, make_local_mesh
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.training import fit_linear_streamed, streamed_accuracy

RECORDS = ("fig78_linear_svm", "BENCH_linear_stream")
KS = (32, 128, 512, 1024)
BIS = (1, 2, 4, 8)
L2S = (1e-6, 1e-5, 1e-4)
CELL_STEPS = 250
STREAM_K, STREAM_BATCH, STREAM_STEPS, FULL_STEPS = 128, 600, 500, 1000


def dataset():
    return make_template_classification(
        1, n_classes=10, density=0.15, mult_noise=1.2, spike_prob=0.08,
        name="template-hard")


def hashed_accuracy(params, hashes_tr, hashes_te, y_tr, y_te, *, k: int,
                    b_i: int, b_t: int, n_classes: int) -> float:
    """One cell: the first k hashes of the (i*, t*) passes encoded at
    (b_i, b_t), ``fit_linear`` (bag) at each of ``L2S``; the best test
    accuracy, as the reference's float32 mean."""
    spec = FeatureSpec(params.num_hashes, b_i=b_i, b_t=b_t)
    pipe = FeaturePipeline(params, spec)
    (i_tr, t_tr), (i_te, t_te) = hashes_tr, hashes_te
    f_tr = pipe.features_from_hashes(i_tr[:, :k], t_tr[:, :k])
    f_te = pipe.features_from_hashes(i_te[:, :k], t_te[:, :k])
    best = 0.0
    for l2 in L2S:
        cfg = TrainCfg(n_classes=n_classes, steps=CELL_STEPS, lr=0.05,
                       l2=float(l2))
        p0 = init_bag(k * spec.width, n_classes, device=f_tr.device)
        p = fit_linear(p0, f_tr, y_tr, cfg=cfg, kind="bag")
        acc = linear_accuracy(p, f_te, y_te, kind="bag")
        best = max(best, f32_share(round(acc * len(y_te)), len(y_te)))
    return best


def exact_accuracy(kernel: str, xtr, xte, ytr, yte, n_classes: int) -> float:
    """The exact kernel machine's best accuracy over the C grid."""
    acc, _ = best_accuracy_over_C(GRAM_FNS[kernel](xtr, xtr),
                                  GRAM_FNS[kernel](xte, xtr), ytr, yte,
                                  n_classes=n_classes, sweeps=20)
    return acc


def stream_record(params, xtr, ytr, xte, yte, *, k: int, b_i: int,
                  n_classes: int, mesh=None) -> dict:
    """Streamed minibatch training (featurization inside the loop) against
    full batch on materialized features, both to convergence; with
    ``mesh`` also the data-parallel fit (``sharded_record``)."""
    dev = xtr.device
    pipe = FeaturePipeline(params, FeatureSpec(num_hashes=k, b_i=b_i))
    cfg_fb = TrainCfg(n_classes=n_classes, steps=FULL_STEPS, lr=0.05,
                      l2=1e-5)
    cfg_st = TrainCfg(n_classes=n_classes, steps=STREAM_STEPS, lr=0.05,
                      l2=1e-5, batch_size=min(STREAM_BATCH, xtr.shape[0]))
    p0 = init_bag(pipe.num_features, n_classes, device=dev)
    with Timer(dev) as t_fb:
        f_tr, f_te = pipe.features(xtr), pipe.features(xte)
        p_fb = fit_linear(p0, f_tr, ytr, cfg=cfg_fb, kind="bag")
        acc_fb = linear_accuracy(p_fb, f_te, yte, kind="bag")
    acc_fb = f32_share(round(acc_fb * len(yte)), len(yte))
    with Timer(dev) as t_st:
        p_st = fit_linear_streamed(p0, pipe, xtr, ytr, cfg=cfg_st)
        acc_st = streamed_accuracy(p_st, pipe, xte, yte)
    gap_pp = abs(acc_st - acc_fb) * 100
    emit(f"fig78/streamed/k={k}/b_i={b_i}", t_st.us,
         f"acc_streamed={acc_st*100:.1f} acc_fullbatch={acc_fb*100:.1f} "
         f"gap_pp={gap_pp:.2f}")
    bench = {"k": k, "b_i": b_i, "batch_size": cfg_st.batch_size,
             "steps": cfg_st.steps, "n_train": int(xtr.shape[0]),
             "acc_fullbatch": round(acc_fb * 100, 2),
             "acc_streamed": round(acc_st * 100, 2),
             "gap_pp": round(gap_pp, 3),
             "us_fullbatch": round(t_fb.us), "us_streamed": round(t_st.us)}
    if mesh is not None:
        bench.update(sharded_record(mesh, pipe, p0, p_st, cfg_st, xtr, ytr,
                                    xte, yte, k=k, b_i=b_i))
    return bench


def sharded_record(mesh, pipe, p0, p_st, cfg_st, xtr, ytr, xte, yte, *,
                   k: int, b_i: int) -> dict:
    """The streamed fit over ``mesh``'s ``data`` axis against the
    unsharded streamed fit at the same batch (the axis's multiple)."""
    ndev = data_axis_size(mesh)
    bs_m = cfg_st.batch_size - (cfg_st.batch_size % ndev)
    cfg_m = TrainCfg(n_classes=cfg_st.n_classes, steps=cfg_st.steps,
                     lr=cfg_st.lr, l2=cfg_st.l2, batch_size=bs_m)
    p_u = (p_st if bs_m == cfg_st.batch_size else
           fit_linear_streamed(p0, pipe, xtr, ytr, cfg=cfg_m))
    acc_u = streamed_accuracy(p_u, pipe, xte, yte)
    with Timer(xtr.device) as t_m:
        p_m = fit_linear_streamed(p0, pipe, xtr, ytr, cfg=cfg_m, mesh=mesh)
        acc_m = streamed_accuracy(p_m, pipe, xte, yte, mesh=mesh)
    gap_m = abs(acc_m - acc_u) * 100
    emit(f"fig78/sharded/ndev={ndev}/k={k}/b_i={b_i}", t_m.us,
         f"acc_sharded={acc_m*100:.1f} acc_streamed={acc_u*100:.1f} "
         f"gap_sharded_pp={gap_m:.2f}")
    return {"ndev": ndev, "batch_size_sharded": bs_m,
            "acc_sharded": round(acc_m * 100, 2),
            "gap_sharded_pp": round(gap_m, 3), "us_sharded": round(t_m.us)}


def run(fast: bool = False, mesh: bool = False, *, device=None,
        out=None) -> dict:
    dev = resolve_device(device)
    mesh = make_local_mesh() if mesh else None
    saving = mesh is None or mesh.rank == 0
    ds = dataset()
    xtr, xte, ytr, yte = (torch.from_numpy(a).to(dev) for a in (
        ds.x_train, ds.x_test, ds.y_train, ds.y_test))
    n_classes = ds.n_classes
    ks = KS[:2] if fast else KS
    bis = (2, 8) if fast else BIS

    # reference curves: exact kernel machines
    with Timer(dev) as t:
        acc_mm = exact_accuracy("min-max", xtr, xte, ytr, yte, n_classes)
        acc_lin = exact_accuracy("linear", xtr, xte, ytr, yte, n_classes)
    emit("fig78/reference", t.us,
         f"minmax={acc_mm*100:.1f} linear={acc_lin*100:.1f}")

    # one hash pass for the whole (k, b_i, b_t) sweep
    kmax = max(ks)
    p = make_cws_params_jax(prng_key(0), xtr.shape[1], kmax)
    params = CWSParams(*(m.to(dev) for m in (p.r, p.log_c, p.beta)))
    pipe0 = FeaturePipeline(params, FeatureSpec(kmax, b_i=1))
    h_tr, h_te = pipe0.hashes(xtr), pipe0.hashes(xte)

    def cell(k, b_i, b_t):
        return hashed_accuracy(params, h_tr, h_te, ytr, yte, k=k, b_i=b_i,
                               b_t=b_t, n_classes=n_classes)

    fig7 = {"minmax_ref": acc_mm * 100, "linear_ref": acc_lin * 100,
            "grid": {}}
    for b_i in bis:
        for k in ks:
            with Timer(dev) as t:
                acc = cell(k, b_i, 0)
            fig7["grid"][f"b{b_i}_k{k}"] = round(acc * 100, 1)
            emit(f"fig7/b_i={b_i}/k={k}", t.us, f"acc={acc*100:.1f}")

    # Fig 8: b_t = 2 vs 0 at k = 512 (128 in fast mode)
    fig8 = {}
    k8 = 128 if fast else 512
    for b_i in bis:
        a0 = fig7["grid"].get(f"b{b_i}_k{k8}") or cell(k8, b_i, 0) * 100
        with Timer(dev) as t:
            a2 = cell(k8, b_i, 2) * 100
        fig8[f"b{b_i}"] = {"bt0": round(float(a0), 1),
                           "bt2": round(float(a2), 1)}
        emit(f"fig8/b_i={b_i}/k={k8}", t.us, f"bt0={a0:.1f} bt2={a2:.1f}")

    draws = {"data": "jax", "cws_params": "jax"}
    fig78 = {"fig7": fig7, "fig8": fig8, **meta(dev, draws, fast)}
    if saving:
        save_json(RECORDS[0], fig78, out)

    # streamed vs full batch at a fixed (k, b_i): the trainer's gap
    bench = stream_record(params, xtr, ytr, xte, yte,
                          k=min(STREAM_K, kmax), b_i=max(bis),
                          n_classes=n_classes, mesh=mesh)
    bench.update(meta(dev, draws, fast))
    if saving:
        save_json(RECORDS[1], bench, out)
    return {RECORDS[0]: fig78, RECORDS[1]: bench}


def claims(records: dict) -> dict:
    fig7, fig8 = records[RECORDS[0]]["fig7"], records[RECORDS[0]]["fig8"]
    bench = records[RECORDS[1]]
    best_hashed = max(fig7["grid"].values())
    out = {
        "streamed within 0.5 pp of full batch": bench["gap_pp"] <= 0.5,
        **({"sharded within 0.5 pp of streamed":
            bench["gap_sharded_pp"] <= 0.5} if "ndev" in bench else {}),
        "hashed beats raw linear": best_hashed >= fig7["linear_ref"],
        "hashed within 4 pp of exact min-max":
            best_hashed >= fig7["minmax_ref"] - 4.0}
    if not records[RECORDS[0]]["fast"]:
        gap = {b: abs(fig8[b]["bt0"] - fig8[b]["bt2"]) for b in ("b4", "b8")}
        for b in ("b4", "b8"):
            out[f"b_t = 2 within 5 pp of b_t = 0 at {b}"] = gap[b] < 5.0
        out["b_t gap shrinks from b_i = 4 to 8"] = (
            gap["b8"] <= gap["b4"] + 0.5)
    return out


def check_claims(records: dict) -> dict:
    return check("fig78", claims(records))
