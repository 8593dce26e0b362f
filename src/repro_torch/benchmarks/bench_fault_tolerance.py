"""Fault-tolerance cost model: what preemption-grade training pays (twin
of ``benchmarks/bench_fault_tolerance.py``).

  * async-checkpoint overhead: wall time a step of the checkpointed run
    against the bare run (the snapshot is synchronous, the file IO on a
    background thread);
  * save and restore wall time: one (params, opt state, pipeline) round
    trip through the commit protocol;
  * resume gap: accuracy of kill-at-step-N + resume against the
    uninterrupted run.  The resume contract is bit-identity, so the gap
    must be exactly 0.00 pp.

On the reference's own draws: ``make_template_classification(3, ...)``
and stored CWS parameters ``make_cws_params_jax(
prng_key(7), 64, 32)`` at b_i = 6 (TPU row 2, ``cws_encode``, a launch a
step).  The reference's sizes: ``--fast`` 640 rows and 60 steps, else
4,096 rows and 300 steps; batch 64, a checkpoint every 10 steps, the kill
at ``steps // 2 + 3``.  The record keeps the reference's keys; its gates
(``claims``) are checked after it is saved.  The I/O and overhead times
are printed, not gated.  ``async_split`` (not in the reference's record)
takes the checkpointed fit's overhead apart: the time its saves blocked
on the write before, its snapshots, the writer thread's wall and CPU
time, and the main thread's CPU time in the bare and checkpointed fits.
"""
from __future__ import annotations

import tempfile
import time

import torch

from repro_torch.benchmarks.common import (check, emit, load_reference,
                                           meta, save_json, sync)
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core import CWSParams, make_cws_params_jax
from repro_torch.core.linear_model import TrainCfg, init_bag, make_linear_tx
from repro_torch.core.regen import prng_key
from repro_torch.data.synthetic import make_template_classification
from repro_torch.device import resolve_device
from repro_torch.optim import tree_leaves
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.runtime import ChaosKill, ChaosPlan, kill_at
from repro_torch.training import (checkpoint_tree, fit_linear_streamed,
                                  resume_linear_streamed, streamed_accuracy)

RECORDS = ("BENCH_fault_tolerance",)
REFERENCE = "bench_fault_tolerance"     # the reference's --fast record
CKPT_EVERY = 10
ACC_PP = 1.0      # fig78's per-cell limit for AdamW's one rounding a step


def problem(fast: bool, dev: torch.device):
    """(ds, rows and labels on ``dev``, pipe, cfg, p0)."""
    n_train = 640 if fast else 4096
    ds = make_template_classification(3, n_train=n_train, n_test=400,
                                      dim=64, n_classes=4, density=0.3)
    p = make_cws_params_jax(prng_key(7), 64, 32)
    pipe = FeaturePipeline(CWSParams(*(m.to(dev) for m in (
        p.r, p.log_c, p.beta))), FeatureSpec(num_hashes=32, b_i=6))
    cfg = TrainCfg(n_classes=4, steps=60 if fast else 300, batch_size=64,
                   lr=0.05)
    p0 = init_bag(pipe.num_features, 4, device=dev)
    data = [torch.from_numpy(a).to(dev) for a in (
        ds.x_train, ds.y_train, ds.x_test, ds.y_test)]
    return data, pipe, cfg, p0


def _timed(dev, fn, cpu=False):
    """(fn(), wall s), and with ``cpu`` the main thread's CPU s too."""
    sync(dev)
    t0, c0 = time.perf_counter(), time.thread_time()
    out = fn()
    sync(dev)
    wall, cpu_s = time.perf_counter() - t0, time.thread_time() - c0
    return (out, wall, cpu_s) if cpu else (out, wall)


def run(fast: bool = False, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    (xtr, ytr, xte, yte), pipe, cfg, p0 = problem(fast, dev)
    fit = lambda **kw: fit_linear_streamed(p0, pipe, xtr, ytr, cfg=cfg, **kw)

    fit()     # warm the kernels and the allocator
    bare, t_bare, cpu_bare = _timed(dev, fit, cpu=True)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        _, t_ckpt, cpu_ckpt = _timed(dev, lambda: fit(
            ckpt=ck, ckpt_every=CKPT_EVERY), cpu=True)
        split = {"saves": ck.totals["saves"]} | {
            f"{k[:-2]}_ms": 1e3 * v for k, v in ck.totals.items()
            if k != "saves"}
    per_step_bare_us = t_bare / cfg.steps * 1e6
    per_step_ckpt_us = t_ckpt / cfg.steps * 1e6
    overhead_pct = (t_ckpt / t_bare - 1.0) * 100

    # one save through the protocol (snapshot, then the writer thread)
    # and one restore
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        tree = checkpoint_tree(bare, make_linear_tx(cfg).init(bare), pipe)
        t0 = time.perf_counter()
        ck.save_async(1, tree)
        ck.wait()
        t_save = time.perf_counter() - t0
        back, t_restore = _timed(dev, lambda: restore_checkpoint(
            ck.ckpt_dir, 1, tree, device=dev))
        ckpt_bytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(tree["params"])
                         + tree_leaves(tree["opt_state"])
                         + [tree["pipeline"].r, tree["pipeline"].log_c,
                            tree["pipeline"].beta])
        snapshot_s, write_s = ck.last_snapshot_s, ck.last_write_s

    # kill mid-run, resume, compare: the gap is a contract, not a limit
    acc_clean = streamed_accuracy(bare, pipe, xte, yte)
    kill_step = cfg.steps // 2 + 3
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        try:
            fit(ckpt=ck, ckpt_every=CKPT_EVERY,
                chaos=ChaosPlan(kill_at(kill_step)))
            raise AssertionError("chaos kill did not fire")
        except ChaosKill:
            ck.join()     # the killed run's last write
        resumed_from = latest_step(d)
        resumed, t_resume = _timed(dev, lambda: resume_linear_streamed(
            d, pipe, xtr, ytr, cfg=cfg))
    acc_resumed = streamed_accuracy(resumed, pipe, xte, yte)
    gap_pp = (acc_clean - acc_resumed) * 100
    bit_identical = all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(bare), tree_leaves(resumed)))

    rec = {
        "config": {"fast": fast, "steps": cfg.steps,
                   "batch_size": cfg.batch_size,
                   "ckpt_every": CKPT_EVERY, "kill_step": kill_step,
                   "n_train": int(xtr.shape[0]),
                   "num_features": int(pipe.num_features)},
        "async_ckpt": {
            "bare_us_per_step": per_step_bare_us,
            "ckpt_us_per_step": per_step_ckpt_us,
            "overhead_pct": overhead_pct,
        },
        "io": {"save_wall_s": t_save, "restore_wall_s": t_restore,
               "checkpoint_bytes": ckpt_bytes, "snapshot_s": snapshot_s,
               "write_s": write_s},
        "async_split": {**split, "main_cpu_ms_bare": 1e3 * cpu_bare,
                        "main_cpu_ms_ckpt": 1e3 * cpu_ckpt},
        "resume": {"resumed_from_step": resumed_from,
                   "resume_wall_s": t_resume,
                   "acc_clean": acc_clean, "acc_resumed": acc_resumed,
                   "resume_gap_pp": gap_pp,
                   "bit_identical_params": bit_identical},
    }
    rec.update(meta(dev, "jax", fast))
    emit("fault_tolerance/step_overhead", per_step_ckpt_us,
         f"bare={per_step_bare_us:.0f}us overhead={overhead_pct:.1f}% "
         "per save: " + " ".join(
             f"{k}={v / split['saves']:.2f}" for k, v in split.items()
             if k != "saves"))
    emit("fault_tolerance/save", t_save * 1e6,
         f"{ckpt_bytes/1e6:.2f}MB restore={t_restore*1e6:.0f}us")
    emit("fault_tolerance/resume", t_resume * 1e6,
         f"from_step={resumed_from} gap={gap_pp:.2f}pp")
    save_json(RECORDS[0], rec, out)
    return {RECORDS[0]: rec}


def claims(records: dict) -> dict:
    """Bit-identity, a zero gap, the checkpoint the reference's rule
    resumes from (the last multiple of 10 before the kill: 30 at
    ``--fast``, as in the reference's record), and at ``--fast`` the clean
    accuracy within ``ACC_PP`` of the reference's record."""
    rec = records[RECORDS[0]]
    res, cfg = rec["resume"], rec["config"]
    out = {"kill + resume bit-identical": bool(res["bit_identical_params"]),
           "resume gap exactly 0.0 pp": res["resume_gap_pp"] == 0.0,
           "resumed from the last committed step before the kill":
               res["resumed_from_step"] ==
               (cfg["kill_step"] - 1) // cfg["ckpt_every"] * cfg["ckpt_every"]}
    if cfg["fast"]:
        ref = load_reference(REFERENCE)["resume"]
        out["resumed from the reference's step"] = (
            res["resumed_from_step"] == ref["resumed_from_step"])
        out[f"clean accuracy within {ACC_PP} pp of the reference's"] = (
            abs(res["acc_clean"] - ref["acc_clean"]) * 100 <= ACC_PP)
    return out


def check_claims(records: dict) -> dict:
    return check("fault_tolerance", claims(records))
