"""Streaming minibatch training over the featurization pipeline (port of
``repro.training.linear_trainer``, unsharded).

Each minibatch is featurized INSIDE the training loop by one pipeline
kernel launch (``FeaturePipeline.launch_chunk``), so the full (n, k)
index matrix never exists.  Peak working set:

    O(batch_size * max(D, k))     batch gather + one launch in flight
  + O(F * C)                      the (num_features, n_classes) table
                                  + its Adam moments

independent of n.  The raw (n, D) rows stay where the caller keeps them:
host numpy rows are gathered on the host, so only the (bs, D) batch
crosses to the card; tensor rows are gathered on their own device.

Epoch shuffling walks the reference's batches from the same key words:
``permutation(fold_in(shuffle_key, epoch), n)`` (ragged remainder
dropped).  ``batch_size == n`` skips the permutation, since a full-batch
gradient is order-invariant, and is then bit-identical to full-batch
``fit_linear`` on precomputed features.  Gradients go through
``trainer.microbatch_grads``.

Not yet ported: the data-parallel ``mesh=`` path (ROADMAP A11), and
checkpointed, resumed and chaos-tested training and evaluation (A9).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.core.linear_model import (LinearParams, TrainCfg, _loss_fn,
                                           bag_logits, bag_logits_packed,
                                           make_linear_tx, same_device,
                                           validate_bag_features)
from repro_torch.core.regen import fold_in, permutation, prng_key
from repro_torch.pipeline import FeaturePipeline
from repro_torch.runtime.fault_tolerance import StepWatchdog
from repro_torch.training.trainer import microbatch_grads

__all__ = ["fit_linear_streamed", "resume_linear_streamed",
           "fit_linear_streamed_resilient", "streamed_accuracy",
           "resume_streamed_accuracy", "export_served_model"]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _refuse(mesh, ckpt=None, ckpt_every=0, chaos=None) -> None:
    if mesh is not None:
        _not_ported("data-parallel training (mesh=)", "A11")
    if ckpt is not None or ckpt_every or chaos is not None:
        _not_ported("checkpointed training (ckpt=, ckpt_every=, chaos=)",
                    "A9")


def _bag_logits_fn(pipe: FeaturePipeline):
    """The logits head matching the pipeline's output: ``bag_logits``, or
    for a packed spec ``bag_logits_packed`` bound to its (k, b), which
    unpacks to the same indices, so packed and unpacked training at the
    same (b_i, b_t) are bit-identical."""
    spec = pipe.spec
    if not spec.packed:
        return bag_logits
    return functools.partial(bag_logits_packed, num_hashes=spec.num_hashes,
                             b=spec.bits)


def _make_update_step(cfg: TrainCfg, tx, n_micro: int, logits_fn=bag_logits):
    """One update on a featurized minibatch: (params, state, loss)."""
    def loss_fn(p, inputs, labels):
        return _loss_fn(p, inputs, labels, cfg, logits_fn), {}

    def update(params, state, fb, yb, i):
        loss, _, grads = microbatch_grads(
            loss_fn, params, {"inputs": fb, "labels": yb}, n_micro=n_micro)
        with torch.no_grad():
            updates, state = tx.update(grads, state, params, i)
            return optim.apply_updates(params, updates), state, loss

    return update


def _labels_on(labels, device) -> torch.Tensor:
    if isinstance(labels, torch.Tensor):
        return labels
    return torch.as_tensor(np.asarray(labels)).to(device)


class _StreamSetup:
    """Everything the streamed loop needs, derived once from the call
    arguments (all validation lives here)."""

    def __init__(self, pipe: FeaturePipeline, x, labels, cfg: TrainCfg,
                 shuffle_key, n_microbatches: int):
        n = x.shape[0]
        bs = cfg.batch_size
        if bs <= 0:
            raise ValueError(
                "fit_linear_streamed needs batch_size in [1, n]; "
                "batch_size=0 is the explicit full-batch fit_linear path "
                "(which materializes the full (n, k) index matrix)")
        if bs > n:
            raise ValueError(
                f"batch_size {bs} exceeds the {n} available rows")
        if n_microbatches < 1 or bs % n_microbatches:
            raise ValueError(f"batch {bs} must divide into "
                             f"{n_microbatches} microbatches")
        if labels.shape[0] != n:
            raise ValueError(
                f"labels {tuple(labels.shape)} do not match x "
                f"{tuple(x.shape)}")
        self.host_data = not isinstance(x, torch.Tensor)
        if self.host_data:
            if isinstance(labels, torch.Tensor):
                raise ValueError("host (numpy) rows need host labels; got "
                                 f"a tensor on {labels.device}")
        else:
            same_device("fit_linear_streamed rows and labels", x, labels)
            if x.device != pipe.device:
                raise ValueError(f"rows on {x.device} but the pipeline on "
                                 f"{pipe.device}; move them to one device")

        self.pipe, self.x, self.labels = pipe, x, labels
        self.cfg, self.n, self.bs = cfg, n, bs
        self.tx = make_linear_tx(cfg)
        self.steps_per_epoch = max(n // bs, 1)
        self.key = shuffle_key if shuffle_key is not None else prng_key(0)
        self.shuffle = bs < n
        self.update = _make_update_step(cfg, self.tx, n_microbatches,
                                        _bag_logits_fn(pipe))
        self.labels_host = None
        self.fb_full = self.yb_full = None
        if not self.shuffle:
            # batch_size == n: the gradient is order-invariant, so skip the
            # permutation and the per-step featurization: one sweep up front
            self.fb_full = pipe.features(x)
            self.yb_full = _labels_on(labels, pipe.device)
        elif self.host_data:
            self.labels_host = np.asarray(labels)

    def batch(self, perm: torch.Tensor, pos: int):
        """The (bs, D) rows and (bs,) labels at window ``pos`` of ``perm``:
        gathered on the host for numpy rows, else on the rows' device."""
        lo, hi = pos * self.bs, (pos + 1) * self.bs
        if self.host_data:
            sel = perm[lo:hi].numpy()
            return self.x[sel], _labels_on(self.labels_host[sel],
                                           self.pipe.device)
        idx = perm[lo:hi]
        return self.x.index_select(0, idx), self.labels.index_select(0, idx)


def _stream_loop(S: _StreamSetup, params: LinearParams, state, start: int,
                 *, watchdog: Optional[StepWatchdog], return_state: bool):
    """Run update steps ``start .. cfg.steps``.  The epoch permutation is
    derived from ``(shuffle_key, epoch)`` on entry to each epoch."""
    perm, cur_epoch = None, -1
    try:
        for i in range(start, S.cfg.steps):
            epoch, pos = divmod(i, S.steps_per_epoch)
            if watchdog is not None:
                watchdog.start_step(i)
            try:
                if S.shuffle:
                    if epoch != cur_epoch:
                        perm = permutation(fold_in(S.key, epoch), S.n)
                        if not S.host_data:
                            perm = perm.to(S.x.device, non_blocking=True)
                        cur_epoch = epoch
                    xb, yb = S.batch(perm, pos)
                    fb = S.pipe.launch_chunk(xb)
                    params, state, _ = S.update(params, state, fb, yb, i)
                else:
                    params, state, _ = S.update(params, state, S.fb_full,
                                                S.yb_full, i)
                if watchdog is not None and params.w.is_cuda:
                    torch.cuda.synchronize(params.w.device)
            except KeyboardInterrupt as e:
                # the watchdog's monitor interrupts a hung step with SIGINT;
                # a real Ctrl-C, with no fired timeout, re-raises untouched
                if watchdog is not None:
                    watchdog.reraise_if_fired(e)
                raise
            if watchdog is not None:
                watchdog.end_step()
    finally:
        if watchdog is not None:
            watchdog.stop()
    return (params, state) if return_state else params


def fit_linear_streamed(params: LinearParams, pipe: FeaturePipeline, x,
                        labels, *, cfg: TrainCfg, shuffle_key=None,
                        n_microbatches: int = 1, mesh=None, ckpt=None,
                        ckpt_every: int = 0,
                        watchdog: Optional[StepWatchdog] = None,
                        chaos=None, return_state: bool = False):
    """Minibatch AdamW with featurization fused into the loop.

    ``x`` (n, D) raw nonneg rows, host numpy or a tensor on the
    pipeline's device; ``params`` a flat bag table on that device, built
    with ``init_bag(pipe.num_features, n_classes)`` (validated here).
    ``cfg.steps`` counts updates; ``cfg.batch_size`` must be in [1, n]
    (``batch_size=0`` belongs to ``fit_linear``, which this function
    matches bit for bit at ``batch_size == n``).  ``shuffle_key`` is two
    key words (``prng_key(0)`` by default), the reference's key.
    ``watchdog=`` arms a StepWatchdog around every step.
    ``return_state=True`` returns ``(params, opt_state)``.  ``params`` is
    not modified."""
    _refuse(mesh, ckpt, ckpt_every, chaos)
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    if same_device("fit_linear_streamed table", params.w,
                   params.b) != pipe.device:
        raise ValueError(f"table on {params.w.device} but the pipeline on "
                         f"{pipe.device}; move them to one device")
    S = _StreamSetup(pipe, x, labels, cfg, shuffle_key, n_microbatches)
    return _stream_loop(S, params, S.tx.init(params), 0, watchdog=watchdog,
                        return_state=return_state)


def resume_linear_streamed(*args, **kwargs):
    _not_ported("resume_linear_streamed", "A9")


def fit_linear_streamed_resilient(*args, **kwargs):
    _not_ported("fit_linear_streamed_resilient", "A9")


def export_served_model(params: LinearParams, pipe: FeaturePipeline,
                        path) -> None:
    """Hand a trained ``(params, pipe)`` pair to the serving stack: a
    served-model bundle directory (``repro_torch.serving.bundle``, the
    reference's format) that ``ServingService.from_bundle`` boots from."""
    from repro_torch.serving.bundle import save_bundle
    save_bundle(path, params, pipe)


def streamed_accuracy(params: LinearParams, pipe: FeaturePipeline, x,
                      labels, *, mesh=None, ckpt=None, ckpt_every: int = 0,
                      chaos=None) -> float:
    """Accuracy over pipeline features without materializing (n, k):
    walks ``pipe.feature_chunks`` and accumulates the correct count on
    the device.  Packed pipelines score through ``bag_logits_packed``."""
    _refuse(mesh, ckpt, ckpt_every, chaos)
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    n = x.shape[0]
    if n == 0:
        return 0.0
    return _eval_loop(params, pipe, x, labels, total=n)


@torch.no_grad()
def _eval_loop(params: LinearParams, pipe: FeaturePipeline, x, labels, *,
               total: int) -> float:
    logits_fn = _bag_logits_fn(pipe)
    labels = _labels_on(labels, pipe.device)
    same_device("streamed_accuracy", params.w, labels)
    # accumulate on the device: a host int() per chunk would serialize
    # each chunk's compute against the next chunk's launch
    correct = torch.zeros((), dtype=torch.int64, device=labels.device)
    for lo, hi, fb in pipe.feature_chunks(x):
        pred = torch.argmax(logits_fn(params, fb), dim=-1)
        correct += (pred == labels[lo:hi]).sum()
    return int(correct) / total


def resume_streamed_accuracy(*args, **kwargs):
    _not_ported("resume_streamed_accuracy", "A9")
