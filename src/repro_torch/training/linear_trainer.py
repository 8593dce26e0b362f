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

Preemption: ``ckpt=`` with ``ckpt_every=N`` saves (params, opt state,
pipeline state) every N steps in the reference's checkpoint format, with
the stream position, shuffle key, pipeline fingerprint, ``TrainCfg`` and
row count in the manifest's ``extra.stream``, key for key the
reference's.  ``resume_linear_streamed`` continues such a run (one the
reference wrote too) bit-identically: the batch walk is a pure function
of (shuffle key, epoch, step) and the gradient is deterministic, so step
s of the resumed run takes the rows and the state of step s of an
uninterrupted one, on the card or on the CPU.
``fit_linear_streamed_resilient`` wraps both in a ``RetryingTrainer``;
``chaos=`` threads a deterministic fault plan through the step,
evaluation-chunk and checkpoint-write sites.

Not yet ported: the data-parallel ``mesh=`` path (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core.linear_model import (LinearParams, TrainCfg, _loss_fn,
                                           bag_logits, bag_logits_packed,
                                           init_bag, make_linear_tx,
                                           same_device, validate_bag_features)
from repro_torch.core.regen import fold_in, permutation, prng_key
from repro_torch.pipeline import FeaturePipeline
from repro_torch.runtime.fault_tolerance import RetryingTrainer, StepWatchdog
from repro_torch.training.trainer import microbatch_grads

__all__ = ["fit_linear_streamed", "resume_linear_streamed",
           "fit_linear_streamed_resilient", "streamed_accuracy",
           "resume_streamed_accuracy", "export_served_model",
           "checkpoint_tree"]


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("data-parallel training (mesh=) is not "
                                  "ported yet (ROADMAP A11)")


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


# -- checkpoint helpers ------------------------------------------------


def _as_checkpointer(ckpt, chaos=None) -> Checkpointer:
    if isinstance(ckpt, Checkpointer):
        return ckpt
    return Checkpointer(ckpt, chaos=chaos)


def _key_data_list(key) -> list:
    """Key words -> the JSON list of two uint32 the reference stores."""
    return np.asarray(key, np.uint32).tolist()


def _params_digest(params) -> str:
    """crc32 over the leaves' float32 bytes in the reference's leaf order:
    the reference's digest of the same table."""
    data = b"".join(t.detach().cpu().numpy().tobytes()
                    for t in optim.tree_leaves(params))
    return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def _check_match(what: str, stored, current) -> None:
    if stored != current:
        raise ValueError(
            f"checkpoint {what} mismatch: resume must replay the exact "
            f"run that was checkpointed.\n  checkpointed: {stored}\n"
            f"  current:      {current}")


def checkpoint_tree(params, state, pipe: FeaturePipeline) -> dict:
    """The tree a streamed fit checkpoints: (params, opt state, pipeline
    key words or CWS matrices), the reference's.  The stream position
    rides in the manifest's ``extra``."""
    launch = pipe._state()
    if pipe.param_free:
        launch = np.asarray(launch, np.uint32)
    return {"params": params, "opt_state": state, "pipeline": launch}


def _guard_fresh_dir(ck: Checkpointer, resume_fn: str) -> None:
    existing = latest_step(ck.ckpt_dir)
    if existing is not None:
        raise ValueError(
            f"checkpoint dir {ck.ckpt_dir} already holds committed step "
            f"{existing}; a fresh fit would interleave its step numbers "
            f"with the old run's. Use {resume_fn} to continue it, or "
            f"point ckpt= at a fresh directory")


def _manifest_section(ck: Checkpointer, step: int, section: str,
                      writer: str) -> dict:
    manifest = json.loads(
        (ck.ckpt_dir / f"step_{step:08d}" / "manifest.json").read_text())
    got = manifest.get("extra", {}).get(section)
    if got is None:
        raise ValueError(
            f"checkpoint step {step} under {ck.ckpt_dir} carries no "
            f"{section} state: not a {writer} checkpoint")
    return got


class _StreamSetup:
    """Everything the streamed loop needs, derived once from the call
    arguments (all validation lives here), shared by fresh fits and
    resumes, so the two walk the same stream."""

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
        self.n_micro = n_microbatches
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

    # -- the checkpoint payload ----------------------------------------

    def ckpt_tree(self, params, state) -> dict:
        return checkpoint_tree(params, state, self.pipe)

    def ckpt_extra(self, next_step: int) -> dict:
        return {"stream": {
            "next_step": int(next_step),
            "shuffle_key": _key_data_list(self.key),
            "fingerprint": self.pipe.fingerprint(),
            "cfg": dataclasses.asdict(self.cfg),
            "n": int(self.n),
            "n_microbatches": int(self.n_micro),
        }}

    def template(self):
        """(params, opt state) as shapes and dtypes (tensors on the meta
        device), rebuilt from (pipe, cfg) alone."""
        p0 = init_bag(self.pipe.num_features, self.cfg.n_classes,
                      device="meta")
        return {"params": p0, "opt_state": self.tx.init(p0)}


def _stream_loop(S: _StreamSetup, params: LinearParams, state, start: int,
                 *, ckpt: Optional[Checkpointer], ckpt_every: int,
                 watchdog: Optional[StepWatchdog], chaos,
                 return_state: bool):
    """Run update steps ``start .. cfg.steps``: the loop behind fresh fits
    and resumes.  The epoch permutation is derived from ``(shuffle_key,
    epoch)`` on entry to each epoch, so starting mid-epoch walks the
    batches an uninterrupted run walks."""
    perm, cur_epoch = None, -1
    try:
        for i in range(start, S.cfg.steps):
            epoch, pos = divmod(i, S.steps_per_epoch)
            if watchdog is not None:
                watchdog.start_step(i)
            try:
                if chaos is not None:
                    chaos.fire("step", i)
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
            done = i + 1
            if (ckpt is not None and ckpt_every > 0
                    and (done % ckpt_every == 0 or done == S.cfg.steps)):
                ckpt.save_async(done, S.ckpt_tree(params, state),
                                extra=S.ckpt_extra(done))
        if ckpt is not None:
            ckpt.wait()   # raise a trailing write's error here
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

    ``ckpt=`` (a ``Checkpointer`` or a directory) with ``ckpt_every=N``
    saves the training state asynchronously every N steps and at the end;
    ``resume_linear_streamed`` continues such a run bit-identically.  The
    directory must hold no committed step (one that does wants the
    resume).  ``watchdog=`` arms a StepWatchdog around every step;
    ``chaos=`` threads a fault plan through the step site.
    ``return_state=True`` returns ``(params, opt_state)``.  ``params`` is
    not modified."""
    _refuse_mesh(mesh)
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    if same_device("fit_linear_streamed table", params.w,
                   params.b) != pipe.device:
        raise ValueError(f"table on {params.w.device} but the pipeline on "
                         f"{pipe.device}; move them to one device")
    S = _StreamSetup(pipe, x, labels, cfg, shuffle_key, n_microbatches)
    ck = _as_checkpointer(ckpt, chaos) if ckpt is not None else None
    if ck is not None and ckpt_every > 0:
        _guard_fresh_dir(ck, "resume_linear_streamed")
    return _stream_loop(S, params, S.tx.init(params), 0, ckpt=ck,
                        ckpt_every=ckpt_every, watchdog=watchdog,
                        chaos=chaos, return_state=return_state)


def resume_linear_streamed(ckpt, pipe: FeaturePipeline, x, labels, *,
                           cfg: TrainCfg, shuffle_key=None,
                           n_microbatches: int = 1, mesh=None,
                           step: Optional[int] = None, ckpt_every: int = 0,
                           watchdog: Optional[StepWatchdog] = None,
                           chaos=None, return_state: bool = False):
    """Continue a checkpointed ``fit_linear_streamed`` run (of either
    package) from its latest committed step, or ``step=``, bit-identically
    to the run never having been interrupted.  The state is restored on
    the pipeline's device, so a run checkpointed on the card finishes on
    the CPU, or the reverse.

    Guards: the checkpoint's pipeline fingerprint (spec, dim and a digest
    of the CWS key or matrices), ``TrainCfg``, row count,
    ``n_microbatches`` and, if one is passed, ``shuffle_key`` must match
    the checkpointed run; each mismatch raises ``ValueError``."""
    _refuse_mesh(mesh)
    ck = _as_checkpointer(ckpt, chaos)
    target = latest_step(ck.ckpt_dir) if step is None else step
    if target is None:
        raise FileNotFoundError(
            f"no committed checkpoint under {ck.ckpt_dir}; start with "
            f"fit_linear_streamed(..., ckpt=, ckpt_every=)")
    stream = _manifest_section(ck, target, "stream", "fit_linear_streamed")
    _check_match("pipeline fingerprint", stream["fingerprint"],
                 pipe.fingerprint())
    _check_match("TrainCfg", stream["cfg"], dataclasses.asdict(cfg))
    _check_match("dataset rows", stream["n"], int(x.shape[0]))
    _check_match("n_microbatches", stream["n_microbatches"],
                 int(n_microbatches))
    if shuffle_key is not None:
        _check_match("shuffle_key", stream["shuffle_key"],
                     _key_data_list(shuffle_key))
    stored_key = np.asarray(stream["shuffle_key"], np.uint32)
    S = _StreamSetup(pipe, x, labels, cfg, stored_key, n_microbatches)
    restored = restore_checkpoint(ck.ckpt_dir, target, S.template(),
                                  device=pipe.device)
    return _stream_loop(S, restored["params"], restored["opt_state"],
                        int(stream["next_step"]), ckpt=ck,
                        ckpt_every=ckpt_every, watchdog=watchdog,
                        chaos=chaos, return_state=return_state)


def fit_linear_streamed_resilient(params: LinearParams,
                                  pipe: FeaturePipeline, x, labels, *,
                                  cfg: TrainCfg, ckpt, ckpt_every: int,
                                  shuffle_key=None, n_microbatches: int = 1,
                                  mesh=None,
                                  trainer: Optional[RetryingTrainer] = None,
                                  hard_timeout_s: float = 0.0, chaos=None,
                                  return_state: bool = False):
    """Checkpointed streamed training under a ``RetryingTrainer`` and, with
    ``hard_timeout_s``, a hard-timeout ``StepWatchdog``.

    Each attempt resumes from the latest committed checkpoint if there is
    one, else starts fresh, so it survives in-process faults (a step that
    raises, a hung step the watchdog aborts, a failed checkpoint write)
    with backoff and a restart log (``trainer.restart_log``).  After
    process death, the same call in a new process resumes where the old
    one committed."""
    _refuse_mesh(mesh)
    ck = _as_checkpointer(ckpt, chaos)
    trainer = trainer or RetryingTrainer()
    kw = dict(cfg=cfg, shuffle_key=shuffle_key,
              n_microbatches=n_microbatches, ckpt_every=ckpt_every,
              chaos=chaos, return_state=return_state)

    def attempt():
        wd = (StepWatchdog(hard_timeout_s=hard_timeout_s)
              if hard_timeout_s > 0 else None)
        # a failed attempt's last write may still be in flight: resume from
        # the newest commit, whatever the thread's timing
        ck.join()
        try:
            if latest_step(ck.ckpt_dir) is None:
                return fit_linear_streamed(params, pipe, x, labels, ckpt=ck,
                                           watchdog=wd, **kw)
            return resume_linear_streamed(ck, pipe, x, labels, watchdog=wd,
                                          **kw)
        finally:
            if wd is not None:
                wd.stop()

    return trainer.call(attempt)


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
    the device.  Packed pipelines score through ``bag_logits_packed``.

    ``ckpt=`` with ``ckpt_every=N`` (chunks) checkpoints the partial count
    and the position, so ``resume_streamed_accuracy`` finishes a killed
    evaluation exactly.  Use a directory of its own: its steps are chunk
    indices."""
    _refuse_mesh(mesh)
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    ck = _as_checkpointer(ckpt, chaos) if ckpt is not None else None
    if ck is not None and ckpt_every > 0:
        _guard_fresh_dir(ck, "resume_streamed_accuracy")
    n = x.shape[0]
    if n == 0:
        return 0.0
    return _eval_loop(params, pipe, x, labels, ck=ck, ckpt_every=ckpt_every,
                      chaos=chaos, base_lo=0, base_chunk=0, correct=0,
                      total=n)


@torch.no_grad()
def _eval_loop(params: LinearParams, pipe: FeaturePipeline, x, labels, *,
               ck: Optional[Checkpointer], ckpt_every: int, chaos,
               base_lo: int, base_chunk: int, correct: int,
               total: int) -> float:
    """Score ``x`` chunk by chunk, counting from ``correct``; positions in
    checkpoints are global (offset by ``base_lo`` and ``base_chunk``)."""
    logits_fn = _bag_logits_fn(pipe)
    labels = _labels_on(labels, pipe.device)
    same_device("streamed_accuracy", params.w, labels)
    fingerprint = digest = None
    if ck is not None and ckpt_every > 0:
        fingerprint, digest = pipe.fingerprint(), _params_digest(params)
    # accumulate on the device: a host int() per chunk would serialize
    # each chunk's compute against the next chunk's launch
    count = torch.full((), correct, dtype=torch.int64, device=labels.device)
    for c, (lo, hi, fb) in enumerate(pipe.feature_chunks(x)):
        if chaos is not None:
            chaos.fire("eval_chunk", base_chunk + c)
        pred = torch.argmax(logits_fn(params, fb), dim=-1)
        count += (pred == labels[lo:hi]).sum()
        done = c + 1
        if digest is not None and hi > lo and done % ckpt_every == 0:
            # the reference's int32 count
            ck.save_async(base_chunk + done,
                          {"correct": count.to(torch.int32)},
                          extra={"eval": {
                              "next_lo": int(base_lo + hi),
                              "next_chunk": int(base_chunk + done),
                              "n": int(total),
                              "fingerprint": fingerprint,
                              "table_digest": digest,
                          }})
    if ck is not None:
        ck.wait()
    return int(count) / total


def resume_streamed_accuracy(ckpt, params: LinearParams,
                             pipe: FeaturePipeline, x, labels, *, mesh=None,
                             chaos=None) -> float:
    """Finish a killed ``streamed_accuracy(ckpt=...)`` run: restore the
    committed partial count and score only the remaining rows.  Exact:
    featurization and scoring are per row.  Guards the fingerprint, the
    table digest and the row count."""
    _refuse_mesh(mesh)
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    ck = _as_checkpointer(ckpt, chaos)
    target = latest_step(ck.ckpt_dir)
    if target is None:
        raise FileNotFoundError(
            f"no committed eval checkpoint under {ck.ckpt_dir}")
    ev = _manifest_section(ck, target, "eval", "streamed_accuracy")
    _check_match("pipeline fingerprint", ev["fingerprint"],
                 pipe.fingerprint())
    _check_match("table digest", ev["table_digest"], _params_digest(params))
    _check_match("dataset rows", ev["n"], int(x.shape[0]))
    restored = restore_checkpoint(ck.ckpt_dir, target,
                                  {"correct": ((), torch.int32)},
                                  device="cpu")
    correct, lo, n = int(restored["correct"]), int(ev["next_lo"]), int(ev["n"])
    if lo >= n:
        return correct / n
    return _eval_loop(params, pipe, x[lo:], labels[lo:], ck=None,
                      ckpt_every=0, chaos=chaos, base_lo=lo,
                      base_chunk=int(ev["next_chunk"]), correct=correct,
                      total=n)
