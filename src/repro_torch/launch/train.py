"""LM training driver (port of ``repro.launch.train``): config-driven and
fault-tolerant.

The ``RetryingTrainer`` and the ``Checkpointer`` give restart-from-the-
last-commit semantics; the loader's state rides in the checkpoint
(``extra["loader"]``), so batches are neither replayed nor skipped.  The
step runs on the card unless ``--device cpu`` is passed (the plain
PyTorch kernels):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_12b \
      --variant smoke --steps 50 --global-batch 8 --seq-len 128

``--stop-at N`` ends the run after step N as a preemption would, the
schedule still spanning ``--steps``; a second run with the same
``--ckpt-dir`` resumes it.

Under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` / ``LOCAL_RANK``) every rank joins one gloo process group
and trains its shard of the step under the mesh (``make_local_mesh()``:
data = N, model = 1; ``--mesh D M`` for another; ``--production-mesh`` /
``--multipod`` for the reference's 16 x 16 / 2 x 16 x 16, which need 256
/ 512 ranks).  Each rank's device is ``cuda:{LOCAL_RANK % device_count}``;
ranks that share a card move their tensors through host copies.  Logs come
from rank 0:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch \
      gemma3_12b --variant smoke --steps 20 --mesh 1 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.loader import TokenBatchLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (join_torchrun_group, make_local_mesh,
                                     make_mesh, make_production_mesh)
from repro_torch.models.sharding import make_rules
from repro_torch.runtime import RetryingTrainer, StepWatchdog
from repro_torch.training import (TrainHparams, init_train_state,
                                  make_train_step)
from repro_torch.training.trainer import state_pspecs


class DictLoader:
    """``TokenBatchLoader`` tuples as the train step's batch dict of
    tensors on ``device``.  Under a mesh the inner loader is this rank's:
    ``process_index`` its index along the batch axes (``data``), and
    ``process_count`` their size, as the reference's loader runs per host;
    ranks that differ only in ``model`` draw the same rows, whole along
    the sequence (``input_specs``: the batch sharded, the sequence not),
    and the step keeps their sequence shard of the residual stream."""

    def __init__(self, inner: TokenBatchLoader, device):
        self.inner = inner
        self.device = device

    def __iter__(self):
        return self

    def __next__(self):
        toks, labels = next(self.inner)
        return {"inputs": torch.as_tensor(toks, device=self.device),
                "labels": torch.as_tensor(labels, device=self.device)}

    def snapshot(self):
        return self.inner.snapshot()

    def restore(self, snap):
        self.inner.restore(snap)


def build_trainer(cfg, hp: TrainHparams, *, global_batch: int, seq_len: int,
                  ckpt_dir, mesh=None, seed: int = 0, device=None):
    """(build, checkpointer or None, mesh): ``build() -> (state, loader,
    step_fn, start_step)`` for ``RetryingTrainer``, restoring the latest
    committed checkpoint of ``ckpt_dir`` when there is one.  Weights are
    drawn from ``seed`` on ``device`` (the card unless told otherwise).

    ``mesh`` defaults, as the reference's does, to ``make_local_mesh()``
    when a process group exists (none without one: the unsharded step).
    Under a mesh the step is sharded (``make_train_step(rules=)``), each
    rank holding its slices of the state and drawing its rows of every
    batch; checkpoints hold each slice once and restore onto any mesh."""
    device = resolve_device(device)
    if mesh is None and dist.is_initialized():
        mesh = make_local_mesh()
    rules = None if mesh is None else make_rules(mesh)
    specs = None if rules is None else state_pspecs(cfg, rules, hp)
    ck = Checkpointer(ckpt_dir, mesh=mesh, specs=specs) if ckpt_dir \
        else None
    index, count = 0, 1
    if rules is not None:
        batch = rules.rules.get("batch")
        index, count = mesh.axis_index(batch), rules.axes_size(batch)

    def build():
        loader = DictLoader(TokenBatchLoader(
            vocab=cfg.vocab, global_batch=global_batch, seq_len=seq_len,
            seed=seed, process_index=index, process_count=count), device)
        state, manifest = None, None
        if ck is not None:
            # the global shapes alone as the template: no second state on
            # the card
            template = init_train_state(cfg, hp, device="meta")
            state, manifest = ck.restore_latest(template, device=device)
        start = 0
        if state is None:
            state = init_train_state(
                cfg, hp, generator=torch.Generator(device).manual_seed(seed),
                device=device, rules=rules)
        else:
            loader.restore(manifest["extra"]["loader"])
            start = manifest["step"]
        return state, loader, make_train_step(cfg, hp, rules), start

    return build, ck, mesh


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--attn-impl", default=None,
                    choices=("naive", "chunked", "flash"),
                    help="override the config's attention route")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (data=16, model=16) mesh: 256 "
                    "ranks")
    ap.add_argument("--multipod", action="store_true",
                    help="the (pod=2, data=16, model=16) mesh: 512 ranks")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="a (data, model) mesh over the process group's "
                    "ranks (default: data = every rank, model = 1)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff-s", type=float, default=0.5,
                    help="base restart backoff (doubles per restart)")
    ap.add_argument("--hard-timeout-s", type=float, default=0.0,
                    help="abort a step hung longer than this (0 = off); "
                    "the watchdog fires mid-step, and the run restarts "
                    "from the last committed checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain "
                    "PyTorch kernels)")
    ap.add_argument("--stop-at", type=int, default=0,
                    help="end the run after this step, as a preemption "
                    "would (0 = run to --steps)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device, made = join_torchrun_group(args.device)
    try:
        return _train(args, device)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, device):
    mesh = None
    if args.production_mesh or args.multipod:
        mesh = make_production_mesh(multi_pod=args.multipod)
    elif args.mesh is not None:
        mesh = make_mesh(*args.mesh)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, args.variant)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    hp = TrainHparams(lr=args.lr, total_steps=args.steps,
                      warmup=max(args.steps // 20, 1),
                      n_microbatches=args.microbatches,
                      compress_grads=args.compress_grads)
    build, ck, _ = build_trainer(
        cfg, hp, global_batch=args.global_batch, seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir, mesh=mesh, device=device)
    end = min(args.stop_at, args.steps) if args.stop_at > 0 else args.steps

    t_last = [time.time()]

    def hook(step, state, metrics, loader):
        if step % args.log_every == 0:
            dt = time.time() - t_last[0]
            t_last[0] = time.time()
            tok_s = args.global_batch * args.seq_len * args.log_every / dt
            log(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"tok/s {tok_s:,.0f}", flush=True)
        if ck is not None and step % args.ckpt_every == 0:
            ck.save_async(step, state, extra={"loader": loader.snapshot()})

    def on_restart(event):
        # the structured restart log, one line per event, greppable
        log(f"restart {event['restart']}: {event['error']} at step "
              f"{event['step']} — {event['message']!r}; backing off "
              f"{event['backoff_s']:.1f}s"
              + (" (GIVING UP)" if event["gave_up"] else ""), flush=True)

    wd_factory = None
    if args.hard_timeout_s > 0:
        wd_factory = lambda: StepWatchdog(hard_timeout_s=args.hard_timeout_s)
    trainer = RetryingTrainer(build, max_restarts=args.max_restarts,
                              backoff_s=args.backoff_s,
                              on_restart=on_restart,
                              watchdog_factory=wd_factory)
    state = trainer.run(end, hooks=[hook])
    if ck is not None:
        ck.save_async(end, state, extra={"loader": {"step": end,
                                                    "seed": 0}})
        ck.wait()
    log("done")
    return state


if __name__ == "__main__":
    main()
