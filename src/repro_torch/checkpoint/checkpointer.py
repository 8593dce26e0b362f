"""Async checkpoints in the reference's on-disk format (port of
``repro.checkpoint.checkpointer``).

Layout, one directory per step, byte-compatible with the reference:

    ckpt_dir/step_00000100/
        manifest.json     # step, leaves (name, shape, dtype, spec), extra,
                          # n_processes
        shard_p{i}.npz    # slots a0, a1, ...: process i's slices
        index_p{i}.json   # "<leaf name>::<j>" -> slot, index, dtype
        COMMIT            # written last: the commit point

Leaf names are the reference's ``_tree_paths``: a dict key is
``['key']`` (keys sorted), a NamedTuple field ``.field``, a tuple or list
element ``[i]``, and a child of a dataclass (``AdamState``,
``CWSParams``, registered as plain pytree nodes in the reference)
``[<flat index i>]``, joined by ``/``.  bfloat16 leaves are stored as
their ``uint16`` bits with ``dtype: "bfloat16"``, as the reference stores
them.  So each package restores the other's checkpoints.

Commit protocol (crash-safe at every interleaving, exercised by the chaos
sites ``ckpt_io``, ``ckpt_pre_rename`` and ``ckpt_pre_commit``):

    write the shards and the manifest into step_XXXXXXXX.tmp
    rename step_XXXXXXXX.tmp -> step_XXXXXXXX          (atomic on POSIX)
    write step_XXXXXXXX/COMMIT                          (the commit point)

A crash before the rename leaves a ``.tmp`` dir, one between the rename
and COMMIT an uncommitted step dir.  Both are invisible to
``latest_step`` and to retention, and ``gc_incomplete`` sweeps them when
a ``Checkpointer`` is built.

``Checkpointer.save_async`` copies every leaf to host memory before it
returns, so the next training step may overwrite the live tensors while
the background thread writes the files.  Restore assembles each leaf from
the slices the indexes list, so a checkpoint written as several shards, by
several processes, reads too.

Under a data mesh (``mesh=``, ``repro_torch.launch.mesh``) the leaves are
replicated on every rank, and each of the mesh's ndev ranks writes its
1/ndev of every leaf's rows (scalars on rank 0) to its own
``shard_p{rank}.npz`` / ``index_p{rank}.json``, so the checkpoint holds
each leaf once and ``n_processes`` is ndev, as the reference writes from
ndev processes.  The ranks agree at each stage over the mesh's
``host_group`` (a gloo all-reduce of a failure flag, on the writer
threads): the write dir is made, every rank's files are written, then
rank 0 renames and writes ``COMMIT``, so ``COMMIT`` follows every rank's
writes, and a failure on any rank fails the save on every rank.  Restore
(``shardings=``, the mesh that exists now, or None) reads the whole of
every leaf on every rank: the trainer's state is replicated, so a
checkpoint written by any number of ranks restores onto any other.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

Tree = Any

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step", "committed_steps", "gc_incomplete", "tree_paths"]

# dtypes whose bits numpy cannot hold: stored as unsigned words of their
# width, named by the leaf's own dtype
_BITS_ONLY = {torch.bfloat16: np.uint16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _BITS_ONLY[getattr(torch, _name)] = np.uint8
_SIGNED_OF = {np.dtype(np.uint16): torch.int16, np.dtype(np.uint8): torch.int8,
              np.dtype(np.uint32): torch.int32, np.dtype(np.uint64): torch.int64}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    """A ``(shape, dtype)`` template leaf."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def _children(tree):
    """(key text, child) of an inner node in the reference's leaf order,
    or None for a leaf."""
    if _is_spec(tree) or isinstance(tree, (torch.Tensor, np.ndarray)):
        return None
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f"[<flat index {i}>]", getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _flatten(tree, prefix=()) -> list:
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [x for key, child in kids for x in _flatten(child, prefix + (key,))]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    vals = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(vals)
    return type(tree)(*vals)


def tree_paths(tree) -> list[str]:
    """The leaf names the reference's ``_tree_paths`` gives the same tree."""
    return [name for name, _ in _flatten(tree)]


def _host_copy(leaf):
    """A host copy of ``leaf`` that no later write to it can reach:
    (numpy array of the bits to store, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        bits = _BITS_ONLY.get(t.dtype)
        if bits is None and name in ("uint16", "uint32", "uint64"):
            bits = name
        if bits is not None:
            # through the signed type of the same width, which every
            # PyTorch hands to numpy
            bits = np.dtype(bits)
            return t.view(_SIGNED_OF[bits]).numpy().view(bits), name
        return t.numpy(), name
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _leaf_spec(leaf):
    """(shape, torch dtype) of a template leaf."""
    if _is_spec(leaf):
        return tuple(leaf[0]), leaf[1]
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    a = np.asarray(leaf)
    return a.shape, getattr(torch, str(a.dtype))


def _to_tensor(arr: np.ndarray, stored: str) -> torch.Tensor:
    """The stored bits of a leaf as a tensor of its dtype ``stored``."""
    want = getattr(torch, stored)
    signed = _SIGNED_OF.get(arr.dtype)
    if signed is not None:
        # unsigned words (and bfloat16 bits): through the signed type of
        # the same width, which every PyTorch reads from numpy
        arr = arr.view(np.dtype(str(signed).removeprefix("torch.")))
        return torch.from_numpy(arr).view(want)
    return torch.from_numpy(arr).to(want)


# ---------------------------------------------------------------------------
# the directory
# ---------------------------------------------------------------------------

def _step_of(p: pathlib.Path) -> Optional[int]:
    """``step_NNNNNNNN`` -> N; None for anything else, in particular the
    ``step_*.tmp`` write dirs a crash can leave behind."""
    if not p.name.startswith("step_") or p.name.endswith(".tmp"):
        return None
    try:
        return int(p.name.split("_")[1])
    except ValueError:
        return None


def committed_steps(ckpt_dir) -> list[int]:
    """All committed step numbers, ascending (crash leftovers excluded)."""
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(s for p in d.iterdir()
                  if (s := _step_of(p)) is not None
                  and (p / "COMMIT").exists())


def latest_step(ckpt_dir) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def gc_incomplete(ckpt_dir) -> list[str]:
    """Sweep crash leftovers: ``step_*.tmp`` dirs (died before the rename)
    and uncommitted ``step_*`` dirs (died between the rename and COMMIT).
    Returns the removed names, sorted."""
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return []
    removed = []
    for p in list(d.iterdir()):
        if not p.is_dir() or not p.name.startswith("step_"):
            continue
        if p.name.endswith(".tmp") or not (p / "COMMIT").exists():
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p.name)
    return sorted(removed)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _writer(mesh):
    """(this process's index, process count, agreement group) for a save
    under ``mesh``: (0, 1, None) without one, or on one rank."""
    if mesh is None or mesh.size == 1 or mesh.host_group is None:
        return 0, 1, None
    return mesh.rank, mesh.size, mesh.host_group


def _extract_shards(step: int, tree: Tree, extra: Optional[dict],
                    proc: int = 0, nproc: int = 1):
    """Copy this process's slices of every leaf to host memory (the
    snapshot): the whole leaf for one process; for ``nproc`` processes,
    process ``proc``'s rows ``[s0 * proc // nproc, s0 * (proc + 1) //
    nproc)`` of a leaf of s0 rows (a scalar on process 0).  Returns
    (manifest, {"<name>::<proc>": (index, numpy bits, dtype name)})."""
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "n_processes": nproc}
    shards = {}
    for name, leaf in _flatten(tree):
        shape = list(leaf.shape) if hasattr(leaf, "shape") else \
            list(np.shape(leaf))
        manifest["leaves"].append({"name": name, "shape": shape,
                                   "dtype": _dtype_name(leaf),
                                   "spec": None})
        if not shape:
            if proc == 0:
                arr, dtype = _host_copy(leaf)
                shards[f"{name}::{proc}"] = ([], arr, dtype)
            continue
        lo, hi = (shape[0] * proc // nproc, shape[0] * (proc + 1) // nproc)
        if hi == lo:
            continue
        arr, dtype = _host_copy(leaf[lo:hi])
        index = [[lo, hi]] + [[0, s] for s in shape[1:]]
        shards[f"{name}::{proc}"] = (index, arr, dtype)
    return manifest, shards


def _agreed(group, what: str, fn) -> None:
    """Run ``fn`` on this rank, then agree with the group's other ranks
    on whether every rank's ``fn`` succeeded: this rank's own error is
    raised here, another rank's as an ``OSError`` naming the stage."""
    err = None
    try:
        fn()
    except BaseException as e:    # agreed on first, raised below
        err = e
    flag = torch.tensor([int(err is not None)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if err is not None:
        raise err
    if int(flag):
        raise OSError(f"checkpoint {what} failed on another rank")


def _write_files(tmp: pathlib.Path, proc: int, shards: dict) -> None:
    payload, index = {}, {}
    for key, (idx, arr, dtype) in shards.items():
        slot = f"a{len(payload)}"
        payload[slot] = arr
        index[key] = {"slot": slot, "index": idx, "dtype": dtype}
    np.savez(tmp / f"shard_p{proc}.npz", **payload)
    (tmp / f"index_p{proc}.json").write_text(json.dumps(index))


def _commit(ckpt_dir, step: int, tmp: pathlib.Path, manifest: dict,
            keep: int, chaos=None) -> None:
    """The manifest, the rename and ``COMMIT``, then retention."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if chaos is not None:
        chaos.fire("ckpt_pre_rename", step)     # .tmp dir, fully written
    shutil.rmtree(d, ignore_errors=True)
    tmp.rename(d)
    if chaos is not None:
        chaos.fire("ckpt_pre_commit", step)     # renamed, no COMMIT yet
    (d / "COMMIT").write_text(str(time.time()))
    parent = pathlib.Path(ckpt_dir)
    steps = sorted((s, p) for p in parent.iterdir()
                   if (s := _step_of(p)) is not None
                   and (p / "COMMIT").exists())
    for _, old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def _write_shards(ckpt_dir, step: int, manifest: dict, shards: dict,
                  keep: int, chaos=None, mesh=None) -> None:
    """Write one checkpoint under the commit protocol; ``chaos`` (a
    ``repro_torch.runtime.ChaosPlan``) fires at the three crash sites.
    Under a mesh of several ranks every rank calls this with its own
    shards, and the ranks agree after each stage."""
    proc, _, group = _writer(mesh)
    tmp = (pathlib.Path(ckpt_dir) / f"step_{step:08d}").with_suffix(".tmp")

    def prepare():
        if chaos is not None:
            chaos.fire("ckpt_io", step)
        if proc == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True, exist_ok=True)

    def write():
        tmp.mkdir(parents=True, exist_ok=True)
        _write_files(tmp, proc, shards)

    def commit():
        if proc == 0:
            _commit(ckpt_dir, step, tmp, manifest, keep, chaos)

    if group is None:
        prepare()
        write()
        commit()
        return
    _agreed(group, "setup", prepare)
    _agreed(group, "write", write)
    _agreed(group, "commit", commit)


def save_checkpoint(ckpt_dir, step: int, tree: Tree, *,
                    extra: Optional[dict] = None, keep: int = 3,
                    chaos=None, mesh=None) -> None:
    """Synchronous save of ``tree`` (tensors on any device, or numpy);
    under ``mesh`` every rank of it calls this with the same tree."""
    proc, nproc, _ = _writer(mesh)
    manifest, shards = _extract_shards(step, tree, extra, proc, nproc)
    _write_shards(ckpt_dir, step, manifest, shards, keep, chaos=chaos,
                  mesh=mesh)


def _check_shardings(template: Tree, shardings) -> None:
    """``shardings`` is None, a mesh, or a tree of meshes shaped like
    ``template``: every leaf replicated over the mesh that exists now."""
    from repro_torch.launch.mesh import Mesh
    if shardings is None or isinstance(shardings, Mesh):
        return
    want = tree_paths(template)
    got = _flatten(shardings)
    if [n for n, _ in got] != want or not all(isinstance(m, Mesh)
                                              for _, m in got):
        raise ValueError(
            "shardings= must be a mesh or a tree of meshes shaped like the "
            "template (the port restores every leaf replicated)")


def restore_checkpoint(ckpt_dir, step: int, template: Tree, *,
                       device=None, shardings=None) -> Tree:
    """Read step ``step`` into ``template``'s structure: its leaves are
    tensors or ``(shape, dtype)`` specs, each restored on ``device`` (the
    card unless told otherwise) with the template's dtype.  Each leaf is
    assembled from whichever saved slices cover it, from every process's
    files.  ``shardings`` (a mesh, or a tree of meshes like the template)
    restores onto the mesh that exists now: each of its ranks reads the
    whole of every leaf onto its own device, whatever number of
    processes wrote the checkpoint."""
    _check_shardings(template, shardings)
    dev = resolve_device(device)
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    by_name: dict[str, list] = {}
    for ifile in sorted(d.glob("index_p*.json")):
        proc = ifile.stem.split("_p")[1]
        index = json.loads(ifile.read_text())
        with np.load(d / f"shard_p{proc}.npz") as payload:
            for key, meta in index.items():
                by_name.setdefault(key.split("::")[0], []).append(
                    (meta["index"], payload[meta["slot"]], meta.get("dtype")))

    out = []
    for name, leaf in _flatten(template):
        entries = by_name.get(name)
        if entries is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        shape, dtype = _leaf_spec(leaf)
        result = np.zeros(shape, entries[0][1].dtype)
        for idx, data, _ in entries:
            lo = [max(a, 0) for a, _ in idx]
            hi = [min(b, s) for (_, b), s in zip(idx, shape)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - o, b - o)
                        for a, b, (o, _) in zip(lo, hi, idx))
            result[tuple(slice(a, b) for a, b in zip(lo, hi))] = data[src]
        stored = entries[0][2] or str(result.dtype)
        out.append(_to_tensor(result, stored).to(device=dev, dtype=dtype))
    return _rebuild(template, iter(out))


class Checkpointer:
    """Snapshot to host memory, then write on a background thread.

    Construction sweeps crash leftovers (``gc_incomplete``).  An error on
    the writer thread is raised on the next ``save_async`` or ``wait``,
    never swallowed.  ``chaos`` threads a fault plan into every write.
    ``last_snapshot_s`` and ``last_write_s`` time the latest save's two
    halves; ``totals`` sums, over every save: the time ``wait`` (and so
    ``save_async``) blocked on the write in flight (``blocked_s``), the
    snapshots (``snapshot_s``), the writer's wall (``write_s``) and its
    thread's CPU time (``write_cpu_s``).

    ``mesh`` makes every save a save of the mesh's ranks, each writing
    its slices; every rank of the mesh then saves the same steps, in the
    same order.  Rank 0 sweeps the crash leftovers."""

    def __init__(self, ckpt_dir, keep: int = 3, *, chaos=None,
                 gc_on_init: bool = True, mesh=None):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.chaos = chaos
        self.mesh = mesh
        self.last_snapshot_s = self.last_write_s = None
        self.totals = {"saves": 0, "blocked_s": 0.0, "snapshot_s": 0.0,
                       "write_s": 0.0, "write_cpu_s": 0.0}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if gc_on_init and _writer(mesh)[0] == 0:
            gc_incomplete(self.ckpt_dir)


    def wait(self):
        """Join the write in flight; raise if it (or the one before)
        failed.  A failed step was never committed."""
        t0 = time.perf_counter()
        self.join()
        self.totals["blocked_s"] += time.perf_counter() - t0
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def join(self):
        """Wait for the write in flight to end, leaving any error of it for
        the next ``wait`` or ``save_async`` to raise."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Tree,
                   extra: Optional[dict] = None):
        self.wait()
        t0 = time.perf_counter()
        proc, nproc, _ = _writer(self.mesh)
        manifest, shards = _extract_shards(step, tree, extra, proc, nproc)
        self.last_snapshot_s = time.perf_counter() - t0
        tot = self.totals
        tot["saves"] += 1
        tot["snapshot_s"] += self.last_snapshot_s

        def work():
            t1, c1 = time.perf_counter(), time.thread_time()
            try:
                _write_shards(self.ckpt_dir, step, manifest, shards,
                              self.keep, chaos=self.chaos, mesh=self.mesh)
                self.last_write_s = time.perf_counter() - t1
            except BaseException as e:   # raised on the next wait()
                self._error = e
            tot["write_s"] += time.perf_counter() - t1
            tot["write_cpu_s"] += time.thread_time() - c1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, template: Tree, *, device=None,
                       shardings=None):
        """(tree, manifest) of the latest committed step, or (None, None)."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None
        tree = restore_checkpoint(self.ckpt_dir, step, template,
                                  device=device, shardings=shardings)
        manifest = json.loads(
            (self.ckpt_dir / f"step_{step:08d}" / "manifest.json")
            .read_text())
        return tree, manifest
