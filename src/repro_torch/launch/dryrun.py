"""Multi-pod dry run: every (arch x input-shape x mesh) cell built and run
once on the ``meta`` device, at one rank's shards (port of
``repro.launch.dryrun``).

For each cell, at rank 0 and at the mesh's last rank, this:
  1. starts a ``fake`` process group of 256 ranks (512 with
     ``--multipod``) at that rank: no data moves, and each collective of
     ``launch.collectives`` counts itself and returns ``meta`` tensors;
  2. builds the production mesh (16 x 16, or 2 x 16 x 16), the rules and
     the cell's step from ``input_specs``: ``init_train_state(rules=,
     device="meta")`` and ``make_train_step`` for train,
     ``init_model(keep=)`` and ``init_caches(rules=, long=)`` with
     ``make_serve_steps`` for prefill and decode, every tensor this
     rank's shard;
  3. runs the step once on ``meta`` under ``launch.hlo_analysis``'s
     counter (rows 8 and 9 take their ``meta`` route), then destroys the
     group;
  4. writes the rank's parameter, optimizer-state, cache and input bytes,
     the step's ``dot_flops``, ``bytes_accessed`` and collectives by kind,
     the formulas' ``params`` / ``active_params`` beside the counted
     leaves, and the seconds of the build and of the step, to
     ``src/repro_torch/benchmarks/results/dryrun/<arch>__<shape>__<mesh>
     .json``.

Repeated work: a train step of N > 2 microbatches (``N_MICRO``, or on a
rank with fewer rows the step's own ``microbatch_count``) is run at
one and at two microbatches of the same size, and the counts taken as
``(2 - N) c1 + (N - 1) c2``: the microbatches repeat the same work and
the rest of the step runs once (``tests/test_torch_dryrun.py`` holds the
extrapolation to the full count).

Not reported, unlike the reference: its ``temp_bytes`` and
``peak_est_bytes`` come from XLA's buffer assignment, and ``meta``
tensors have no allocator to ask; its ``cost_analysis`` and loop trips
are HLO's.  Its ``--reanalyze`` re-reads cached HLO text, which the port
does not have, so that option is not ported.

Usage:
  python -m repro_torch.launch.dryrun --all                # 1 pod
  python -m repro_torch.launch.dryrun --all --multipod     # 2 pods
  python -m repro_torch.launch.dryrun --arch gemma3_12b --shape train_4k
  python -m repro_torch.launch.dryrun --table [--multipod]  # the records
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_caches, init_model
from repro_torch.models.sharding import (make_rules, named_leaves,
                                         shard_bounds, shard_of, spec_at)
from repro_torch.training.trainer import (TrainHparams, init_train_state,
                                          input_specs, make_serve_steps,
                                          make_train_step,
                                          microbatch_count, param_pspecs)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[1] / \
    "benchmarks" / "results" / "dryrun"

# per-arch microbatching for the train_4k cell (memory policy, DESIGN.md §5)
N_MICRO = {
    "nemotron_4_340b": 16,
    "llama4_maverick_400b_a17b": 8,
    "granite_34b": 4,
    "gemma3_12b": 2,
    "pixtral_12b": 2,
    "starcoder2_7b": 2,
    "musicgen_large": 1,
    "olmoe_1b_7b": 4,
    "mamba2_780m": 1,
    "recurrentgemma_2b": 1,
}


# attention on rows 8 and 9, as the port's main path runs it on the card
# (the configs' default, the plain chunked route, would run its blocks op
# by op on meta)
DEFAULT_OVERRIDES = {"attn_impl": "flash"}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    """A ``fake`` default process group of ``world`` ranks at ``rank`` for
    the block (none may exist already), destroyed after it."""
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    return sum(_nbytes(t) for _, t in named_leaves(tree))


def _local(spec_in, mesh) -> torch.Tensor:
    """A ``meta`` tensor of this rank's shard of an ``InputSpec``."""
    size = [hi - lo for lo, hi in shard_bounds(spec_in.shape, spec_in.spec,
                                                mesh)]
    return torch.empty(size, dtype=spec_in.dtype, device="meta")


def _keep(specs, mesh):
    return lambda path, t: shard_of(t, mesh, spec_at(specs, path)).clone()


def _counted_leaves(cfg) -> int:
    return sum(t.numel() for _, t in named_leaves(init_model(cfg,
                                                             device="meta")))


def _rows(batch: dict, rows: int) -> dict:
    return {k: v[:rows] for k, v in batch.items()}


def train_stats(cfg, hp, rules, state, batch: dict):
    """The train step's ``GraphStats`` on ``batch`` (this rank's rows) at
    the step's own count N, ``microbatch_count(rows,
    hp.n_microbatches)``: for N > 2 the step at one and at two
    microbatches of the same size, extrapolated (module docstring)."""
    rows = batch["inputs"].shape[0]
    n = microbatch_count(rows, hp.n_microbatches)
    if n <= 2:
        return hlo_analysis.analyze(make_train_step(cfg, hp, rules), state,
                                    batch)[1]
    counts = [hlo_analysis.analyze(
        make_train_step(cfg, dataclasses.replace(hp, n_microbatches=k),
                        rules), state, _rows(batch, k * rows // n))[1]
        for k in (1, 2)]
    return counts[0].combine(counts[1], 2 - n, n - 1)


def build(cfg, hp, rules, *, kind: str, seq_len: int, global_batch: int,
          long: bool = False):
    """This rank's tensors of a cell on ``meta`` under ``rules`` (a mesh
    in a process group): (bytes by part, the parameters, the train state
    or the caches, this rank's inputs)."""
    mesh = rules.mesh
    ins = input_specs(cfg, rules, shape=kind, seq_len=seq_len,
                      global_batch=global_batch)
    local = {k: _local(s, mesh) for k, s in ins.items()}
    memory = {"input_bytes": sum(_nbytes(t) for t in local.values())}
    if kind == "train":
        held = init_train_state(cfg, hp, device="meta", rules=rules)
        params = held.params
        memory.update(
            param_bytes=tree_bytes(held.params),
            mu_bytes=tree_bytes(held.mu), nu_bytes=tree_bytes(held.nu),
            step_bytes=tree_bytes(held.step),
            ef_residual_bytes=tree_bytes(held.ef_residual or {}),
            cache_bytes=0)
    else:
        params = init_model(cfg, device="meta",
                            keep=_keep(param_pspecs(cfg, rules), mesh))
        held = init_caches(cfg, global_batch, seq_len, long=long,
                           rules=rules, device="meta")
        memory.update(param_bytes=tree_bytes(params), mu_bytes=0,
                      nu_bytes=0, step_bytes=0, ef_residual_bytes=0,
                      cache_bytes=tree_bytes(tuple(held)))
    memory["state_bytes"] = sum(memory[k] for k in (
        "param_bytes", "mu_bytes", "nu_bytes", "step_bytes",
        "ef_residual_bytes"))
    return memory, params, held, local


def shard_bytes(archs, *, multi_pod: bool, rank: int) -> dict:
    """{arch: {shape: bytes by part}} at ``rank`` of the production mesh
    for every cell of ``archs`` (``build`` alone, in one fake group)."""
    out = {}
    with fake_group(512 if multi_pod else 256, rank):
        rules = make_rules(Mesh(production_shape(multi_pod)))
        for arch in archs:
            cfg = cell_config(arch)
            for a, shape in cells():
                if a != arch:
                    continue
                seq_len, global_batch, kind = SHAPES[shape]
                out.setdefault(arch, {})[shape] = build(
                    cfg, cell_hparams(arch, kind), rules, kind=kind,
                    seq_len=seq_len, global_batch=global_batch,
                    long=shape.startswith("long"))[0]
    return out


def production_shape(multi_pod: bool) -> dict:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def cell_hparams(arch: str, kind: str) -> TrainHparams:
    return TrainHparams(n_microbatches=N_MICRO.get(arch, 1)
                        if kind == "train" else 1)


def dry_cell(cfg, hp, mesh_shape: dict, rank: int, *, kind: str,
             seq_len: int, global_batch: int, long: bool = False) -> dict:
    """One step of ``kind`` ("train", "prefill" or "decode") of ``cfg`` on
    ``meta`` at ``rank`` of a mesh of ``mesh_shape`` ({axis: size}), in a
    ``fake`` group of as many ranks started and destroyed here: this
    rank's bytes by part, the step's ``GraphStats`` (``"graph"``), and
    the seconds of the build and of the step."""
    world = 1
    for n in mesh_shape.values():
        world *= n
    with fake_group(world, rank):
        t0 = time.time()
        mesh = Mesh(mesh_shape)
        rules = make_rules(mesh)
        memory, params, held, local = build(cfg, hp, rules, kind=kind,
                                            seq_len=seq_len,
                                            global_batch=global_batch,
                                            long=long)
        out = {"rank": rank, "memory": memory, "build_s": time.time() - t0}
        t1 = time.time()
        if kind == "train":
            out["rank_microbatches"] = microbatch_count(
                local["inputs"].shape[0], hp.n_microbatches)
            out["graph"] = train_stats(cfg, hp, rules, held, local)
        else:
            prefill_step, decode_one = make_serve_steps(cfg, rules)
            with torch.no_grad():
                if kind == "prefill":
                    _, out["graph"] = hlo_analysis.analyze(
                        prefill_step, params, local["inputs"], held)
                else:
                    _, out["graph"] = hlo_analysis.analyze(
                        decode_one, params, local["tokens"],
                        torch.tensor(seq_len - 1, dtype=torch.int32), held)
        out["step_s"] = time.time() - t1
    return out


def cell_config(arch: str, overrides: dict | None = None):
    return dataclasses.replace(get_config(arch, "full"),
                               **{**DEFAULT_OVERRIDES, **(overrides or {})})


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, rank: int = 0) -> dict:
    """One cell of the production mesh at ``rank`` (``dry_cell``)."""
    cfg = cell_config(arch, overrides)
    seq_len, global_batch, kind = SHAPES[shape_name]
    hp = cell_hparams(arch, kind)
    out = dry_cell(cfg, hp, production_shape(multi_pod), rank, kind=kind,
                   seq_len=seq_len, global_batch=global_batch,
                   long=shape_name.startswith("long"))
    out["graph"] = out["graph"].as_dict()
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "mesh": mesh_name(multi_pod),
        "n_devices": 512 if multi_pod else 256,
        "seq_len": seq_len,
        "global_batch": global_batch,
        "n_microbatches": hp.n_microbatches,
        "attn_impl": cfg.attn_impl,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "counted_params": _counted_leaves(cfg),
        **out,
    }


def run_cell_ranks(arch: str, shape_name: str, *, multi_pod: bool,
                   overrides: dict | None = None) -> dict:
    """``run_cell`` at rank 0 and at the last rank, in one record."""
    world = 512 if multi_pod else 256
    per = [run_cell(arch, shape_name, multi_pod=multi_pod,
                    overrides=overrides, rank=r) for r in (0, world - 1)]
    keys = ("rank", "memory", "build_s", "step_s", "graph")
    res = {k: v for k, v in per[0].items() if k not in keys}
    res["ranks"] = {str(p["rank"]): {k: p[k] for k in keys[1:]}
                    for p in per}
    return res


def table(out_dir, multi_pod: bool) -> str:
    """The records of ``out_dir`` for one mesh as a markdown table, one
    row a cell at rank 0: state + cache GB, step TFLOP, collective GB and
    calls, seconds of the step on meta."""
    rows = ["| arch | shape | state + cache GB | dot TFLOP | collective GB "
            "| collectives | step s |", "|---|---|---|---|---|---|---|"]
    for arch, shape in cells():
        path = pathlib.Path(out_dir) / \
            f"{arch}__{shape}__{mesh_name(multi_pod)}.json"
        if not path.exists():
            rows.append(f"| {arch} | {shape} | failed | | | | |")
            continue
        r0 = json.loads(path.read_text())["ranks"]["0"]
        mem, g = r0["memory"], r0["graph"]
        rows.append(
            f"| {arch} | {shape} | "
            f"{(mem['state_bytes'] + mem['cache_bytes']) / 1e9:.3f} | "
            f"{g['dot_flops'] / 1e12:.2f} | "
            f"{g['total_collective_bytes'] / 1e9:.2f} | "
            f"{sum(g['n_collectives'].values()):,} | {r0['step_s']:.1f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--table", action="store_true",
                    help="print the records of --out as a table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out, args.multipod))
        return

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("give --all, or --arch and --shape")
        todo = [(args.arch, args.shape)]
    mp = args.multipod

    failures = []
    for arch, shape in todo:
        tag = f"{arch}__{shape}__{mesh_name(mp)}"
        out_path = out_dir / f"{tag}.json"
        if out_path.exists() and not args.force:
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[run ] {tag} ...", flush=True)
        try:
            res = run_cell_ranks(arch, shape, multi_pod=mp)
            out_path.write_text(json.dumps(res, indent=1) + "\n")
            r0 = res["ranks"]["0"]
            mem = r0["memory"]
            print(f"[ ok ] {tag}: state+cache/rank="
                  f"{(mem['state_bytes'] + mem['cache_bytes']) / 1e9:.3f} GB"
                  f" flops/rank={r0['graph']['dot_flops']:.3e} "
                  f"coll={r0['graph']['total_collective_bytes']:.3e}B "
                  f"step={r0['step_s']:.1f}s", flush=True)
        except Exception as e:   # noqa: BLE001 - every cell is reported
            failures.append((tag, repr(e)))
            print(f"[FAIL] {tag}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
