"""Ring against all-gather sequence-parallel flash attention (twin of
``benchmarks/bench_ring_attention.py``).

Runs both schedules of ``kernels/flash_attention.py`` over ``world``
ranks of one gloo group (``torch.multiprocessing``, one group for both):
the ring (``ring_flash_attention``: TPU row 9, ``flash_attention_step``,
``world`` steps a call) and the all-gather (``sharded_flash_attention``:
row 8, one launch a call).  q, k and v are fp32 (the SIMT bodies), drawn
as the reference draws them: ``normal(prng_key(0))`` and its ``fold_in``
1 and 2, at (b, s, h, g, d) = (1, 512, 4, 2, 32) under ``--fast``, else
(1, 4,096, 8, 2, 64), each rank holding its 1/world of the sequence.

Recorded: the ring's agreement with the all-gather (max |diff|, which
must stay under 1e-3 as in the reference), each schedule's wall time (the
slowest rank's, one untimed call then ``REPEATS``), each rank's launches,
and the reference's analytic per-rank peak K/V bytes at ``ndev =
world``.  On one card the ranks share it, CUDA tensors copied through
the host for gloo: those wall times are not a speed of the ring.
``block`` is the reference's tile size, recorded as the reference ran it;
the port's kernels take no block.  The reference's ``modeled_overlap``
rests on TPU MXU and ICI constants and is not ported (``not_ported``).
"""
from __future__ import annotations

import datetime
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (check, emit, load_reference,
                                           meta, save_json, sync)
from repro_torch.core.regen import fold_in, normal, prng_key
from repro_torch.device import resolve_device

RECORDS = ("BENCH_ring_attention",)
WORLD = 4
WINDOW = 0          # causal, as the reference runs it by default
REPEATS = 3
PARITY_TOL = 1e-3
NOT_PORTED = {"modeled_overlap": (
    "the reference's model of ring steps hidden under compute rests on "
    "nominal TPU MXU and ICI rates (bench_ring_attention.py:35-41); no "
    "such constant stands for the card")}


def shape_for(fast: bool) -> dict:
    b, s, h, g, d, block = ((1, 512, 4, 2, 32, 64) if fast else
                            (1, 4096, 8, 2, 64, 256))
    return {"b": b, "s_q": s, "s_k": s, "h": h, "g": g, "d": d,
            "block": block}


def inputs(shape: dict):
    """(q, k, v) fp32 CPU tensors on the reference's keys."""
    key = prng_key(0)
    b, s, h, g, d = (shape[c] for c in ("b", "s_q", "h", "g", "d"))
    return (normal(key, (b, s, h, d)), normal(fold_in(key, 1), (b, s, g, d)),
            normal(fold_in(key, 2), (b, s, g, d)))


def _timed(dev, fn, repeats):
    """(output, wall us a call) after one untimed call."""
    import torch.distributed as dist
    out = fn()
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) / repeats * 1e6


def _rank(rank, world, init, spec):
    """One rank: both schedules on its shard; rank 0 writes the gathered
    outputs, every rank its report."""
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.collectives import all_gather_dim
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    try:
        mesh = make_mesh(1, world)
        sl = spec["shape"]["s_q"] // world
        q, k, v = (t[:, rank * sl:(rank + 1) * sl].contiguous().to(dev)
                   for t in inputs(spec["shape"]))
        report = {"rank": rank}
        outs = {}
        for name, fn in (
                ("ring", fa.ring_flash_attention),
                ("allgather", fa.sharded_flash_attention)):
            fa.reset_launches()
            sync(dev)
            out, us = _timed(dev, lambda: fn(q, k, v, window=WINDOW,
                                             mesh=mesh),
                             spec["repeats"])
            report[f"wall_us_{name}"] = us
            report[f"launches_{name}"] = {n: c for n, c in
                                          fa.LAUNCHES.items() if c}
            outs[name] = all_gather_dim(out, mesh, ("model",), dim=1)
        outdir = pathlib.Path(spec["outdir"])
        if rank == 0:
            np.savez(outdir / "out.npz", **{n: o.cpu().numpy()
                                            for n, o in outs.items()})
        (outdir / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def schedules(world: int, shape: dict, dev: torch.device, *,
              repeats: int = REPEATS):
    """Spawn ``world`` gloo ranks on ``dev`` running both schedules;
    (the ranks' reports, ring output, all-gather output), the outputs
    gathered to the full (b, s, h, d) on the CPU."""
    import torch.multiprocessing as mp
    if shape["s_q"] % world:
        raise ValueError(f"s = {shape['s_q']} does not divide over "
                         f"{world} ranks")
    with tempfile.TemporaryDirectory(prefix="ring_") as d:
        spec = {"device": str(dev), "shape": shape, "repeats": repeats,
                "outdir": d}
        mp.spawn(_rank, args=(world, f"file://{d}/rendezvous", spec),
                 nprocs=world, join=True)
        reports = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text())
                   for r in range(world)]
        outs = np.load(pathlib.Path(d, "out.npz"))
        return reports, outs["ring"], outs["allgather"]


def run(fast: bool = False, *, device=None, out=None,
        world: int = WORLD) -> dict:
    dev = resolve_device(device)
    shape = shape_for(fast)
    reports, ring, allg = schedules(world, shape, dev)
    parity = float(np.abs(ring - allg).max())
    s, g, d = shape["s_k"], shape["g"], shape["d"]
    kv_shard = s * g * d * 4                      # one of K or V, fp32
    peak_allgather = 2 * kv_shard                 # full K + V a rank
    peak_ring = 2 * 2 * kv_shard // world         # shard x double buffer
    us_ring = max(r["wall_us_ring"] for r in reports)
    us_allg = max(r["wall_us_allgather"] for r in reports)
    rec = {
        "ndev": world, "ring_size": world,
        "shape": {**shape, "window": WINDOW},
        "wall_us_ring": us_ring, "wall_us_allgather": us_allg,
        "parity_max_abs_diff": parity,
        "peak_kv_bytes_allgather": peak_allgather,
        "peak_kv_bytes_ring": peak_ring,
        "kv_bytes_reduction": peak_allgather / peak_ring,
        "ranks_share_one_device": True,    # every rank on ``dev``
        "launches_by_rank": [{n: r[f"launches_{n}"] for n in (
            "ring", "allgather")} for r in reports],
        "measured": ["wall_us_ring", "wall_us_allgather",
                     "parity_max_abs_diff"],
        "modeled": ["peak_kv_bytes_allgather", "peak_kv_bytes_ring",
                    "kv_bytes_reduction"],
        "not_ported": NOT_PORTED,
    }
    rec.update(meta(dev, "jax", fast))
    save_json(RECORDS[0], rec, out)
    emit("ring_attention/ring", us_ring,
         f"all-gather={us_allg:.0f}us (ranks sharing one device: not a "
         f"speed of the ring) per-rank peak K/V "
         f"{peak_ring} vs {peak_allgather} bytes "
         f"({rec['kv_bytes_reduction']:.1f}x) parity {parity:.2e}")
    return {RECORDS[0]: rec}


def claims(records: dict) -> dict:
    """Ring within ``PARITY_TOL`` of the all-gather; at ``--fast`` with
    the reference's rank count, its modelled bytes."""
    rec = records[RECORDS[0]]
    out = {f"ring within {PARITY_TOL:g} of all-gather":
           rec["parity_max_abs_diff"] < PARITY_TOL}
    ref = load_reference(RECORDS[0])
    if rec["fast"] and rec["ndev"] == ref["ndev"]:
        out["per-rank peak K/V bytes equal the reference's"] = all(
            rec[c] == ref[c] for c in ("peak_kv_bytes_allgather",
                                       "peak_kv_bytes_ring",
                                       "kv_bytes_reduction"))
    return out


def check_claims(records: dict) -> dict:
    return check("ring_attention", claims(records))


def launches(records: dict) -> dict:
    """Launches over all ranks: the ring ``world`` steps a call, the
    all-gather one kernel a call, (1 + ``REPEATS``) calls each."""
    world = records[RECORDS[0]]["ndev"]
    calls = world * (1 + REPEATS)
    return {"flash_attention_step": world * calls,
            "flash_attention_fwd": calls}


def rank_launches(records: dict) -> dict:
    """The launches the ranks counted, summed by kernel."""
    total: dict = {}
    for r in records[RECORDS[0]]["launches_by_rank"]:
        for sched in r.values():
            for name, c in sched.items():
                total[name] = total.get(name, 0) + c
    return total
