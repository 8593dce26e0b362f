"""Roofline of the dry run's records at the H100's own peaks (port of
``benchmarks/roofline.py``).

For each (arch x shape x mesh) record of ``launch.dryrun``
(``results/dryrun/*.json``), a rank's step against three floors:

    T_comp = dot FLOPs a rank          / PEAK_FLOPS   (1,070.5 TFLOP/s bf16)
    T_mem  = bytes accessed a rank     / HBM_BW       (3.35 TB/s)
    T_coll = collective bytes a rank   / LINK_BW      (50 GB/s a card)

with the model's FLOPs (``model_flops``: 6 N B S + 3 x attention for a
train step, 2 N B S + attention for a prefill, 2 N B for a decode token;
N the active parameters), the useful ratio model FLOPs / counted FLOPs,
the dominant term, and the roofline fraction: the workload's ideal time
(``ideal_time``) over the largest term.  ``model_flops(cfg, kind, batch,
seq)`` is the same formula on a config, for a share of a measured step:
``chip_smoke.py`` divides it by the step's seconds and ``peak_flops``.

The constants are one H100 SXM's:
  * ``PEAK_FLOPS``: 132 SMs x 4,096 dense bf16 tensor-core flops an SM
    clock x 1,980 MHz, the card's maximum SM clock: the peak the kernel
    bounds of ``PERF.md`` use.  ``peak_flops(sms, mhz)`` gives it for a
    card that reads otherwise (``nvidia-smi`` and
    ``torch.cuda.get_device_properties``).
  * ``HBM_BW``: 3.35e12 B/s, the H100 SXM's HBM3 rate.
  * ``LINK_BW``: 50e9 B/s a card, one InfiniBand NDR port (400 Gb/s) a
    card as in a DGX H100.  Every axis of the 16 x 16 and 2 x 16 x 16
    meshes has at least 16 ranks, so a ring over it spans two 8-card
    NVLink nodes and its InfiniBand hop paces it; NVLink's 450 GB/s a
    direction does not apply to these meshes.  The records give
    collective bytes by kind and calls by axes, not bytes by axis, so
    every byte is taken at this rate.

Where the port's records differ from the reference's, so does this:
  * the terms are a rank's counts (``launch.hlo_analysis``: matmuls and
    rows 8-9 as dispatched, each once; no loop trips); where the recorded
    ranks differ (a causal sequence split puts more keys on the last
    rank), each term takes the slower rank, which paces the step, and the
    useful ratio the ranks' mean times the devices;
  * a decode's ideal time reads the record's cache bytes a rank in place
    of the reference's ``argument_bytes * 0.5``;
  * ``state_GiB`` (a rank's state + cache + input bytes) replaces the
    reference's ``peak_mem_GiB``: the ``meta`` device has no peak;
  * the reference's peeling clamp (counted FLOPs above 4x the model's
    are cut to that, bytes and collectives scaled alike) is kept and
    reported as ``peeling_clamped``.  The port peels no loop, so here it
    marks a cell whose counted FLOPs exceed 4x the model's: decode steps
    (attention over the whole cache, which 2 N B leaves out) and mamba2's
    prefill (every ``in_proj`` column projected on every rank).

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only roofline
"""
from __future__ import annotations

import json
import math
import pathlib

from repro_torch.benchmarks.common import check, save_json

USES_DEVICE = False      # reads records; no tensor work

RECORDS = ("roofline",)
DRYRUN = pathlib.Path(__file__).resolve().parent / "results" / "dryrun"
RESULTS_FILE = DRYRUN.parent / "roofline.json"

TENSOR_FLOPS_PER_SM_CLK = 4096   # dense bf16, one Hopper SM, one clock
H100_SMS, H100_MAX_MHZ = 132, 1980


def peak_flops(sms: int = H100_SMS, mhz: float = H100_MAX_MHZ) -> float:
    """Dense bf16 tensor-core FLOP/s of a card of ``sms`` SMs at ``mhz``."""
    return sms * TENSOR_FLOPS_PER_SM_CLK * mhz * 1e6


PEAK_FLOPS = peak_flops()   # 1.0705e15: 132 x 4,096 x 1,980 MHz
HBM_BW = 3.35e12            # B/s: H100 SXM HBM3
LINK_BW = 50e9              # B/s a card: InfiniBand NDR 400 Gb/s


def attention_flops(cfg, batch: int, seq: int) -> float:
    """Attention's QK^T and PV FLOPs of one forward over ``batch`` x
    ``seq`` tokens, which 2 N tokens leaves out: a causal layer's query
    sees ~seq / 2 keys, a windowed layer's min(window, seq)."""
    total = 0.0
    for kind in cfg.block_pattern:
        if kind not in ("attn", "local"):
            continue
        window = cfg.window if kind == "local" else 0
        eff = min(window, seq) if window else seq
        kv_per_q = eff / 2 if not window else eff
        total += 2 * 2 * batch * seq * kv_per_q * cfg.n_heads * cfg.head_dim_
    return total * cfg.n_units


def model_flops_parts(cfg, kind: str, batch: int, seq: int,
                      n_active: int | None = None) -> tuple[float, float]:
    """The model's FLOPs of one step of ``kind`` ("train", "prefill" or
    "decode") over ``batch`` sequences of ``seq`` tokens, and the
    attention term's part of them: 6 N B S plus 3x the attention term for
    train (forward and backward), 2 N B S plus the term for a prefill,
    2 N B for a decode token; N = ``n_active``, by default
    ``cfg.active_param_count()``."""
    if n_active is None:
        n_active = cfg.active_param_count()
    if kind == "decode":
        return 2.0 * n_active * batch, 0.0
    if kind not in ("train", "prefill"):
        raise ValueError(f"kind {kind!r}: train, prefill or decode")
    attn = attention_flops(cfg, batch, seq)
    if kind == "train":
        return 6.0 * n_active * batch * seq + 3.0 * attn, 3.0 * attn
    return 2.0 * n_active * batch * seq + attn, attn


def model_flops(cfg, kind: str, batch: int, seq: int,
                n_active: int | None = None) -> float:
    """The total of ``model_flops_parts``."""
    return model_flops_parts(cfg, kind, batch, seq, n_active)[0]


def _record_config(rec):
    from repro_torch.configs import get_config
    return get_config(rec["arch"], "full")


def record_attention_flops(rec) -> float:
    return attention_flops(_record_config(rec), rec["global_batch"],
                           rec["seq_len"])


def record_model_flops(rec) -> float:
    """``model_flops`` of a dry-run record: its active parameters, its
    global batch and sequence, its arch's full config's attention."""
    return model_flops(_record_config(rec), rec["kind"], rec["global_batch"],
                       rec["seq_len"], n_active=rec["active_params"])


def _worst(rec, part: str, key: str) -> float:
    return max(float(r[part][key]) for r in rec["ranks"].values())


def ideal_time(rec) -> float:
    """The workload's floor a card: train and prefill compute-bound,
    model FLOPs / devices / PEAK_FLOPS; decode weight-streaming, the
    active parameters' bf16 bytes a device plus the cache bytes a rank
    over HBM_BW."""
    n_dev = rec["n_devices"]
    if rec["kind"] != "decode":
        return record_model_flops(rec) / n_dev / PEAK_FLOPS
    param_bytes = rec["active_params"] * 2 / n_dev
    return (param_bytes + _worst(rec, "memory", "cache_bytes")) / HBM_BW


def analyze_record(rec) -> dict:
    n_dev = rec["n_devices"]
    flops_dev = _worst(rec, "graph", "dot_flops")
    bytes_dev = _worst(rec, "graph", "bytes_accessed")
    coll_dev = _worst(rec, "graph", "total_collective_bytes")
    ranks = rec["ranks"].values()
    counted = n_dev * sum(r["graph"]["dot_flops"] for r in ranks) / len(ranks)
    mf = record_model_flops(rec)
    flops_cap = 4.0 * mf / n_dev
    peeled = flops_dev > flops_cap
    if peeled:
        scale = flops_cap / flops_dev
        flops_dev, bytes_dev, coll_dev = (flops_cap, bytes_dev * scale,
                                          coll_dev * scale)
        counted *= scale
    t_comp = flops_dev / PEAK_FLOPS
    t_mem = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    t_ideal = ideal_time(rec)
    bound = max(t_comp, t_mem, t_coll)
    dominant = ("compute" if bound == t_comp else
                "memory" if bound == t_mem else "collective")
    state = max(sum(r["memory"][k] for k in
                    ("state_bytes", "cache_bytes", "input_bytes"))
                for r in ranks)
    return {
        "cell": f"{rec['arch']}/{rec['shape']}",
        "mesh": rec["mesh"],
        "kind": rec["kind"],
        "T_comp_s": t_comp,
        "T_mem_s": t_mem,
        "T_coll_s": t_coll,
        "T_ideal_s": t_ideal,
        "dominant": dominant,
        "MODEL_FLOPS": mf,
        "attention_flops": record_attention_flops(rec),
        "useful_ratio": min(mf / max(counted, 1.0), 9.99),
        "roofline_fraction": t_ideal / max(bound, 1e-12),
        "state_GiB": state / 2 ** 30,
        "peeling_clamped": peeled,
    }


NOTES = {
    "compute": "dominant=compute: close the useful-ratio gap (remat "
               "recompute + non-GEMM ops); raise per-card batch.",
    "memory": "dominant=memory: fuse/shrink materialized intermediates, "
              "bigger microbatches amortize weight reads.",
    "collective": "dominant=collective: reshard to cut FSDP gathers "
                  "(fewer microbatches), overlap collectives with compute.",
}


def analyze(mesh: str | None = None) -> list:
    """``analyze_record`` of every dry-run record (of one ``mesh`` if
    given), sorted by mesh and cell."""
    rows = []
    for f in sorted(DRYRUN.glob("*.json")):
        rec = json.loads(f.read_text())
        if mesh and rec["mesh"] != mesh:
            continue
        rows.append(analyze_record(rec))
    rows.sort(key=lambda r: (r["mesh"], r["cell"]))
    return rows


def constants() -> dict:
    return {"PEAK_FLOPS": PEAK_FLOPS, "HBM_BW": HBM_BW, "LINK_BW": LINK_BW}


def run(fast: bool = False, device=None, out=None) -> dict:
    """Every record's row, printed as CSV and written with the constants
    to ``<out>/roofline.json``.  ``fast`` and ``device`` are the suites'
    arguments; neither changes anything here."""
    rows = analyze()
    print("cell,mesh,T_comp_s,T_mem_s,T_coll_s,dominant,"
          "useful_ratio,roofline_fraction,state_GiB")
    for r in rows:
        print(f"{r['cell']},{r['mesh']},{r['T_comp_s']:.4f},"
              f"{r['T_mem_s']:.4f},{r['T_coll_s']:.4f},{r['dominant']},"
              f"{r['useful_ratio']:.3f},{r['roofline_fraction']:.3f},"
              f"{r['state_GiB']:.2f}")
    record = {"constants": constants(), "rows": rows}
    save_json(RECORDS[0], record, out)
    return {RECORDS[0]: record}


def claims(records: dict) -> dict:
    rows = records[RECORDS[0]]["rows"]
    n_files = len(list(DRYRUN.glob("*.json")))
    times = [r[k] for r in rows for k in
             ("T_comp_s", "T_mem_s", "T_coll_s", "T_ideal_s")]
    return {
        "every dry-run record analyzed": len(rows) == n_files > 0,
        "every time finite and positive":
            all(math.isfinite(t) and t > 0 for t in times),
    }


def check_claims(records: dict) -> dict:
    return check("roofline", claims(records))


def markdown_table(mesh: str = "16x16") -> str:
    """One mesh's rows as markdown."""
    lines = ["| cell | T_comp | T_mem | T_coll | bound | useful | "
             "roofline frac | state GiB | next lever |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in analyze(mesh):
        lines.append(
            f"| {r['cell']}{' (clamped)' if r['peeling_clamped'] else ''} "
            f"| {r['T_comp_s']:.3f}s | {r['T_mem_s']:.3f}s "
            f"| {r['T_coll_s']:.3f}s | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {r['state_GiB']:.1f} | {NOTES[r['dominant']][:60]} |")
    return "\n".join(lines)


if __name__ == "__main__":
    run()
