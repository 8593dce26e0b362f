"""The fault-tolerance benchmark's twin against the reference.

``src/repro_torch/benchmarks/reference/bench_fault_tolerance.json`` is
the reference's own ``--fast`` record (jax 0.9.0 on the CPU).  The
reference's suite is rerun here into a temporary directory and must
reproduce its sizes and resume numbers exactly (its times vary run to
run).  The twin runs ``--fast`` on the CPU and must pass its four gates
against that record: bit-identical params after kill + resume, a resume
gap of exactly 0.0 pp, resumed from the reference's step (30), and the
clean accuracy within 1.0 pp of the reference's.  No test writes under
``benchmarks/results`` or ``src/repro_torch/benchmarks/results``.
"""
import json

import pytest
import torch

import benchmarks.common as ref_common
from benchmarks import bench_fault_tolerance as ref_bench
from repro_torch.benchmarks import bench_fault_tolerance, common

ROOT = common.HERE.parents[2]
TIMES = {"async_ckpt", "io"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def untimed(rec):
    """The record without its wall times."""
    out = {k: v for k, v in rec.items() if k not in TIMES}
    out["resume"] = {k: v for k, v in rec["resume"].items()
                     if k != "resume_wall_s"}
    return out


def test_reference_reproduces_its_record(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_common, "RESULTS", tmp_path)
    ref_bench.run(fast=True)
    got = json.loads((tmp_path / "BENCH_fault_tolerance.json").read_text())
    want = common.load_reference(bench_fault_tolerance.REFERENCE)
    assert untimed(got) == untimed(want)
    assert got["io"]["checkpoint_bytes"] == want["io"]["checkpoint_bytes"]


def test_twin_fast_passes_its_gates(tmp_path):
    before = {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS) for p in d.iterdir()}
    records = bench_fault_tolerance.run(fast=True, device="cpu",
                                        out=tmp_path)
    claims = bench_fault_tolerance.check_claims(records)
    assert len(claims) == 5 and all(claims.values())
    rec = records[bench_fault_tolerance.RECORDS[0]]
    ref = common.load_reference(bench_fault_tolerance.REFERENCE)
    # the reference's keys, sizes and resume step, exactly
    assert rec["config"] == ref["config"]
    assert set(rec["io"]) >= set(ref["io"])
    assert set(rec["async_ckpt"]) == set(ref["async_ckpt"])
    assert set(rec["resume"]) == set(ref["resume"])
    split = rec["async_split"]     # the overhead taken apart
    assert split["saves"] == rec["config"]["steps"] // rec["config"][
        "ckpt_every"]
    assert set(split) == {"saves", "blocked_ms", "snapshot_ms", "write_ms",
                          "write_cpu_ms", "main_cpu_ms_bare",
                          "main_cpu_ms_ckpt"}
    assert all(v >= 0 for v in split.values())
    assert rec["io"]["checkpoint_bytes"] == ref["io"]["checkpoint_bytes"]
    assert rec["resume"]["resumed_from_step"] == 30
    assert rec["resume"]["resume_gap_pp"] == 0.0
    assert rec["resume"]["bit_identical_params"] is True
    assert abs(rec["resume"]["acc_clean"] - ref["resume"]["acc_clean"]) \
        <= 0.01
    assert json.loads((tmp_path / "BENCH_fault_tolerance.json")
                      .read_text())["resume"] == rec["resume"]
    after = {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS) for p in d.iterdir()}
    assert after == before


def test_claims_refuse_a_gap_and_a_wrong_step():
    rec = json.loads(json.dumps(common.load_reference(
        bench_fault_tolerance.REFERENCE)))
    records = {bench_fault_tolerance.RECORDS[0]: rec}
    assert all(bench_fault_tolerance.claims(records).values())
    rec["resume"]["resume_gap_pp"] = 0.125
    rec["resume"]["resumed_from_step"] = 20
    rec["resume"]["acc_clean"] += 0.02
    failed = [c for c, ok in bench_fault_tolerance.claims(records).items()
              if not ok]
    assert len(failed) == 4
    with pytest.raises(AssertionError, match="fault_tolerance"):
        bench_fault_tolerance.check_claims(records)
