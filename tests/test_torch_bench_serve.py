"""The serving benchmark's twin against the reference.

``src/repro_torch/benchmarks/reference/BENCH_serve.json`` is the
reference's own ``--fast`` record (jax 0.9.0 on the CPU).  The
reference's suite is rerun into a temporary directory and must reproduce
its sizes and counts; its latencies, batch counts and pad rows depend on
timing and are not compared.  The twin runs ``--fast`` on the CPU and must
pass its gates (every bucket warmed once, dispatched rows = submitted
rows) with the reference's request, row and compile counts.  Each mode's
served features equal the reference's exactly, and its logits agree
within float32 sums in another order (the packed scores of the reference
differ from its own offline ones by ~2e-6, ROADMAP C).  No test writes
under ``benchmarks/results`` or ``src/repro_torch/benchmarks/results``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
from benchmarks import bench_serve as ref_bench
from repro_torch.benchmarks import bench_serve as twin
from repro_torch.benchmarks import common

ROOT = common.HERE.parents[2]
SIZES = ("buckets", "dim", "num_hashes", "n_classes", "requests_per_mode",
         "max_rows")
COUNTS = ("requests", "rows", "compile_count")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_reference_reproduces_its_record(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_common, "RESULTS", tmp_path)
    ref_bench.run(fast=True)
    got = json.loads((tmp_path / "BENCH_serve.json").read_text())
    want = common.load_reference(twin.RECORDS[0])
    assert {k: got[k] for k in SIZES} == {k: want[k] for k in SIZES}
    for mode, row in want["modes"].items():
        assert {c: got["modes"][mode][c] for c in COUNTS} == {
            c: row[c] for c in COUNTS}


def test_twin_fast_passes_its_gates(tmp_path):
    before = {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS) for p in d.iterdir()}
    records = twin.run(fast=True, device="cpu", out=tmp_path)
    rec = records[twin.RECORDS[0]]
    ref = common.load_reference(twin.RECORDS[0])
    assert {k: rec[k] for k in SIZES} == {k: ref[k] for k in SIZES}
    assert rec["device"] == "cpu" and rec["fast"] is True
    for mode in twin.MODES:
        r = rec["modes"][mode]
        assert set(r) == set(ref["modes"][mode])
        assert {c: r[c] for c in COUNTS} == {c: ref["modes"][mode][c]
                                             for c in COUNTS}
        assert r["p50_ms"] <= r["p99_ms"] <= r["max_ms"]
        assert set(r["buckets"]) <= {str(b) for b in twin.BUCKETS}
    claims = twin.check_claims(records)
    assert len(claims) == 7 and all(claims.values())
    launches = twin.launches(records)
    assert set(launches) == {"cws_encode", "cws_encode_rng",
                             "cws_encode_rng_packed"}
    assert all(v >= 3 + 1 for v in launches.values())
    assert json.loads((tmp_path / "BENCH_serve.json").read_text())[
        "modes"]["packed"]["rows"] == rec["modes"]["packed"]["rows"]
    after = {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS) for p in d.iterdir()}
    assert after == before


@pytest.mark.parametrize("mode", twin.MODES)
def test_served_features_and_logits_match_the_reference(mode):
    """The first requests of the stream through each mode's service:
    features exactly, logits within 1e-5 relative / 1e-5 absolute."""
    reqs = twin.requests(6)
    want_reqs = []
    rng = np.random.default_rng(7)      # the reference's own loop
    for m in rng.integers(1, twin.MAX_ROWS + 1, 6):
        x = np.abs(rng.standard_normal((int(m), twin.DIM))).astype(
            np.float32)
        want_reqs.append(x * (rng.random((int(m), twin.DIM)) < 0.3))
    for a, b in zip(reqs, want_reqs):
        np.testing.assert_array_equal(a, b)

    ref_svc = ref_bench.make_service(mode)
    pipe = twin.make_pipeline(mode, torch.device("cpu"))
    from repro_torch.serving import ServingService
    svc = ServingService(twin.make_weights(pipe), pipe, buckets=twin.BUCKETS)
    try:
        np.testing.assert_array_equal(
            twin.make_weights(pipe).w.numpy(),
            np.asarray(ref_svc.runner.params.w))
        for x in reqs:
            want_f = np.asarray(ref_svc.runner.pipe.features(jnp.asarray(x)))
            got_f = pipe.features(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got_f.view(np.int32),
                                          want_f.view(np.int32))
            np.testing.assert_allclose(svc.score(x), ref_svc.score(x),
                                       rtol=1e-5, atol=1e-5)
        assert svc.stats()["compile_count"] == len(twin.BUCKETS)
    finally:
        svc.stop()
        ref_svc.stop()
