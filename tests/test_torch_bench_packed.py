"""The packed-features benchmark's twin against the reference, and
``one_hot_features``.

``src/repro_torch/benchmarks/reference/BENCH_packed_features.json`` is the
reference's own ``--fast`` record (jax 0.9.0 on the CPU).  The
reference's suite is rerun into a temporary directory and must reproduce
it but for its wall times.  The twin runs ``--fast`` on the CPU and is
held to that record: accuracies within 1.0 pp a cell and 0.5 pp mean
(the limits ``chip_smoke.py`` holds the card to; here they agree
exactly), byte counts and ratios exactly, and its gates.  The features
it trains on are the reference's: its rows and stored parameters come
from the reference's keys, and though r and log c differ by a few float32
roundings (ROADMAP C3) and the rows by a few ulps, no feature differs.
No test writes under ``benchmarks/results`` or
``src/repro_torch/benchmarks/results``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
from benchmarks import bench_packed_features as ref_bench
from repro.core import hashing as ref_hashing
from repro.data.synthetic import make_template_classification
from repro.pipeline import FeaturePipeline as RefPipeline
from repro.pipeline import FeatureSpec as RefSpec
from repro_torch.benchmarks import bench_packed_features as twin
from repro_torch.benchmarks import common
from repro_torch.benchmarks.fig78_linear_svm import dataset
from repro_torch.core import one_hot_features
from repro_torch.pipeline import FeaturePipeline, FeatureSpec

ROOT = common.HERE.parents[2]
TIMES = ("featurize_us",)
# features that differ between the packages at the twin's shapes
FEATURE_MISMATCHES = 0


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def untimed(rec):
    """The record without its wall times."""
    if isinstance(rec, dict):
        return {k: untimed(v) for k, v in rec.items() if k not in TIMES}
    return rec


def results_state():
    return {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS)
        for p in d.rglob("*")}


def test_reference_reproduces_its_record(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_common, "RESULTS", tmp_path)
    ref_bench.run(fast=True)
    got = json.loads((tmp_path / "BENCH_packed_features.json").read_text())
    assert untimed(got) == untimed(common.load_reference(twin.RECORDS[0]))


def test_twin_fast_matches_the_reference_record(tmp_path):
    before = results_state()
    records = twin.run(fast=True, device="cpu", out=tmp_path)
    rec = records[twin.RECORDS[0]]
    ref = common.load_reference(twin.RECORDS[0])
    assert json.loads((tmp_path / "BENCH_packed_features.json")
                      .read_text()) == common.as_json(rec)
    assert rec["device"] == "cpu" and rec["fast"] is True
    # the reference's keys, sizes, bytes and ratios exactly
    assert set(rec) - set(ref) == {"packed_b8_bit_identical", "device",
                                   "draws", "fast"}
    assert (rec["k"], rec["n_test"], rec["steps"]) == (
        ref["k"], ref["n_test"], ref["steps"])
    for b, row in ref["per_b"].items():
        for key in ("feature_bytes", "model_bytes",
                    "modeled_bandwidth_reduction"):
            assert rec["per_b"][b][key] == row[key], (b, key)
    cells = twin.reference_cells(records)
    diffs = [abs(a - g) for _, a, g in cells]
    assert len(cells) == 5
    assert max(diffs) <= 1.0 and sum(diffs) / len(diffs) <= 0.5, cells
    claims = twin.check_claims(records)
    assert len(claims) == 6 and all(claims.values())
    assert rec["packed_b8_bit_identical"] is True
    assert twin.launches(records) == {"cws_encode": 64,
                                      "cws_encode_packed": 256}
    assert results_state() == before


def test_features_match_the_reference():
    """Every pipeline of the sweep, train and test rows: the twin's
    features against the reference's on the reference's own rows."""
    ds = dataset()
    ref_ds = make_template_classification(
        1, n_classes=10, density=0.15, mult_noise=1.2, spike_prob=0.08,
        name="template-hard")
    dim = ds.x_train.shape[1]
    params = twin.params_for(dim, torch.device("cpu"))
    mismatches = 0
    for b, packed in ((8, False),) + tuple((b, True) for b in twin.BS):
        ref_pipe = RefPipeline.create(jax.random.PRNGKey(0), dim,
                                      RefSpec(twin.K, b_i=b, packed=packed))
        pipe = FeaturePipeline(params, FeatureSpec(twin.K, b_i=b,
                                                   packed=packed))
        for x, ref_x in ((ds.x_train, ref_ds.x_train),
                         (ds.x_test, ref_ds.x_test)):
            want = np.asarray(ref_pipe.features(jnp.asarray(ref_x)))
            got = pipe.features(torch.from_numpy(x)).numpy()
            assert got.shape == want.shape
            mismatches += int((got.view(np.int32)
                               != want.view(np.int32)).sum())
    assert mismatches == FEATURE_MISMATCHES


def test_claims_refuse_a_gap_and_unequal_tables():
    rec = json.loads(json.dumps(common.load_reference(twin.RECORDS[0])))
    rec.update(packed_b8_bit_identical=True, fast=False)
    records = {twin.RECORDS[0]: rec}
    assert all(twin.claims(records).values())
    rec["per_b"]["8"]["accuracy_gap_pp"] = 0.625
    rec["per_b"]["4"]["modeled_bandwidth_reduction"] = 4.0
    rec["packed_b8_bit_identical"] = False
    assert not any(twin.claims(records).values())
    rec.update(fast=True)
    rec["per_b"]["2"]["accuracy"] += 0.0125
    failed = [c for c, ok in twin.claims(records).items() if not ok]
    assert len(failed) == 5 and "a cell" in " ".join(failed)
    with pytest.raises(AssertionError, match="packed_features"):
        twin.check_claims(records)


@pytest.mark.parametrize("b_i,b_t", [(1, 0), (2, 1), (4, 0), (3, 2)])
def test_one_hot_features_match_the_reference(b_i, b_t):
    rng = np.random.default_rng(b_i * 10 + b_t)
    codes = rng.integers(-1, 1 << (b_i + b_t), (7, 9)).astype(np.int32)
    want = np.asarray(ref_hashing.one_hot_features(jnp.asarray(codes),
                                                   b_i=b_i, b_t=b_t))
    got = one_hot_features(torch.from_numpy(codes), b_i=b_i, b_t=b_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) == codes.shape[1]).all()
