"""The benchmark twins of Table 2 and Figure 6 against the reference.

``src/repro_torch/benchmarks/reference/*.json`` are the reference's own
``--fast`` records (jax 0.9.0 on the CPU).  The reference's suites are
rerun here with ``benchmarks.common.RESULTS`` pointed at a temporary
directory and must reproduce those files exactly, so the records cannot
drift unseen.  The twins run on the CPU (``device="cpu"``): their hashes
are the reference's integers and their estimators numpy as there, so
only K's float32 sum order can differ, and every number must agree
within 1e-6.  No test writes under ``benchmarks/results`` or
``src/repro_torch/benchmarks/results``.
"""
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
from benchmarks import fig6_tstar_only as ref_fig6
from benchmarks import table2_wordpairs as ref_table2
from repro_torch.benchmarks import common
from repro_torch.benchmarks import fig6_tstar_only
from repro_torch.benchmarks import table2_wordpairs

ROOT = pathlib.Path(__file__).resolve().parents[1]
RESULT_DIRS = (ROOT / "benchmarks" / "results", common.RESULTS)
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the plain CWS paths spin badly when several
    test processes share the cores with PyTorch's default thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def results_digest():
    """A digest of every file under the two results directories."""
    h = hashlib.sha256()
    for d in RESULT_DIRS:
        for p in sorted(d.rglob("*")) if d.exists() else ():
            if p.is_file():
                h.update(str(p.relative_to(ROOT)).encode())
                h.update(p.read_bytes())
    return h.hexdigest()


@pytest.fixture
def untouched_results():
    """Fails the test if it wrote under either results directory."""
    before = results_digest()
    yield
    assert results_digest() == before, "a results directory changed"


@pytest.fixture
def ref_results(tmp_path, monkeypatch, untouched_results):
    """The reference's records go to a temporary directory."""
    monkeypatch.setattr(ref_common, "RESULTS", tmp_path / "reference")
    return tmp_path / "reference"


def read(d, name):
    return json.loads((pathlib.Path(d) / f"{name}.json").read_text())


def assert_matches_reference(name, got):
    """Every number of the reference's record ``name`` within ``TOL`` of
    the twin's (the same keys)."""
    ref = common.load_reference(name)
    leaves = list(common.numeric_leaves(ref, common.as_json(got)))
    assert leaves
    for path, a, b in leaves:
        assert abs(a - b) <= TOL, (name, path, a, b)


@pytest.mark.parametrize("mod", (ref_table2, ref_fig6),
                         ids=("table2", "fig6"))
def test_reference_reproduces_its_records(mod, ref_results):
    mod.run(fast=True)
    for f in ref_results.iterdir():
        assert read(ref_results, f.stem) == common.load_reference(f.stem)


@pytest.mark.parametrize("twin", (table2_wordpairs, fig6_tstar_only),
                         ids=("table2", "fig6"))
def test_twin_matches_reference_records(twin, tmp_path, untouched_results):
    records = twin.run(fast=True, device="cpu", out=tmp_path)
    assert set(records) == set(twin.RECORDS)
    for name, obj in records.items():
        assert read(tmp_path, name) == common.as_json(obj)
        assert obj["device"] == "cpu" and obj["fast"] is True
        assert_matches_reference(name, obj)
    assert all(twin.check_claims(records).values())


def test_claims_report_each_failure():
    records = {"fig6_tstar_only": {"bias_by_bi": {"0": 0.01, "1": 0.0,
                                                  "2": 0.0, "4": 0.01}}}
    assert fig6_tstar_only.claims(records) == {
        "|bias(b_i=0)| > 5 |bias(b_i=4)|": False}
    with pytest.raises(AssertionError, match="bias"):
        fig6_tstar_only.check_claims(records)
    rows = {"A": {"f1": 1, "f2": 1, "R": 0.5, "MM": 0.6}, "device": "cpu"}
    assert not table2_wordpairs.claims({"table2_wordpairs": rows})[
        "MM <= R on every pair"]


def test_save_json_refuses_the_reference_results(tmp_path):
    with pytest.raises(ValueError, match="reference"):
        common.save_json("x", {}, ROOT / "benchmarks" / "results")
    with pytest.raises(ValueError, match="reference"):
        common.save_json("x", {}, ROOT / "benchmarks" / "results" / "sub")
    assert common.save_json("x", {"a": 1}, tmp_path).read_text() \
        .startswith("{")


def test_twins_need_a_card_unless_told(untouched_results):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table2_wordpairs.run(fast=True)
    from repro_torch.benchmarks import run
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--fast", "--only", "table2"])
