"""Port parity: the roofline (``repro_torch.benchmarks.roofline``) and its
tables (``gen_experiments``) against the reference's
``benchmarks/roofline.py``, on the port's 66 committed dry-run records.

  * the model's FLOPs, the attention term and the train / prefill ideal
    time equal the reference's functions on every record, at the port's
    constants (patched into the reference), exactly;
  * each term, the dominant one, the fraction and the peeling clamp equal
    the reference's ``analyze_record`` on the same rank counts;
  * the constants are the H100's; ``model_flops(cfg, ...)`` is affine in
    depth (the embedding and head once, each layer alike);
  * the committed ``roofline.json`` equals a recompute, and the suite
    runs on the CPU through ``python -m repro_torch.benchmarks.run``.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from benchmarks import roofline as ref_roofline  # noqa: E402

from repro_torch.benchmarks import gen_experiments, roofline  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS = sorted(roofline.DRYRUN.glob("*.json"))


def _load(path):
    return json.loads(path.read_text())


@pytest.fixture
def ref_at_port_constants(monkeypatch):
    for name, value in roofline.constants().items():
        monkeypatch.setattr(ref_roofline, name, value)
    return ref_roofline


def _ref_shaped(rec):
    """The record in the reference's layout, at the counts the port's
    roofline reads: each term's slower rank."""
    ranks = list(rec["ranks"].values())
    g = {k: max(r["graph"][k] for r in ranks)
         for k in ("dot_flops", "bytes_accessed", "total_collective_bytes")}
    return {**rec,
            "hlo": {"dot_flops_per_device": g["dot_flops"],
                    "bytes_per_device": g["bytes_accessed"],
                    "collective_total_bytes": g["total_collective_bytes"]},
            "memory": {"peak_est_bytes": 0, "argument_bytes": 0}}


def test_the_66_records_are_there():
    assert len(RECORDS) == 66
    assert {_load(p)["mesh"] for p in RECORDS} == {"16x16", "2x16x16"}


def test_model_flops_equal_the_reference_on_every_record(
        ref_at_port_constants):
    ref = ref_at_port_constants
    for path in RECORDS:
        rec = _load(path)
        assert roofline.record_model_flops(rec) == ref.model_flops(rec), \
            path.name
        assert roofline.record_attention_flops(rec) == \
            ref._attention_flops(rec), path.name
        if rec["kind"] != "decode":
            assert roofline.ideal_time(rec) == ref.ideal_time(rec), path.name
        cfg = get_config(rec["arch"], "full")
        assert roofline.model_flops(cfg, rec["kind"], rec["global_batch"],
                                    rec["seq_len"]) == ref.model_flops(rec)


def test_analysis_equals_the_reference_on_every_record(
        ref_at_port_constants):
    ref = ref_at_port_constants
    for path in RECORDS:
        rec = _load(path)
        got = roofline.analyze_record(rec)
        want = ref.analyze_record(_ref_shaped(rec))
        for key in ("cell", "mesh", "T_comp_s", "T_mem_s", "T_coll_s",
                    "dominant", "MODEL_FLOPS", "peeling_clamped"):
            assert got[key] == want[key], (path.name, key)
        if rec["kind"] != "decode":
            assert got["roofline_fraction"] == want["roofline_fraction"]
        ranks = list(rec["ranks"].values())
        if all(r["graph"]["dot_flops"] == ranks[0]["graph"]["dot_flops"]
               for r in ranks):
            assert got["useful_ratio"] == pytest.approx(
                want["useful_ratio"], rel=1e-12), path.name


def test_decode_ideal_reads_the_cache_bytes():
    rec = _load(roofline.DRYRUN / "gemma3_12b__decode_32k__16x16.json")
    cache = max(r["memory"]["cache_bytes"] for r in rec["ranks"].values())
    want = (rec["active_params"] * 2 / rec["n_devices"] + cache) / \
        roofline.HBM_BW
    assert roofline.ideal_time(rec) == want
    assert cache > 0


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 132 * 4096 * 1980e6
    assert roofline.PEAK_FLOPS == pytest.approx(1.0705e15, rel=1e-4)
    assert roofline.peak_flops(132, 1980) == roofline.PEAK_FLOPS
    assert roofline.peak_flops(114, 1755) == 114 * 4096 * 1755e6
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_affine_in_depth(arch):
    import dataclasses
    cfg = get_config(arch, "full")
    p = len(cfg.block_pattern)
    for kind in ("train", "prefill", "decode"):
        f = [roofline.model_flops(dataclasses.replace(cfg, n_layers=n * p),
                                  kind, 2, 4096) for n in (1, 2, 3)]
        assert f[2] - f[1] == pytest.approx(f[1] - f[0], rel=1e-12)
        assert f[1] > f[0] > 0
    att = roofline.attention_flops(cfg, 2, 4096)
    assert roofline.model_flops(cfg, "train", 2, 4096) == \
        6.0 * cfg.active_param_count() * 2 * 4096 + 3.0 * att


@pytest.mark.parametrize("kind,weight", [("train", 3.0), ("prefill", 1.0),
                                         ("decode", 0.0)])
def test_model_flops_parts_weigh_the_attention_term(kind, weight):
    cfg = get_config("gemma3_12b", "full")
    total, attn = roofline.model_flops_parts(cfg, kind, 4, 2048)
    assert total == roofline.model_flops(cfg, kind, 4, 2048)
    assert attn == weight * roofline.attention_flops(cfg, 4, 2048)
    with pytest.raises(ValueError):
        roofline.model_flops_parts(cfg, "eval", 4, 2048)


def test_committed_record_equals_a_recompute(tmp_path):
    committed = _load(roofline.RESULTS_FILE)
    out = roofline.run(out=tmp_path)["roofline"]
    assert json.loads(json.dumps(out)) == committed
    assert _load(tmp_path / "roofline.json") == committed
    assert all(r["dominant"] == "collective" for r in committed["rows"])


def test_the_suite_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
         "roofline", "--out", str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "# all benchmark suites passed" in proc.stdout
    assert (tmp_path / "roofline.json").exists()


def test_gen_experiments_prints_both_meshes(capsys):
    text = gen_experiments.main()
    assert capsys.readouterr().out.strip() == text.strip()
    for title in ("Dry run — single pod", "Dry run — multi-pod",
                  "Roofline — single pod", "Roofline — multi-pod"):
        assert title in text
    assert text.count("| gemma3_12b/train_4k |") == 2
    assert "1,070.5 TFLOP/s" in text
