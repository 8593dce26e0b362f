"""The plan and serve-bucket tables of the kernel registry, and the
autotune tool, against the reference's registry.

Keys are bucketed as the reference buckets them; tables round-trip
through their JSON files; bad entries and bad bucket ladders are
refused, and a bad entry installs nothing.  A loaded plan table steers
``split_plan`` and ``gram_plan`` (and so the launchers) on an exact key
match only, and a plan the shape cannot take raises.  The steered plans
keep the kernels' outputs: the split body and the Gram are emulated on
the tuned plans (``test_torch_cws_split.py``'s and
``test_torch_min_sum_plan.py``'s emulations) and held against the plain
versions.  The tool's ``--dry-run`` runs here; its measured sweep runs
on the CPU with the emulations standing in for the kernels and a fake
clock, and refuses a candidate whose output differs.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import registry as ref_registry
from repro_torch.benchmarks.common import rand_nonneg
from repro_torch.core.regen import prng_key
from repro_torch.kernels import cws_hash, minmax_gram, registry
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.serving.runner import BucketRunner
from repro_torch.core.linear_model import init_bag
from repro_torch.tools import autotune_blocks as tool
from test_torch_cws_split import _regen, split_emulate_index
from test_torch_min_sum_plan import assert_within, emulate


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the emulations spin badly when several test
    processes share the cores with PyTorch's default thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_tables():
    """Every test starts and ends with both tables empty."""
    registry.clear_block_table()
    registry.clear_serve_buckets()
    yield
    registry.clear_block_table()
    registry.clear_serve_buckets()


CWS_ENTRY = {"rows_per_thread": 2, "row_warps": 4, "splits": 2}
GRAM_ENTRY = {"tile": (128, 64), "splits": 2, "small": False}


@pytest.mark.parametrize("op", ["cws_encode", "cws_hash_rng",
                                "cws_encode_rng_packed", "cws_packed",
                                "minmax_gram", "gram", "min_sum"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 100, 1000),
                                   (256, 128, 128), (257, 65536, 1025)])
def test_table_key_buckets_as_the_reference(op, shape):
    assert registry.table_key(op, *shape) == ref_registry.table_key(
        op, *shape)


def test_block_table_round_trips_its_json(tmp_path):
    entries = {registry.table_key("cws_encode_rng", 300, 256, 1024):
               CWS_ENTRY,
               registry.table_key("min_sum", 1200, 256, 800): GRAM_ENTRY}
    path = tmp_path / "table.json"
    registry.save_block_table(path, entries)
    obj = json.loads(path.read_text())
    assert obj == {"cws_rng:512:256:1024": CWS_ENTRY,
                   "min_sum:2048:256:1024": {"tile": [128, 64], "splits": 2,
                                             "small": False}}
    assert registry.BLOCK_TABLE == {}
    loaded = registry.load_block_table(path)
    assert loaded == registry.BLOCK_TABLE == {
        ("cws_rng", 512, 256, 1024): CWS_ENTRY,
        ("min_sum", 2048, 256, 1024): GRAM_ENTRY}
    assert registry.plan_entry("cws_hash_rng", 400, 200, 1000) == CWS_ENTRY
    assert registry.plan_entry("cws_encode", 400, 200, 1000) is None
    registry.save_block_table(tmp_path / "all.json")
    assert json.loads((tmp_path / "all.json").read_text()) == obj


@pytest.mark.parametrize("op,entry", [
    ("cws", {"rows_per_thread": 3, "row_warps": 4, "splits": 2}),
    ("cws_rng", {"rows_per_thread": 2, "row_warps": 32, "splits": 2}),
    ("cws_packed", {"rows_per_thread": 2, "row_warps": 4, "splits": 16}),
    ("cws", {"rows_per_thread": 2, "row_warps": 4}),
    ("cws", GRAM_ENTRY),
    ("min_sum", {"tile": (96, 64), "splits": 1, "small": False}),
    ("min_sum", {"tile": (64, 64), "splits": 3, "small": False}),
    ("min_sum", {"tile": (0, 0), "splits": 2, "small": True}),
    ("min_sum", CWS_ENTRY),
    ("flash_attention", CWS_ENTRY),
])
def test_bad_entries_are_refused_and_install_nothing(op, entry, tmp_path):
    good = (("cws", 8, 8, 8), CWS_ENTRY)
    with pytest.raises(ValueError):
        registry.update_block_table(dict([good, ((op, 16, 16, 16), entry)]))
    assert registry.BLOCK_TABLE == {}
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({f"{op}:16:16:16": {
        k: list(v) if isinstance(v, tuple) else v for k, v in entry.items()}}))
    with pytest.raises(ValueError):
        registry.load_block_table(path)
    assert registry.BLOCK_TABLE == {}


def test_a_plan_the_shape_cannot_take_raises():
    registry.update_block_table({
        registry.table_key("cws_encode", 8, 4, 32): {
            "rows_per_thread": 1, "row_warps": 1, "splits": 8},
        registry.table_key("cws_encode_rng", 300000, 64, 32): {
            "rows_per_thread": 1, "row_warps": 1, "splits": 1},
        registry.table_key("min_sum", 64, 64, 64): {
            "tile": (64, 64), "splits": 8, "small": False}})
    with pytest.raises(ValueError, match="ranks for D = 4"):
        cws_hash.split_plan(8, 4, 32, 132, stored=True, op="cws_encode")
    with pytest.raises(ValueError, match="row tiles"):
        cws_hash.split_plan(300000, 64, 32, 132, op="cws_encode_rng")
    with pytest.raises(ValueError, match="chunks"):
        minmax_gram.gram_plan(64, 64, 64, 132, op="min_sum")
    # without ``op`` (and for other families) the heuristic stands
    assert cws_hash.split_plan(8, 4, 32, 132, stored=True).splits == 1
    assert cws_hash.split_plan(8, 4, 32, 132, op="cws_encode_rng") == \
        cws_hash.split_plan(8, 4, 32, 132)
    with pytest.raises(ValueError):
        cws_hash.check_plan(cws_hash.SplitPlan(8, 4, 32, 1, 1, 8))


def test_no_table_keeps_the_heuristic_plans():
    for n, d, k in [(12, 256, 1024), (1200, 256, 1024), (512, 65536, 1024)]:
        for stored in (False, True):
            op = "cws_encode" if stored else "cws_encode_rng"
            assert cws_hash.split_plan(n, d, k, 132, stored=stored, op=op) \
                == cws_hash.split_plan(n, d, k, 132, stored=stored)
    assert minmax_gram.gram_plan(1200, 1200, 256, 132, op="min_sum") == \
        minmax_gram.gram_plan(1200, 1200, 256, 132)


def test_a_loaded_table_steers_the_plans_and_keeps_the_outputs(tmp_path):
    """Rows 1 and 7 on tuned plans unlike the heuristic's: the split body
    and the Gram emulated on them equal the plain versions (row 1 bit
    for bit, row 7 within 2·D·2^-24·S)."""
    n, d, k = 24, 150, 40
    x = rand_nonneg(prng_key(0), (n, d))
    key = prng_key(1)
    entries = {registry.table_key("cws_rng", n, d, k): CWS_ENTRY,
               registry.table_key("min_sum", n, d, 20): GRAM_ENTRY}
    registry.save_block_table(tmp_path / "t.json", entries)
    registry.load_block_table(tmp_path / "t.json")
    plan = cws_hash.split_plan(n, d, k, 132, op="cws_encode_rng")
    assert plan == cws_hash.SplitPlan(n, d, k, **CWS_ENTRY)
    assert plan != cws_hash.split_plan(n, d, k, 132)
    got = split_emulate_index(x.numpy(), _regen(key, d, k), plan, b_i=8)
    want = cws_hash.cws_encode_rng_plain(x, key, k, b_i=8)
    assert torch.equal(got, want)
    y = rand_nonneg(prng_key(2), (20, d))
    gp = minmax_gram.gram_plan(n, 20, d, 132, op="min_sum")
    assert (gp.tile, gp.splits, gp.small) == ((128, 64), 2, False)
    assert gp != minmax_gram.gram_plan(n, 20, d, 132)
    assert_within(emulate(gp, x.numpy(), y.numpy()),
                  minmax_gram.min_sum_plain(x, y).numpy(), d)


def test_serve_buckets_as_the_reference(tmp_path):
    for bad in [(), (0, 8), (8, 8), (32, 8), (-1,)]:
        with pytest.raises(ValueError):
            ref_registry._check_buckets(bad)
        with pytest.raises(ValueError):
            registry.update_serve_buckets({"cws": bad})
    assert registry.SERVE_BUCKET_TABLE == {}
    assert registry.serve_buckets("cws_encode_rng") == \
        registry.DEFAULT_SERVE_BUCKETS == ref_registry.DEFAULT_SERVE_BUCKETS
    registry.update_serve_buckets({"cws_encode_rng": [4, 16, 64]})
    assert registry.serve_buckets("cws_hash_rng") == (4, 16, 64)
    assert registry.serve_buckets("cws") == registry.DEFAULT_SERVE_BUCKETS
    path = tmp_path / "buckets.json"
    registry.save_serve_buckets(path)
    assert json.loads(path.read_text()) == {"cws_rng": [4, 16, 64]}
    registry.clear_serve_buckets()
    assert registry.load_serve_buckets(path) == {"cws_rng": (4, 16, 64)}
    assert registry.SERVE_BUCKET_TABLE == {"cws_rng": (4, 16, 64)}
    # the runner takes its family's ladder when given none
    pipe = FeaturePipeline.create_regen(prng_key(0), 16, FeatureSpec(8, b_i=2),
                                        device="cpu")
    runner = BucketRunner(init_bag(pipe.num_features, 3, device="cpu"), pipe)
    assert runner.buckets == (4, 16, 64)
    runner.warmup()
    assert runner.compile_count() == 3


def test_dry_run_lists_candidates_and_default_plans(capsys):
    out = tool.main(["--dry-run", "--shapes", "256x128x128", "64x100x32"])
    assert out["entries"] == {} and all(v == [] for v in
                                        out["sweeps"].values())
    assert len(out["sweeps"]) == 10
    text = capsys.readouterr().out
    assert "dry-run: no entries written" in text
    plan = cws_hash.split_plan(256, 128, 128, 132, stored=True)
    assert (f"[cws] 256x128x128: 80 candidates, default "
            f"{tool.default_entry('cws', 256, 128, 128, 132)}") in text
    assert tool.default_entry("cws", 256, 128, 128, 132) == {
        "rows_per_thread": plan.rows_per_thread,
        "row_warps": plan.row_warps, "splits": plan.splits}
    # D = 100: four chunks of 32, so S <= 4; every entry is a legal plan
    cands = tool.candidates("min_sum", 64, 100, 32)
    assert len(cands) == 3 * 3 + 1
    for e in cands:
        tool.to_plan("min_sum", 64, 100, 32, e, 132)
    assert len(tool.candidates("cws", 8, 4, 32)) == 4 * 5 * 3   # S <= 4


def _emulated(fam, n, d, k, dev=None):
    """The tool's launcher with the emulations in place of the kernels."""
    x = rand_nonneg(prng_key(0), (n, d))
    if fam == "min_sum":
        y = rand_nonneg(prng_key(2), (k, d))
        return lambda plan: torch.from_numpy(emulate(plan, x.numpy(),
                                                     y.numpy()))
    params = _regen(prng_key(1), d, k)
    return lambda plan: split_emulate_index(x.numpy(), params, plan, b_i=8)


def test_measured_sweep_persists_the_winners(tmp_path, monkeypatch):
    clock = iter(range(1000, 0, -1))     # each candidate "faster" than the last
    monkeypatch.setattr(tool, "launcher", _emulated)
    monkeypatch.setattr(tool, "time_ms", lambda fn, repeats: (
        fn(), next(clock) * 1e-3)[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tool, "sm_count", lambda index: 132)
    out = tool.main(["--families", "cws_rng,min_sum", "--shapes",
                     "16x96x40", "--out", str(tmp_path / "t.json")])
    cws_rows = out["sweeps"][("cws_rng", "16x96x40")]
    gram_rows = out["sweeps"][("min_sum", "16x96x40")]
    assert len(cws_rows) == len(tool.candidates("cws_rng", 16, 96, 40))
    assert len(gram_rows) == 3 * 2 + 1
    want = {registry.table_key("cws_rng", 16, 96, 40): cws_rows[-1][0],
            registry.table_key("min_sum", 16, 96, 40): gram_rows[-1][0]}
    assert out["entries"] == want
    assert registry.BLOCK_TABLE == {}
    assert registry.load_block_table(tmp_path / "t.json") == {
        k: registry.check_entry(k[0], v) for k, v in want.items()}


def test_a_candidate_that_differs_is_an_error(monkeypatch):
    def broken(fam, n, d, k, dev=None):
        run = _emulated(fam, n, d, k)
        return lambda plan: run(plan) + (plan.row_warps == 2)
    monkeypatch.setattr(tool, "launcher", broken)
    monkeypatch.setattr(tool, "time_ms", lambda fn, repeats: 1.0)
    with pytest.raises(AssertionError, match="differs from the default"):
        tool.tune("cws_rng", 16, 96, 40, sms=132)
    monkeypatch.setattr(tool, "launcher", lambda *a, **kw: (
        lambda plan: torch.ones(16, 40) * (1 + plan.splits)))
    with pytest.raises(AssertionError, match="2·D·2"):
        tool.tune("min_sum", 16, 96, 40, sms=132)


def test_measuring_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--dry-run"):
        tool.main(["--shapes", "16x96x40"])
    assert np.isnan(tool.tune("cws", 16, 96, 40, sms=132, dry_run=True)[1])
