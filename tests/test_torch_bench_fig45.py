"""The benchmark twin of Figures 4-5 against the reference.

The reference's ``--fast`` run must reproduce its committed record
(``src/repro_torch/benchmarks/reference/fig45_cws_mse.json``) exactly.  The
twin (``device="cpu"``) runs a reduced case beside the reference's ``run``
called with the same explicit arguments: its hashes are the reference's
integers and its estimators numpy as there, so every number agrees within
1e-6 (K's float32 sum order).
"""
import pytest

from benchmarks import fig45_cws_mse as ref_fig45
from repro_torch.benchmarks import common, fig45_cws_mse
from test_torch_bench_small import (TOL, few_threads, read,  # noqa: F401
                                    ref_results, untouched_results)


def test_reference_reproduces_its_record(ref_results):
    ref_fig45.run(fast=True)
    assert read(ref_results, "fig45_cws_mse") == \
        common.load_reference("fig45_cws_mse")


def test_fig45_twin_matches_reference_run(tmp_path, ref_results):
    # a reduced run: the reference's run with the same explicit arguments
    # (200 reps is the adaptive budget's floor) on two pairs of small
    # support; where the reference's own assert fails, its saved record
    # is compared all the same and the twin's claims must fail too
    args = dict(pairs=("PIPELINE-FLUSH", "GAMBIA-KIRIBATI"), reps=200,
                n_docs=1024)
    try:
        ref_fig45.run(**args)
        ref_passed = True
    except AssertionError:
        ref_passed = False
    want = read(ref_results, "fig45_cws_mse")
    records = fig45_cws_mse.run(**args, device="cpu", out=tmp_path)
    got = common.as_json(records["fig45_cws_mse"])
    leaves = list(common.numeric_leaves(want, got))
    assert len(leaves) == 2 * (1 + 7 * len(fig45_cws_mse.KS))
    for path, a, b in leaves:
        assert abs(a - b) <= TOL, (path, a, b)
    for pair in args["pairs"]:
        assert got[pair]["reps"] == fig45_cws_mse.pair_reps(
            200, got[pair]["D"])
    claims = fig45_cws_mse.claims(records)
    assert len(claims) == 2 * 3 * len(args["pairs"])
    assert all(claims.values()) == ref_passed
