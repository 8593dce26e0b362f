"""The benchmark twin of Figures 7-8 against the reference.

The reference's ``--fast`` run must reproduce its committed records
(``src/repro_torch/benchmarks/reference/fig78_linear_svm.json`` and
``BENCH_linear_stream.json``, wall times aside).  Under jax 0.9.0 it
fails its own streamed gate (0.625 pp against 0.5) after saving both:
that ``AssertionError``, and no other, is expected, and
``reference/claims.json`` records it, with the claims after it that the
run never reached (the approach to the exact kernel fails on its
numbers too).

The twin's cell function runs at a reduced size (the reference's
template-hard rows, handed over, 300 train / 200 test; k = 32; the
reference's hashes) beside the reference's ``fit_linear`` on the same
features: the port's AdamW differs from the jitted reference by about
one rounding a step (ROADMAP C), so each best accuracy may move by a few
test rows.  Stated tolerance: 3 test rows (1.5 pp at 200) a cell.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig78_linear_svm as ref_fig78
from repro.core import make_cws_params
from repro.core.linear_model import TrainCfg as JCfg
from repro.core.linear_model import fit_linear as j_fit
from repro.core.linear_model import init_bag as j_init
from repro.core.linear_model import linear_accuracy as j_acc
from repro.data import synthetic as jsyn
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro_torch.benchmarks import common, fig78_linear_svm
from repro_torch.core import CWSParams
from test_torch_bench_small import (few_threads, read,  # noqa: F401
                                    ref_results, untouched_results)

ROWS_TOL = 3


def _without_times(obj):
    return {k: v for k, v in obj.items() if not k.startswith("us_")}


def test_reference_reproduces_its_records(ref_results):
    with pytest.raises(AssertionError, match="streamed training drifted "
                                             "from full batch by 0.63 pp"):
        ref_fig78.run(fast=True)
    assert read(ref_results, "fig78_linear_svm") == \
        common.load_reference("fig78_linear_svm")
    assert _without_times(read(ref_results, "BENCH_linear_stream")) == \
        _without_times(common.load_reference("BENCH_linear_stream"))


def test_twin_claims_give_the_reference_verdicts():
    # reference/claims.json: the assert the reference's run raised, and
    # the two claims after it, never reached, evaluated on its record; the
    # twin's claims on the reference's own records give the same verdicts
    recorded = json.loads((common.REFERENCE / "claims.json").read_text())
    assert recorded["claims_failed"] == {
        "fig78": "streamed training drifted from full batch by 0.63 pp"}
    assert recorded["claims_not_reached"]["fig78"] == {
        "hashed must beat raw linear": True,
        "k=1024,b_i=8 must approach the exact min-max kernel accuracy":
            False}
    records = {r: dict(common.load_reference(r), fast=True)
               for r in fig78_linear_svm.RECORDS}
    assert fig78_linear_svm.claims(records) == {
        "streamed within 0.5 pp of full batch": False,
        "hashed beats raw linear": True,
        "hashed within 4 pp of exact min-max": False}


@pytest.fixture(scope="module")
def small_case():
    ds = jsyn.CLASSIFICATION_SUITES["template-hard"]()
    xtr, ytr = ds.x_train[:300], ds.y_train[:300]
    xte, yte = ds.x_test[:200], ds.y_test[:200]
    params = make_cws_params(jax.random.PRNGKey(0), xtr.shape[1], 32)
    pipe = JPipe(params, JSpec(32, b_i=1))
    h_tr = tuple(np.array(a) for a in pipe.hashes(jnp.asarray(xtr)))
    h_te = tuple(np.array(a) for a in pipe.hashes(jnp.asarray(xte)))
    return ds.n_classes, params, (xtr, ytr, xte, yte), h_tr, h_te


def _ref_cell(params, h_tr, h_te, ytr, yte, k, b_i, b_t, n_classes):
    """The reference's ``hashed_acc`` closure (fig78_linear_svm.py:70-82)."""
    spec = JSpec(params.num_hashes, b_i=b_i, b_t=b_t)
    pipe = JPipe(params, spec)
    f_tr = pipe.features_from_hashes(jnp.asarray(h_tr[0][:, :k]),
                                     jnp.asarray(h_tr[1][:, :k]))
    f_te = pipe.features_from_hashes(jnp.asarray(h_te[0][:, :k]),
                                     jnp.asarray(h_te[1][:, :k]))
    best = 0.0
    for l2 in fig78_linear_svm.L2S:
        cfg = JCfg(n_classes=n_classes, steps=250, lr=0.05, l2=float(l2))
        p0 = j_init(jax.random.PRNGKey(0), k * spec.width, n_classes)
        p = j_fit(p0, f_tr, jnp.asarray(ytr), cfg=cfg, kind="bag")
        best = max(best, j_acc(p, f_te, jnp.asarray(yte), kind="bag"))
    return best


@pytest.mark.parametrize("k,b_i,b_t", ((32, 2, 0), (16, 8, 0), (32, 4, 2)))
def test_cell_matches_reference_on_same_features(small_case, k, b_i, b_t,
                                                 untouched_results):
    n_classes, jparams, (_, ytr, _, yte), h_tr, h_te = small_case
    params = CWSParams(*(torch.from_numpy(np.array(m)) for m in (
        jparams.r, jparams.log_c, jparams.beta)))
    as_t = lambda h: tuple(torch.from_numpy(a) for a in h)
    got = fig78_linear_svm.hashed_accuracy(
        params, as_t(h_tr), as_t(h_te), torch.from_numpy(ytr),
        torch.from_numpy(yte), k=k, b_i=b_i, b_t=b_t, n_classes=n_classes)
    want = _ref_cell(jparams, h_tr, h_te, ytr, yte, k, b_i, b_t, n_classes)
    assert abs(got - want) * len(yte) <= ROWS_TOL + 1e-6, (got, want)


def test_stream_record_keys_and_gap(small_case, monkeypatch,
                                    untouched_results):
    # the record's layout at a few steps: the reference's keys, the gap
    # as |streamed - full batch| in pp
    monkeypatch.setattr(fig78_linear_svm, "STREAM_STEPS", 4)
    monkeypatch.setattr(fig78_linear_svm, "FULL_STEPS", 6)
    monkeypatch.setattr(fig78_linear_svm, "STREAM_BATCH", 100)
    n_classes, jparams, (xtr, ytr, xte, yte), _, _ = small_case
    params = CWSParams(*(torch.from_numpy(np.array(m)) for m in (
        jparams.r, jparams.log_c, jparams.beta)))
    rec = fig78_linear_svm.stream_record(
        params, *(torch.from_numpy(a) for a in (xtr, ytr, xte, yte)),
        k=32, b_i=8, n_classes=n_classes)
    assert set(rec) == set(common.load_reference("BENCH_linear_stream"))
    assert (rec["k"], rec["b_i"], rec["batch_size"], rec["steps"],
            rec["n_train"]) == (32, 8, 100, 4, 300)
    assert rec["gap_pp"] == pytest.approx(
        abs(rec["acc_streamed"] - rec["acc_fullbatch"]), abs=0.01)


def test_dataset_is_the_reference_draw():
    ds = fig78_linear_svm.dataset()
    ref = jsyn.make_template_classification(
        1, n_classes=10, density=0.15, mult_noise=1.2, spike_prob=0.08,
        name="template-hard")
    np.testing.assert_array_equal(ds.y_test, ref.y_test)
    np.testing.assert_allclose(ds.x_train, ref.x_train, rtol=4e-5, atol=0)


def test_claims_and_refusals():
    fig7 = {"minmax_ref": 98.9, "linear_ref": 65.9,
            "grid": {"b2_k32": 50.2, "b8_k128": 93.8}}
    fig8 = {"b2": {"bt0": 78.0, "bt2": 89.6}, "b8": {"bt0": 93.8,
                                                     "bt2": 94.9}}
    records = {"fig78_linear_svm": {"fig7": fig7, "fig8": fig8,
                                    "fast": True},
               "BENCH_linear_stream": {"gap_pp": 0.625}}
    claims = fig78_linear_svm.claims(records)
    assert claims == {"streamed within 0.5 pp of full batch": False,
                      "hashed beats raw linear": True,
                      "hashed within 4 pp of exact min-max": False}
    with pytest.raises(AssertionError, match="streamed"):
        fig78_linear_svm.check_claims(records)
    with pytest.raises(NotImplementedError, match="A11"):
        fig78_linear_svm.run(fast=True, mesh=True, device="cpu")
