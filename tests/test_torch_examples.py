"""The port's examples (``repro_torch.examples``) and its docs smoke
(``repro_torch.tools.run_doc_snippets``) against the reference's.

  * ``cws_classification.run`` on a cut dataset (200 train / 100 test
    rows of the example's templates, k = 32, 60 streamed and 60
    full-batch steps) against the reference functions its example calls,
    on the same rows and the reference's own CWS draws: the exact
    kernel machines' accuracies equal; the streamed and full-batch fits
    within ROWS_TOL test rows (the port's AdamW differs from the jitted
    reference by about one rounding a step, ROADMAP C; ``make_cws_params_
    jax``'s r and log c by a few float32 roundings, C3);
  * the flagship's k = 1,024 features on 64 of its test rows equal to
    the reference pipeline's, on the reference's CWS matrices handed over;
  * ``quickstart.run`` against the reference's functions on the same
    numpy inputs and CWS matrices: the kernel and the Gram within 1e-6,
    the collision estimates within EST_TOL (``torch.log`` and ``jnp.log``
    differ by one ulp on some inputs, which may move an argmin tie);
  * ``serve_lm`` and ``train_lm`` on the CPU at smoke;
  * ``run_doc_snippets`` green on ``README.md``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core.kernel_svm import best_accuracy_over_C as j_best  # noqa: E402
from repro.core.linear_model import TrainCfg as JCfg  # noqa: E402
from repro.core.linear_model import fit_linear as j_fit  # noqa: E402
from repro.core.linear_model import init_bag as j_init  # noqa: E402
from repro.core.linear_model import linear_accuracy as j_acc  # noqa: E402
from repro.pipeline import FeaturePipeline as JPipe  # noqa: E402
from repro.pipeline import FeatureSpec as JSpec  # noqa: E402
from repro.training import fit_linear_streamed as j_stream  # noqa: E402
from repro.training import streamed_accuracy as j_stream_acc  # noqa: E402

from repro_torch.examples import (cws_classification, quickstart,  # noqa: E402
                                  serve_lm, train_lm)
from repro_torch.tools import run_doc_snippets  # noqa: E402

CUT = {"n_train": 200, "n_test": 100}
K, STEPS, B_I = 32, 60, 8
ROWS_TOL = 2        # test rows of 100, a trained accuracy
EST_TOL = 2 / quickstart.K


def _reference_flagship(ds):
    """The reference example's calls at the cut sizes."""
    xtr, xte = jnp.asarray(ds.x_train), jnp.asarray(ds.x_test)
    ytr, yte = jnp.asarray(ds.y_train), jnp.asarray(ds.y_test)
    out = {"exact": {}}
    for kern in ("linear", "min-max"):
        out["exact"][kern], _ = j_best(
            jcore.GRAM_FNS[kern](xtr, xtr), jcore.GRAM_FNS[kern](xte, xtr),
            ytr, yte, n_classes=ds.n_classes, sweeps=20)
    params = JPipe.create(jax.random.PRNGKey(0), xtr.shape[1],
                          JSpec(K, b_i=B_I)).params
    pipe = JPipe(params, JSpec(num_hashes=K, b_i=B_I))
    cfg = JCfg(n_classes=ds.n_classes, steps=STEPS, lr=0.05, l2=1e-5,
               batch_size=min(cws_classification.BATCH, xtr.shape[0]))
    p0 = j_init(jax.random.PRNGKey(0), pipe.num_features, ds.n_classes)
    p = j_stream(p0, pipe, xtr, ytr, cfg=cfg)
    out["streamed"] = float(j_stream_acc(p, pipe, xte, yte))
    cfg = JCfg(n_classes=ds.n_classes, steps=STEPS, lr=0.05, l2=1e-5)
    p = j_fit(p0, pipe.features(xtr), ytr, cfg=cfg, kind="bag")
    out["full_batch"] = float(j_acc(p, pipe.features(xte), yte, kind="bag"))
    return out


def test_flagship_run_matches_the_reference():
    # the example's rows on the port's draws of the reference's stream;
    # both runs take these arrays
    ds = cws_classification.dataset(**CUT)
    lines = []
    got = cws_classification.run(ds, (K,), B_I, "cpu", steps=STEPS,
                                 full_steps=STEPS, log=lines.append)
    want = _reference_flagship(ds)
    rows = lambda acc: round(acc * CUT["n_test"])
    for kern in ("linear", "min-max"):
        assert rows(got["exact"][kern]) == rows(want["exact"][kern]), kern
    assert abs(rows(got["streamed"][K]) - rows(want["streamed"])) <= ROWS_TOL
    assert abs(rows(got["full_batch"]) - rows(want["full_batch"])) <= ROWS_TOL
    assert got["exact"]["min-max"] > got["exact"]["linear"]
    assert lines[0] == "dataset: 200 train / 100 test, D=256, 10 classes"
    assert lines[3].startswith(f"0-bit CWS + streamed linear (k={K:5d}, "
                               f"b_i={B_I}): ")
    assert len(lines) == 5


def test_flagship_features_equal_the_references():
    """At the flagship's k = 1,024 (on 64 of its test rows) the port's
    features equal the reference pipeline's on the reference's own CWS
    matrices, handed over: what the card's accuracies differ from the
    reference's record by is training arithmetic, not features."""
    x = cws_classification.dataset().x_test[:64]
    params = JPipe.create(jax.random.PRNGKey(0), x.shape[1],
                          JSpec(1024, b_i=B_I)).params
    want = np.asarray(JPipe(params, JSpec(1024, b_i=B_I)).features(
        jnp.asarray(x)))
    handed = cws_classification.CWSParams(*(
        torch.from_numpy(np.array(m)) for m in (params.r, params.log_c,
                                                params.beta)))
    got = cws_classification.FeaturePipeline(
        handed, cws_classification.FeatureSpec(1024, b_i=B_I)).features(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quickstart_matches_the_reference():
    arrays = quickstart.inputs()
    got = quickstart.run(arrays, "cpu", log=lambda *a: None)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert got["k_true"] == pytest.approx(
        float(jcore.minmax_pair(j["u"], j["v"])), abs=1e-6)
    params = jcore.CWSParams(j["r"], j["log_c"], j["beta"])
    i_s, t_s = jcore.cws_hash(jnp.stack([j["u"], j["v"]]), params)
    want = {
        "est_full": float(jcore.full_collision_estimate(i_s[0], t_s[0],
                                                        i_s[1], t_s[1])),
        "est_0bit": float(jcore.collision_estimate(i_s[0], i_s[1]))}
    codes = jcore.encode(i_s, t_s, b_i=8)
    want["est_8bit"] = float(jcore.collision_estimate(codes[0], codes[1]))
    for key, value in want.items():
        assert abs(got[key] - value) <= EST_TOL, key
    np.testing.assert_allclose(
        got["gram"], np.asarray(jcore.minmax_gram(j["batch"], j["batch"])),
        atol=1e-6)
    assert got["gram"].shape == (4, 4)


def test_serve_lm_on_the_cpu_at_smoke():
    lines = []
    out = serve_lm.run("cpu", log=lines.append)
    gen = out["generated"]
    assert gen.shape == (serve_lm.BATCH, serve_lm.GEN)
    assert ((gen >= 0) & (gen < out["vocab"])).all()
    assert out["route_logits"].shape == (serve_lm.BATCH, 3)
    assert np.isfinite(out["route_logits"]).all()
    assert out["pooled"].shape[0] == serve_lm.BATCH
    assert out["head"].cws.num_hashes == 64
    assert lines[0].startswith("generated ids:")
    assert lines[1].startswith("CWS-head routing logits:")


def test_train_lm_on_the_cpu_at_smoke(capsys):
    state = train_lm.main(["--arch", "starcoder2_7b", "--steps", "3",
                           "--log-every", "1", "--device", "cpu"])
    assert int(state.step) == 3
    out = capsys.readouterr().out
    assert "step     3 loss" in out and out.rstrip().endswith("done")


def test_doc_snippets_green_on_the_readme(capsys):
    assert run_doc_snippets.main([]) == 0
    assert "docs-smoke: all green" in capsys.readouterr().out
    readme = (run_doc_snippets.ROOT / "README.md").read_text()
    assert run_doc_snippets.extract_snippets(readme)
