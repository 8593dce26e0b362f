"""Port parity: linear training (``repro.core.linear_model``'s training
part and ``repro.training.linear_trainer``, unsharded).

At the paper configuration's smoke width (D = 32, k = 64, b_i = 4, 4
classes) on the reference's own dataset, handed over as arrays:

  * losses and gradients of the dense, hashed and bag kinds against
    ``jax.grad``.  The logits are float32 sums of up to k terms that each
    framework adds in its own order, so losses are held within 1e-6
    relative and gradients within 1e-5 relative plus 1e-6 of the largest
    gradient entry;
  * one ``make_linear_tx`` step from the reference's (params, state)
    (carried across by ``interop.linear_opt_state``) and the reference's
    gradient, against the reference's next (params, state), at several
    steps of a reference fit: exactly against the reference evaluated as
    written where the global-norm clip does not bind (1e-6 relative plus
    1e-6 of the largest entry where it binds: each framework sums the
    squares its own way), and within ``test_torch_optim``'s jitted
    tolerances against the jitted step it trains with;
  * ``fit_linear`` (full batch and minibatch) and
    ``fit_linear_streamed`` against the reference on the same data and
    key words: identical features, and test accuracy within 3.75 pp (3 of
    the 80 test rows).  AdamW's g / sqrt(v) turns a last-bit difference
    of a gradient into a step the size of lr, so final tables are not
    compared (ROADMAP C);
  * the port's own promises, exactly: ``batch_size == n`` streamed
    training equals full-batch ``fit_linear``, the streamed walk equals
    ``fit_linear``'s minibatch walk under the same key, host (numpy) rows
    equal tensor rows, and packed training equals unpacked training;
  * a port-trained bundle loads in ``repro.serving`` and scores as the
    port does (rtol 1e-5 / atol 1e-6, the slice's serving tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs.minmax_paper import SMOKE as JSMOKE
from repro.core import linear_model as jlm
from repro.data.synthetic import make_template_classification
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro.serving import load_bundle as jload
from repro.training import fit_linear_streamed as jfit_streamed
from repro.training import streamed_accuracy as jstreamed_accuracy
from repro.training.trainer import microbatch_grads as jmicrobatch_grads
from repro_torch import interop
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.core import linear_model as tlm
from repro_torch.core.regen import prng_key
from repro_torch.launch.mesh import Mesh, make_data_mesh
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.runtime.fault_tolerance import StepWatchdog
from repro_torch.training import (export_served_model, fit_linear_streamed,
                                  fit_linear_streamed_resilient,
                                  resume_linear_streamed,
                                  resume_streamed_accuracy,
                                  streamed_accuracy)
from repro_torch.training.trainer import microbatch_grads

SMOKE = get_config("minmax_paper", "smoke")
C = SMOKE.n_classes
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-6
ACC_PP = 3.75          # 3 of the 80 test rows
JIT_RTOL, JIT_ATOL_OF_MAX = 4e-7, 1e-6     # as in test_torch_optim
CLIP_NORM, CLIP_RTOL, CLIP_ATOL_OF_MAX = 10.0, 1e-6, 1e-6


def test_smoke_config_is_the_reference_data():
    assert SMOKE == type(SMOKE)(**vars(JSMOKE))
    assert get_config("minmax_paper").num_hashes == 1024


@pytest.fixture(scope="module")
def problem():
    """The reference's dataset and regen pipeline, and the port's pipeline
    on the same key words."""
    ds = make_template_classification(3, n_train=160, n_test=80,
                                      dim=SMOKE.dim, n_classes=C,
                                      mult_noise=1.1, spike_prob=0.02,
                                      density=0.3)
    spec = JSpec(num_hashes=SMOKE.num_hashes, b_i=SMOKE.b_i)
    jpipe = JPipe.create_regen(jax.random.PRNGKey(7), SMOKE.dim, spec)
    pipe = FeaturePipeline.create_regen(np.asarray(jpipe._key_words),
                                        SMOKE.dim,
                                        FeatureSpec(SMOKE.num_hashes,
                                                    SMOKE.b_i),
                                        device="cpu")
    return ds, jpipe, pipe


def _cfgs(**kw):
    base = dict(n_classes=C, steps=SMOKE.steps, lr=SMOKE.lr, l2=SMOKE.l2)
    base.update(kw)
    return jlm.TrainCfg(**base), tlm.TrainCfg(**base)


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max())


def _params_np(rng, shape):
    return ((0.1 * rng.standard_normal(shape)).astype(np.float32),
            (0.1 * rng.standard_normal(C)).astype(np.float32))


def _kind_inputs(kind, rng, n=40):
    """(w shape, inputs) of a kind: dense rows, per-hash codes with the
    sentinel -1 and out-of-range codes, or global bag indices."""
    k, width = SMOKE.num_hashes, 1 << SMOKE.b_i
    if kind == "dense":
        return (SMOKE.dim, C), np.abs(rng.standard_normal(
            (n, SMOKE.dim))).astype(np.float32)
    if kind == "hashed":
        return (k, width, C), rng.integers(-1, width + 3, (n, k)).astype(
            np.int32)
    return (k * width, C), (np.arange(k) * width + rng.integers(
        0, width, (n, k))).astype(np.int32)


@pytest.mark.parametrize("loss", ["squared_hinge", "softmax_xent"])
@pytest.mark.parametrize("kind", ["dense", "hashed", "bag"])
def test_loss_and_gradients_match_jax_grad(kind, loss):
    rng = np.random.default_rng(
        ["dense", "hashed", "bag"].index(kind) * 2 + (loss == "softmax_xent"))
    shape, x = _kind_inputs(kind, rng)
    y = rng.integers(0, C, x.shape[0]).astype(np.int32)
    w, b = _params_np(rng, shape)
    jcfg, tcfg = _cfgs(loss=loss, l2=1e-3)
    jp = jlm.LinearParams(jnp.asarray(w), jnp.asarray(b))
    jloss, jgrads = jax.value_and_grad(jlm._loss_fn)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg, jlm._LOGITS_FNS[kind])
    tp = tlm.LinearParams(torch.from_numpy(w), torch.from_numpy(b))
    tloss, tgrads = tlm.value_and_grad(
        tlm._loss_fn, tp, torch.from_numpy(x), torch.from_numpy(y), tcfg,
        tlm._LOGITS_FNS[kind])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for g, jg in zip(tgrads, jgrads):
        assert g.shape == jg.shape and g.dtype == torch.float32
        _close(g.numpy(), jg, GRAD_RTOL, GRAD_ATOL_OF_MAX)
    assert not tp.w.requires_grad          # the caller's leaves untouched


def test_logits_fns_match_reference():
    rng = np.random.default_rng(11)
    for kind in ("dense", "hashed", "bag"):
        shape, x = _kind_inputs(kind, rng)
        w, b = _params_np(rng, shape)
        want = jlm._LOGITS_FNS[kind](
            jlm.LinearParams(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x))
        got = tlm._LOGITS_FNS[kind](
            tlm.LinearParams(torch.from_numpy(w), torch.from_numpy(b)),
            torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        y = rng.integers(0, C, x.shape[0]).astype(np.int32)
        tparams = tlm.LinearParams(torch.from_numpy(w), torch.from_numpy(b))
        assert tlm.linear_accuracy(tparams, torch.from_numpy(x),
                                   torch.from_numpy(y), kind=kind) == \
            pytest.approx(jlm.linear_accuracy(
                jlm.LinearParams(jnp.asarray(w), jnp.asarray(b)),
                jnp.asarray(x), jnp.asarray(y), kind=kind))


def test_bag_backward_is_serial_in_position_order():
    """The bag gather's gradient adds each table row's contributions in
    position order from zero, on every call the same bits."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 7, (50, 6)).astype(np.int32)
    up = rng.standard_normal((50, 3)).astype(np.float32)
    want = np.zeros((7, 3), np.float32)
    for r in range(50):
        for j in range(6):
            want[idx[r, j]] += up[r]
    outs = []
    for _ in range(3):
        w = torch.zeros(7, 3, requires_grad=True)
        (tlm.bag_logits(tlm.LinearParams(w, torch.zeros(3)),
                        torch.from_numpy(idx)) * torch.from_numpy(up)
         ).sum().backward()
        outs.append(w.grad.numpy())
    for got in outs:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps_at", [(0, 1, 7, 19)])
def test_tx_step_from_reference_state(problem, steps_at):
    ds, jpipe, pipe = problem
    jfeats = jpipe.features(jnp.asarray(ds.x_train))
    y = jnp.asarray(ds.y_train)
    jcfg, tcfg = _cfgs(steps=20)
    jtx, ttx = jlm.make_linear_tx(jcfg), tlm.make_linear_tx(tcfg)
    jp = jlm.init_bag(jax.random.PRNGKey(0), jpipe.num_features, C)
    js = jtx.init(jp)
    jgrad = jax.jit(jax.grad(jlm._loss_fn), static_argnums=(3, 4))
    jupdate = jax.jit(jtx.update)
    feats = torch.from_numpy(np.asarray(jfeats).copy())
    for step in range(20):
        g = jgrad(jp, jfeats, y, jcfg, jlm.bag_logits)
        if step in steps_at:
            tp = interop.linear_params(np.asarray(jp.w), np.asarray(jp.b),
                                       device="cpu")
            ts = interop.linear_opt_state(
                jax.tree_util.tree_map(np.asarray, js), device="cpu")
            _, tg = tlm.value_and_grad(tlm._loss_fn, tp, feats,
                                       torch.tensor(ds.y_train), tcfg,
                                       tlm.bag_logits)
            for a, b in zip(tg, g):
                _close(a.numpy(), b, GRAD_RTOL, GRAD_ATOL_OF_MAX)
            gnp = tlm.LinearParams(*(torch.from_numpy(np.asarray(a).copy())
                                     for a in g))
            tu, ts2 = ttx.update(gnp, ts, tp, step)
            tp2 = topt.apply_updates(tp, tu)
            with jax.disable_jit():
                wu, ws = jtx.update(g, js, jp, jnp.int32(step))
                wp = jopt.apply_updates(jp, wu)
            # where the clip binds, its scale comes from each framework's
            # own sum of squares (the port's in float64)
            binds = np.sqrt(sum(np.sum(np.square(np.asarray(a, np.float64)))
                                for a in g)) > CLIP_NORM
            for jt, tt in ((wp, tp2), (ws[1].mu, ts2[1].mu),
                           (ws[1].nu, ts2[1].nu)):
                for a, b in zip(jt, tt):
                    if binds:
                        _close(b.numpy(), a, CLIP_RTOL, CLIP_ATOL_OF_MAX)
                    else:
                        np.testing.assert_array_equal(b.numpy(),
                                                      np.asarray(a))
        ju, js = jupdate(g, js, jp, jnp.int32(step))
        jp = jopt.apply_updates(jp, ju)
        if step in steps_at:
            for jt, tt in ((jp, tp2), (js[1].mu, ts2[1].mu),
                           (js[1].nu, ts2[1].nu)):
                for a, b in zip(jt, tt):
                    _close(b.numpy(), a, JIT_RTOL, JIT_ATOL_OF_MAX)


def _acc_pp(a, b):
    return 100 * abs(a - b)


def test_fits_match_reference_accuracy(problem):
    ds, jpipe, pipe = problem
    xtr, xte = jnp.asarray(ds.x_train), jnp.asarray(ds.x_test)
    ytr, yte = jnp.asarray(ds.y_train), jnp.asarray(ds.y_test)
    jf_tr, jf_te = jpipe.features(xtr), jpipe.features(xte)
    f_tr, f_te = pipe.features(ds.x_train), pipe.features(ds.x_test)
    np.testing.assert_array_equal(f_tr.numpy(), np.asarray(jf_tr))
    np.testing.assert_array_equal(f_te.numpy(), np.asarray(jf_te))
    t_ytr, t_yte = torch.tensor(ds.y_train), torch.tensor(ds.y_test)
    jp0 = jlm.init_bag(jax.random.PRNGKey(0), jpipe.num_features, C)
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    accs = {}
    for route, bs in (("full", 0), ("minibatch", 32)):
        jcfg, tcfg = _cfgs(batch_size=bs)
        jp = jlm.fit_linear(jp0, jf_tr, ytr, cfg=jcfg, kind="bag",
                            shuffle_key=jax.random.PRNGKey(5))
        tp = tlm.fit_linear(p0, f_tr, t_ytr, cfg=tcfg, kind="bag",
                            shuffle_key=prng_key(5))
        accs[route] = (tlm.linear_accuracy(tp, f_te, t_yte, kind="bag"),
                       jlm.linear_accuracy(jp, jf_te, yte, kind="bag"))
    jcfg, tcfg = _cfgs(batch_size=32)
    jp = jfit_streamed(jp0, jpipe, xtr, ytr, cfg=jcfg,
                       shuffle_key=jax.random.PRNGKey(5))
    tp = fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=tcfg,
                             shuffle_key=prng_key(5))
    accs["streamed"] = (streamed_accuracy(tp, pipe, ds.x_test, ds.y_test),
                        jstreamed_accuracy(jp, jpipe, xte, yte))
    for route, (got, want) in accs.items():
        assert want > 0.7, (route, want)          # the reference learned
        assert _acc_pp(got, want) <= ACC_PP, (route, got, want)
    assert float(p0.w.abs().sum()) == 0.0         # the init table untouched


def test_batch_size_n_bit_identical_to_full_batch(problem):
    ds, _, pipe = problem
    n = ds.x_train.shape[0]
    x, y = torch.tensor(ds.x_train), torch.tensor(ds.y_train)
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    feats = pipe.features(x)
    _, cfg0 = _cfgs(steps=40)
    _, cfgn = _cfgs(steps=40, batch_size=n)
    p_fb = tlm.fit_linear(p0, feats, y, cfg=cfg0, kind="bag")
    p_st = fit_linear_streamed(p0, pipe, x, y, cfg=cfgn)
    p_mn = tlm.fit_linear(p0, feats, y, cfg=cfgn, kind="bag")
    for p in (p_st, p_mn):
        assert torch.equal(p.w, p_fb.w) and torch.equal(p.b, p_fb.b)
    # microbatching the streamed full batch changes only the order of the
    # gradient sums, so it is close but need not be bit-identical
    p_mb = fit_linear_streamed(p0, pipe, x, y, cfg=cfgn, n_microbatches=2)
    assert tlm.linear_accuracy(p_mb, feats, y, kind="bag") == \
        pytest.approx(tlm.linear_accuracy(p_fb, feats, y, kind="bag"),
                      abs=ACC_PP / 100)


def test_streamed_walk_equals_minibatch_walk_and_host_rows(problem):
    ds, _, pipe = problem
    x, y = torch.tensor(ds.x_train), torch.tensor(ds.y_train)
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    _, cfg = _cfgs(steps=30, batch_size=32)
    key = prng_key(5)
    p_mat = tlm.fit_linear(p0, pipe.features(x), y, cfg=cfg, kind="bag",
                           shuffle_key=key)
    p_str = fit_linear_streamed(p0, pipe, x, y, cfg=cfg, shuffle_key=key)
    p_host = fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                 shuffle_key=key)
    for p in (p_str, p_host):
        assert torch.equal(p.w, p_mat.w) and torch.equal(p.b, p_mat.b)
    # and a true minibatch walk differs from full batch
    p_fb = tlm.fit_linear(p0, pipe.features(x), y, cfg=_cfgs(steps=30)[1],
                          kind="bag")
    assert not torch.equal(p_fb.w, p_mat.w)
    assert streamed_accuracy(p_host, pipe, ds.x_test, ds.y_test) == \
        streamed_accuracy(p_str, pipe, torch.tensor(ds.x_test),
                          torch.tensor(ds.y_test))


@pytest.mark.parametrize("stored", [False, True])
def test_packed_training_bit_identical_to_unpacked(problem, stored):
    ds, _, _ = problem
    b = SMOKE.b_i
    if stored:
        rng = np.random.default_rng(9)
        arrs = [np.exp(rng.standard_normal((SMOKE.dim, SMOKE.num_hashes)))
                .astype(np.float32) for _ in range(2)] + [
            rng.random((SMOKE.dim, SMOKE.num_hashes)).astype(np.float32)]
        make = lambda packed: FeaturePipeline.from_arrays(
            *arrs, FeatureSpec(SMOKE.num_hashes, b, packed=packed),
            device="cpu")
    else:
        make = lambda packed: FeaturePipeline.create_regen(
            prng_key(11), SMOKE.dim,
            FeatureSpec(SMOKE.num_hashes, b, packed=packed), device="cpu")
    unpacked, packed = make(False), make(True)
    p0 = tlm.init_bag_packed(SMOKE.num_hashes, b, C, device="cpu")
    _, cfg = _cfgs(steps=30, batch_size=32)
    outs = [fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                shuffle_key=prng_key(2))
            for pipe in (unpacked, packed)]
    assert torch.equal(outs[0].w, outs[1].w)
    assert torch.equal(outs[0].b, outs[1].b)
    assert streamed_accuracy(outs[1], packed, ds.x_test, ds.y_test) == \
        streamed_accuracy(outs[0], unpacked, ds.x_test, ds.y_test)


def test_port_trained_bundle_serves_in_reference(problem, tmp_path):
    ds, _, pipe = problem
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    _, cfg = _cfgs(steps=20, batch_size=40)
    params = fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg)
    export_served_model(params, pipe, tmp_path / "model")
    jparams, jpipe = jload(tmp_path / "model")
    assert jpipe.fingerprint() == pipe.fingerprint()
    x = ds.x_test[:17]
    jfeats = jpipe.features(jnp.asarray(x))
    np.testing.assert_array_equal(pipe.features(x).numpy(),
                                  np.asarray(jfeats))
    np.testing.assert_allclose(
        tlm.bag_logits(params, pipe.features(x)).numpy(),
        np.asarray(jlm.bag_logits(jparams, jfeats)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_microbatch_grads_match_reference(n_micro):
    rng = np.random.default_rng(n_micro)
    shape, x = _kind_inputs("bag", rng, n=48)
    y = rng.integers(0, C, 48).astype(np.int32)
    w, b = _params_np(rng, shape)
    jcfg, tcfg = _cfgs()
    jloss_fn = lambda p, i, l: (jlm._loss_fn(p, i, l, jcfg, jlm.bag_logits),
                                {})
    tloss_fn = lambda p, i, l: (tlm._loss_fn(p, i, l, tcfg, tlm.bag_logits),
                                {})
    jloss, _, jg = jmicrobatch_grads(
        jloss_fn, jlm.LinearParams(jnp.asarray(w), jnp.asarray(b)),
        {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)}, n_micro=n_micro)
    tp = tlm.LinearParams(torch.from_numpy(w), torch.from_numpy(b))
    tloss, _, tg = microbatch_grads(
        tloss_fn, tp, {"inputs": torch.from_numpy(x),
                       "labels": torch.from_numpy(y)}, n_micro=n_micro)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for a, bb in zip(tg, jg):
        _close(a.numpy(), bb, GRAD_RTOL, GRAD_ATOL_OF_MAX)
    if n_micro == 1:   # one value_and_grad on the whole batch
        _, g1 = tlm.value_and_grad(tlm._loss_fn, tp, torch.from_numpy(x),
                                   torch.from_numpy(y), tcfg, tlm.bag_logits)
        assert all(torch.equal(a, c) for a, c in zip(tg, g1))
    # the mean over a one-rank data axis changes nothing; an axis needs
    # its mesh; constrain= (the LM trainer's layout hook) sees each
    # microbatch's gradients once, before they are accumulated
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    mloss, _, mg = microbatch_grads(tloss_fn, tp, batch, n_micro=n_micro,
                                    axis_name="data", mesh=make_data_mesh(1))
    assert torch.equal(mloss, tloss)
    assert all(torch.equal(a, c) for a, c in zip(mg, tg))
    with pytest.raises(ValueError, match="mesh"):
        microbatch_grads(tloss_fn, tp, batch, axis_name="data")
    seen = []
    closs, _, cg = microbatch_grads(
        tloss_fn, tp, batch, n_micro=n_micro,
        constrain=lambda t: seen.append(t) or t)
    assert len(seen) == n_micro and torch.equal(closs, tloss)
    assert all(torch.equal(a, c) for a, c in zip(cg, tg))


def test_best_accuracy_sweeps_match_reference(problem):
    ds, jpipe, pipe = problem
    kw = dict(n_classes=C, steps=60, lr=0.05)
    xtr, xte = ds.x_train, ds.x_test
    ytr, yte = ds.y_train, ds.y_test
    T = lambda a: torch.from_numpy(np.asarray(a).copy())
    got = tlm.best_linear_accuracy_over_C(T(xtr), T(ytr), T(xte), T(yte),
                                          l2s=(1e-5, 1e-3), **kw)
    want = jlm.best_linear_accuracy_over_C(jnp.asarray(xtr), jnp.asarray(ytr),
                                           jnp.asarray(xte), jnp.asarray(yte),
                                           l2s=(1e-5, 1e-3), **kw)
    assert _acc_pp(got, want) <= ACC_PP
    jc_tr, jc_te = (jpipe.codes(jnp.asarray(a)) for a in (xtr, xte))
    width = 1 << SMOKE.b_i
    got = tlm.best_hashed_accuracy_over_C(
        T(jc_tr), T(ytr), T(jc_te), T(yte), k=SMOKE.num_hashes, width=width,
        l2s=(1e-5,), **kw)
    want = jlm.best_hashed_accuracy_over_C(
        jc_tr, jnp.asarray(ytr), jc_te, jnp.asarray(yte),
        k=SMOKE.num_hashes, width=width, l2s=(1e-5,), **kw)
    assert _acc_pp(got, want) <= ACC_PP
    jf_tr, jf_te = (jpipe.features(jnp.asarray(a)) for a in (xtr, xte))
    got = tlm.best_bag_accuracy_over_C(
        T(jf_tr), T(ytr), T(jf_te), T(yte), num_features=pipe.num_features,
        l2s=(1e-5,), **kw)
    want = jlm.best_bag_accuracy_over_C(
        jf_tr, jnp.asarray(ytr), jf_te, jnp.asarray(yte),
        num_features=pipe.num_features, l2s=(1e-5,), **kw)
    assert _acc_pp(got, want) <= ACC_PP
    with pytest.raises(ValueError, match="best_hashed"):
        tlm.best_linear_accuracy_over_C(T(xtr), T(ytr), T(xte), T(yte),
                                        kind="bag", **kw)


def test_watchdog_rides_the_loop_and_stops(problem):
    ds, _, pipe = problem
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    _, cfg = _cfgs(steps=5, batch_size=32)
    wd = StepWatchdog(hard_timeout_s=60.0)
    fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                        watchdog=wd)
    assert wd.events == []
    assert wd._monitor is None or not wd._monitor.is_alive()


def test_validation_and_unported_paths(problem, tmp_path):
    ds, _, pipe = problem
    x, y = ds.x_train, ds.y_train
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    _, cfg = _cfgs(steps=2, batch_size=32)
    # mesh=: the data axis is what the trainer shards over
    no_data = Mesh({"model": 1})
    with pytest.raises(ValueError, match="'data' axis"):
        fit_linear_streamed(p0, pipe, x, y, cfg=cfg, mesh=no_data)
    with pytest.raises(ValueError, match="'data' axis"):
        fit_linear_streamed_resilient(p0, pipe, x, y, cfg=cfg,
                                      ckpt=tmp_path / "r", ckpt_every=1,
                                      mesh=no_data)
    with pytest.raises(ValueError, match="'data' axis"):
        streamed_accuracy(p0, pipe, x, y, mesh=no_data)
    # checkpointed training: a dir holding a committed step wants the
    # resume, and a resume needs a committed step
    with pytest.raises(FileNotFoundError, match="no committed"):
        resume_linear_streamed(tmp_path / "empty", pipe, x, y, cfg=cfg)
    with pytest.raises(FileNotFoundError, match="no committed eval"):
        resume_streamed_accuracy(tmp_path / "empty", p0, pipe, x, y)
    fit_linear_streamed(p0, pipe, x, y, cfg=cfg, ckpt=tmp_path / "fit",
                        ckpt_every=1)
    with pytest.raises(ValueError, match="resume_linear_streamed"):
        fit_linear_streamed(p0, pipe, x, y, cfg=cfg, ckpt=tmp_path / "fit",
                            ckpt_every=5)
    streamed_accuracy(p0, pipe, x, y, ckpt=tmp_path / "eval", ckpt_every=1)
    with pytest.raises(ValueError, match="resume_streamed_accuracy"):
        streamed_accuracy(p0, pipe, x, y, ckpt=tmp_path / "eval",
                          ckpt_every=5)
    with pytest.raises(ValueError, match="batch_size"):
        fit_linear_streamed(p0, pipe, x, y, cfg=_cfgs(batch_size=0)[1])
    with pytest.raises(ValueError, match="exceeds"):
        fit_linear_streamed(p0, pipe, x, y, cfg=_cfgs(batch_size=161)[1])
    with pytest.raises(ValueError, match="microbatches"):
        fit_linear_streamed(p0, pipe, x, y, cfg=cfg, n_microbatches=5)
    with pytest.raises(ValueError, match="feature-table mismatch"):
        fit_linear_streamed(tlm.init_bag(7, C, device="cpu"), pipe, x, y,
                            cfg=cfg)
    with pytest.raises(ValueError, match="host"):
        fit_linear_streamed(p0, pipe, x, torch.from_numpy(y), cfg=cfg)
    feats = pipe.features(x)
    with pytest.raises(ValueError, match="batch_size must be >= 0"):
        tlm.fit_linear(p0, feats, torch.from_numpy(y),
                       cfg=_cfgs(batch_size=-1)[1], kind="bag")
    with pytest.raises(ValueError, match="exceeds"):
        tlm.fit_linear(p0, feats, torch.from_numpy(y),
                       cfg=_cfgs(batch_size=161)[1], kind="bag")
    assert streamed_accuracy(p0, pipe, x[:0], y[:0]) == 0.0


def test_different_devices_raise(problem):
    """A table, pipeline and data on different devices raise: nothing is
    moved quietly (the meta device stands in for a second device)."""
    ds, _, pipe = problem
    _, cfg = _cfgs(steps=2, batch_size=32)
    meta = tlm.LinearParams(torch.zeros(pipe.num_features, C,
                                        device="meta"),
                            torch.zeros(C, device="meta"))
    with pytest.raises(ValueError, match="different devices|pipeline on"):
        fit_linear_streamed(meta, pipe, ds.x_train, ds.y_train, cfg=cfg)
    p0 = tlm.init_bag(pipe.num_features, C, device="cpu")
    with pytest.raises(ValueError, match="different devices"):
        tlm.fit_linear(p0, torch.zeros(4, SMOKE.num_hashes, dtype=torch.int32,
                                       device="meta"),
                       torch.zeros(4, dtype=torch.int64),
                       cfg=_cfgs(steps=2)[1], kind="bag")
    with pytest.raises(ValueError, match="different devices"):
        fit_linear_streamed(p0, pipe, torch.tensor(ds.x_train),
                            torch.tensor(ds.y_train).to("meta"), cfg=cfg)
