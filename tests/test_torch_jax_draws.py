"""Port parity: ``jax.random``'s samplers and the reference's draws.

``repro_torch.core.regen``'s ``uniform``, ``bernoulli`` and ``randint``
against ``jax.random`` (threefry, partitionable) exactly: they are
integer arithmetic and single IEEE float32 steps.  ``exponential`` and
``normal`` go through log1p (and XLA's erfinv polynomial), where
PyTorch's CPU math and XLA's differ in the last bits: within 1 and 3
float32 ulps, with the share of bit-exact draws above a floor (measured
at 92.7% and 95.3%).  The datasets of ``draws="jax"``: labels and zero
patterns exact, values within 4e-5 relative (measured: 1.6e-5).
``make_cws_params_jax``: beta exact, r within 2 ulps, log c within
2^-21 (measured 2^-22), and the CWS i* of fig78's 2,000 rows at
k = 1,024 equal to the reference's on every (row, hash).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cws import cws_hash_reference as j_cws_hash
from repro.core.cws import make_cws_params
from repro.data import synthetic as jsyn
from repro_torch.core import cws_hash, make_cws_params_jax
from repro_torch.core import regen as R
from repro_torch.data import synthetic as tsyn

SEEDS = (0, 7, 2 ** 31 - 1, 2 ** 40 + 5)
SHAPES = ((1000,), (37, 29), (3, 5, 7))
N_FLOAT = 200_000
DATA_RTOL = 4e-5


def _keys(seed):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    return k, np.asarray(k)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_exact(seed, shape):
    jk, tk = _keys(seed)
    got = R.uniform(tk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(
        R.uniform(tk, shape, lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=1.0)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", (0.08, 0.15, 0.5, 0.9))
def test_bernoulli_exact(seed, shape, p):
    jk, tk = _keys(seed)
    got = R.bernoulli(tk, p, shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.bernoulli(jk, p,
                                                                  shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", ((0, 6), (0, 10), (3, 4), (5, 5),
                                    (-5, 1_000_003), (0, 2 ** 31 - 1),
                                    (-2 ** 31, 2 ** 31 - 1)))
def test_randint_exact(seed, bounds):
    # spans that are not powers of two, one whose 2^16 mod span squared
    # wraps in uint32, and the empty range (jax returns minval)
    jk, tk = _keys(seed)
    for shape in SHAPES[:2]:
        got = R.randint(tk, shape, *bounds)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(jk, shape, *bounds)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sampler,max_ulps,exact_floor", (
    ("exponential", 1, 0.90), ("normal", 3, 0.93)))
def test_float_samplers_within_ulps(seed, sampler, max_ulps, exact_floor):
    jk, tk = _keys(seed)
    got = getattr(R, sampler)(tk, (N_FLOAT,)).numpy()
    want = np.asarray(getattr(jax.random, sampler)(jk, (N_FLOAT,)))
    assert np.all(np.sign(got) == np.sign(want))
    ulps = _ulps(got, want)
    assert ulps.max() <= max_ulps, ulps.max()
    assert (ulps == 0).mean() >= exact_floor, (ulps == 0).mean()


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0, 0.5, -0.999999],
                     dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = R.erfinv(x).numpy()
    assert np.isinf(got[:2]).all() and np.array_equal(got[:2], want[:2])
    assert (_ulps(got[2:], want[2:]) <= 3).all()


def _assert_dataset(j, t):
    assert (j.name, j.n_classes) == (t.name, t.n_classes)
    for f in ("y_train", "y_test"):
        assert getattr(t, f).dtype == np.int32
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for f in ("x_train", "x_test"):
        a, b = getattr(j, f), getattr(t, f)
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_array_equal(b == 0, a == 0)
        np.testing.assert_allclose(b, a, rtol=DATA_RTOL, atol=0)


@pytest.mark.parametrize("suite", ("template", "template-hard", "ratio-xor"))
def test_classification_suites_jax_draws(suite):
    _assert_dataset(jsyn.CLASSIFICATION_SUITES[suite](),
                    tsyn.classification_suite(suite, draws="jax"))


@pytest.mark.parametrize("kw", (
    dict(seed=0),
    dict(seed=1, n_classes=10, density=0.15, mult_noise=1.2,
         spike_prob=0.08, name="template-hard"),
    dict(seed=2 ** 32 + 9, n_train=50, n_test=30, dim=40, n_classes=3)))
def test_template_classification_jax_draws(kw):
    kw = dict(kw)
    seed = kw.pop("seed")
    _assert_dataset(jsyn.make_template_classification(seed, **kw),
                    tsyn.make_template_classification(seed, draws="jax",
                                                      **kw))


@pytest.mark.parametrize("seed", (2, 5))
def test_ratio_xor_jax_draws(seed):
    _assert_dataset(jsyn.make_ratio_xor(seed), tsyn.make_ratio_xor(
        seed, draws="jax"))


def test_draws_default_and_refusals():
    a = tsyn.CLASSIFICATION_SUITES["template"]()
    b = tsyn.make_template_classification(0, draws="numpy")
    np.testing.assert_array_equal(a.x_train, b.x_train)
    np.testing.assert_array_equal(
        tsyn.classification_suite("ratio-xor").x_test,
        tsyn.make_ratio_xor(2).x_test)
    with pytest.raises(NotImplementedError, match="A15"):
        tsyn.make_histogram_mixture(3, draws="jax")
    with pytest.raises(NotImplementedError, match="A15"):
        tsyn.classification_suite("hist-mix", draws="jax")
    with pytest.raises(ValueError, match="draws"):
        tsyn.make_ratio_xor(2, draws="torch")


@pytest.fixture(scope="module")
def fig78_params():
    return (make_cws_params(jax.random.PRNGKey(0), 256, 1024),
            make_cws_params_jax(R.prng_key(0), 256, 1024))


def test_make_cws_params_jax(fig78_params):
    want, got = fig78_params
    for m in (got.r, got.log_c, got.beta):
        assert m.dtype == torch.float32 and tuple(m.shape) == (256, 1024)
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    assert _ulps(got.r.numpy(), want.r).max() <= 2
    assert np.abs(got.log_c.numpy() - np.asarray(want.log_c)).max() \
        <= 2.0 ** -21
    # a smaller draw is not a prefix of a larger one: the shape is part
    # of the stream, as in the reference
    small = make_cws_params_jax(R.prng_key(0), 256, 128)
    np.testing.assert_array_equal(small.beta.numpy(), np.asarray(
        make_cws_params(jax.random.PRNGKey(0), 256, 128).beta))


def test_fig78_istar_equal_at_full_width(fig78_params):
    # fig78's rows (template-hard, 1,200 + 800) and parameters (k = 1,024)
    # both rebuilt: every (row, hash) i* is the reference's
    want_p, got_p = fig78_params
    j = jsyn.CLASSIFICATION_SUITES["template-hard"]()
    t = tsyn.classification_suite("template-hard", draws="jax")
    xj = np.concatenate([j.x_train, j.x_test])
    xt = np.concatenate([t.x_train, t.x_test])
    assert xt.shape == (2000, 256)
    want = np.concatenate([np.asarray(j_cws_hash(jnp.asarray(xj[i:i + 200]),
                                                 want_p)[0])
                           for i in range(0, 2000, 200)])
    got = cws_hash(torch.from_numpy(xt), got_p)[0].numpy()
    np.testing.assert_array_equal(got, want)
