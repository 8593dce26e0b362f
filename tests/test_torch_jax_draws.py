"""Port parity: ``jax.random``'s samplers and the reference's draws.

``repro_torch.core.regen``'s ``uniform``, ``bernoulli`` and ``randint``
against ``jax.random`` (threefry, partitionable) exactly: they are
integer arithmetic and single IEEE float32 steps.  ``exponential`` and
``normal`` go through log1p (and XLA's erfinv polynomial), where
PyTorch's CPU math and XLA's differ in the last bits: within 1 and 3
float32 ulps, with the share of bit-exact draws above a floor (measured
at 92.7% and 95.3%).  ``gamma`` / ``loggamma`` / ``dirichlet`` (the
Marsaglia-Tsang loop, one key an element) at alpha in {0.05, 0.3, 1, 2.5,
30}, scalar and batched: zeros exact, values within ``GAMMA_RTOL``
relative (``loggamma`` within ``GAMMA_ATOL``; measured 1.5e-5 at worst,
at alpha 0.05 where the boost raises a uniform to the 20th power), and
the draws that took another trip of the rejection loop than the
reference's (an ulp of ``log`` near the accept boundary; seen as a
relative error above 1e-3) counted: none of 300,000.  The datasets:
labels and zero patterns exact, values within 4e-5 relative (measured:
1.6e-5); ``make_histogram_mixture`` within ``MIX_ULPS`` float32 ulps,
the differing entries counted (``MIX_DIFFS``).
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
ALPHAS = (0.05, 0.3, 1.0, 2.5, 30.0)
N_GAMMA = 20_000
GAMMA_RTOL, GAMMA_ATOL = 3e-5, 3e-5
ANOTHER_TRIP = 0          # of 5 alphas x 3 seeds x 20,000 draws
# make_histogram_mixture(3, **kw): entries (train and test) that differ
# from the reference's in the last bits, all within MIX_ULPS; the Gamma
# draws' pow boost and exp(3 * normal) masses carry the samplers' ulps
MIX_ULPS = 512
MIX_DIFFS = {(): 185_184,
             (("dim", 16), ("n_classes", 4), ("n_test", 30),
              ("n_train", 50)): 835}


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
                    tsyn.CLASSIFICATION_SUITES[suite]())


@pytest.mark.parametrize("kw", (
    dict(seed=0),
    dict(seed=1, n_classes=10, density=0.15, mult_noise=1.2,
         spike_prob=0.08, name="template-hard"),
    dict(seed=2 ** 32 + 9, n_train=50, n_test=30, dim=40, n_classes=3)))
def test_template_classification_jax_draws(kw):
    kw = dict(kw)
    seed = kw.pop("seed")
    _assert_dataset(jsyn.make_template_classification(seed, **kw),
                    tsyn.make_template_classification(seed, **kw))


@pytest.mark.parametrize("seed", (2, 5))
def test_ratio_xor_jax_draws(seed):
    _assert_dataset(jsyn.make_ratio_xor(seed), tsyn.make_ratio_xor(seed))


def test_draws_default_and_refusals():
    """Table 1's suites are the generators at the reference's seeds, on
    the reference's draws; only ``make_template_classification`` keeps
    its numpy stream (the train phase's dataset, ROADMAP A16)."""
    a = tsyn.CLASSIFICATION_SUITES["template"]()
    b = tsyn.make_template_classification(0)
    np.testing.assert_array_equal(a.x_train, b.x_train)
    np.testing.assert_array_equal(
        tsyn.CLASSIFICATION_SUITES["ratio-xor"]().x_test,
        tsyn.make_ratio_xor(2).x_test)
    assert sorted(tsyn.CLASSIFICATION_SUITES) == \
        sorted(jsyn.CLASSIFICATION_SUITES)
    for fn in (tsyn.make_ratio_xor, tsyn.make_histogram_mixture):
        with pytest.raises(TypeError, match="draws"):
            fn(2, draws="numpy")
    c = tsyn.make_template_classification(0, draws="numpy")
    assert c.x_train.shape == a.x_train.shape
    assert not np.array_equal(c.x_train, a.x_train)
    np.testing.assert_array_equal(
        c.x_test, tsyn.make_template_classification(0, draws="numpy").x_test)
    with pytest.raises(ValueError, match="draws"):
        tsyn.make_template_classification(0, draws="torch")


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gamma_samplers_match_jax(seed):
    """``gamma`` and ``loggamma`` at each alpha, scalar alpha broadcast to
    N_GAMMA draws: zeros exact, values within the stated tolerances, the
    draws that took another trip counted."""
    jk, tk = _keys(seed)
    another = 0
    for alpha in ALPHAS:
        want = np.asarray(jax.random.gamma(jk, jnp.float32(alpha),
                                           (N_GAMMA,)))
        got = R.gamma(tk, alpha, (N_GAMMA,))
        assert got.dtype == torch.float32 and got.shape == (N_GAMMA,)
        got = got.numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        nz = want > 0
        rel = np.abs(got - want)[nz] / want[nz]
        another += int((rel > 1e-3).sum())
        assert (rel[rel <= 1e-3] <= GAMMA_RTOL).all(), (alpha, rel.max())
        lwant = np.asarray(jax.random.loggamma(jk, jnp.float32(alpha),
                                               (N_GAMMA,)))
        lgot = R.loggamma(tk, alpha, (N_GAMMA,)).numpy()
        assert np.abs(lgot - lwant).max() <= GAMMA_ATOL, alpha
    assert another == ANOTHER_TRIP


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_batched_gamma_and_dirichlet_match_jax(seed):
    """A (40, 17) array of alphas drawn from ALPHAS: ``gamma``,
    ``loggamma``, ``dirichlet`` over its last axis, and the hist-mix
    prototypes' Dirichlet (0.25 x 128, ten rows)."""
    jk, tk = _keys(seed)
    a = np.random.default_rng(seed).choice(np.float32(ALPHAS),
                                           (40, 17)).astype(np.float32)
    want = np.asarray(jax.random.gamma(jk, jnp.asarray(a)))
    got = R.gamma(tk, a).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=GAMMA_RTOL, atol=0)
    np.testing.assert_allclose(R.loggamma(tk, torch.from_numpy(a)).numpy(),
                               np.asarray(jax.random.loggamma(
                                   jk, jnp.asarray(a))),
                               rtol=0, atol=GAMMA_ATOL)
    for alpha, shape in ((a, None), (np.full(128, 0.25, np.float32), (10,))):
        want = np.asarray(jax.random.dirichlet(jk, jnp.asarray(alpha),
                                               shape))
        got = R.dirichlet(tk, alpha, shape).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=GAMMA_RTOL, atol=0)
    with pytest.raises(ValueError, match="ndim"):
        R.dirichlet(tk, np.float32(1.0))


@pytest.mark.parametrize("kw", [dict(k) for k in MIX_DIFFS],
                         ids=["hist-mix", "small"])
def test_histogram_mixture_jax_draws(kw):
    """``make_histogram_mixture(3)``: labels and the zero pattern (the
    Gamma boost's underflow, flushed as the reference's backend flushes)
    equal, every value within MIX_ULPS, the differing entries counted."""
    j, t = jsyn.make_histogram_mixture(3, **kw), \
        tsyn.make_histogram_mixture(3, **kw)
    _assert_dataset(j, t)
    got = np.concatenate([t.x_train, t.x_test])
    want = np.concatenate([j.x_train, j.x_test])
    np.testing.assert_array_max_ulp(got, want, maxulp=MIX_ULPS)
    assert int((got != want).sum()) == MIX_DIFFS[tuple(sorted(kw.items()))]
    if not kw:
        assert (want == 0).sum() == 2058     # 0.80% of the entries


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
    t = tsyn.CLASSIFICATION_SUITES["template-hard"]()
    xj = np.concatenate([j.x_train, j.x_test])
    xt = np.concatenate([t.x_train, t.x_test])
    assert xt.shape == (2000, 256)
    want = np.concatenate([np.asarray(j_cws_hash(jnp.asarray(xj[i:i + 200]),
                                                 want_p)[0])
                           for i in range(0, 2000, 200)])
    got = cws_hash(torch.from_numpy(xt), got_p)[0].numpy()
    np.testing.assert_array_equal(got, want)
