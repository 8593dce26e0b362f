"""Port parity: the collision estimators and the Figs 4-5 estimator slice.

``encode_tstar_only``, ``collision_estimate`` and
``full_collision_estimate`` are integer comparisons and means of 0/1
values over k < 2^24 hashes (exact in float32), so they must equal
``repro.core.hashing``'s exactly.  The slice runs the estimator as
``benchmarks/fig45_cws_mse.py`` does, at a small size: a word pair,
compacted to its union support; K from the min-max Gram; Monte-Carlo reps
of ``pipe.with_key(key).hashes(x)`` on a param-free pipeline; the full,
0-bit and 1-bit estimates.  Each rep's (i*, t*) must equal the
reference's (up to the near-tie escape of ``test_torch_cws_hash.py``), so
the estimates do too; K agrees within the min-max tolerance 4·D·2^-24.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import kernels as jk
from repro.core.cws import make_cws_params
from repro.core.regen import regen_params
from repro.data import synthetic as jsyn
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro_torch import interop
from repro_torch.core import hashing as th
from repro_torch.core import kernels as tk
from repro_torch.data import synthetic as tsyn
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from test_torch_cws_hash import assert_raw_exact_or_near_tie

U = 2.0 ** -24


def _hashes(n=6, k=29, seed=0):
    rng = np.random.default_rng(seed)
    i_star = rng.integers(0, 300, (n, k)).astype(np.int32)
    t_star = rng.integers(-2 ** 30, 2 ** 30 + 1, (n, k)).astype(np.int32)
    t_star[1, :4] = [2 ** 30, -2 ** 30, 2 ** 30 - 1, -1]   # wrap at b_i > 1
    i_star[2], t_star[2] = -1, 0                          # all-zero row
    return i_star, t_star


@pytest.mark.parametrize("b_i", [0, 1, 4, 8])
def test_encode_tstar_only_exact(b_i):
    i_star, t_star = _hashes()
    want = np.asarray(jh.encode_tstar_only(jnp.asarray(i_star),
                                           jnp.asarray(t_star), b_i=b_i))
    got = th.encode_tstar_only(torch.from_numpy(i_star),
                               torch.from_numpy(t_star), b_i=b_i)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_collision_estimates_exact():
    i_u, t_u = _hashes(seed=1)
    i_v, t_v = i_u.copy(), t_u.copy()
    rng = np.random.default_rng(2)
    flip = rng.random(i_v.shape) < 0.4
    i_v[flip] += 1
    t_v[rng.random(t_v.shape) < 0.3] ^= 1
    args = (i_u, t_u, i_v, t_v)
    want = np.asarray(jh.full_collision_estimate(*map(jnp.asarray, args)))
    got = th.full_collision_estimate(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jh.collision_estimate(jnp.asarray(i_u),
                                            jnp.asarray(i_v)))
    got = th.collision_estimate(torch.from_numpy(i_u), torch.from_numpy(i_v))
    assert got.dtype == torch.float32 and got.shape == (i_u.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b_i,b_t", [(0, 0), (1, 1), (4, 2)])
def test_pipeline_hashes_and_codes_stored(b_i, b_t):
    """A stored-parameter pipeline's ``hashes`` / ``codes`` (b_i = 0 specs
    are allowed here, as in the reference) against the reference's."""
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((9, 17))).astype(np.float32)
    x *= rng.random(x.shape) < 0.5
    x[5] = 0.0
    jp = make_cws_params(jax.random.PRNGKey(8), 17, 33)
    jpipe = JPipe(jp, JSpec(num_hashes=33, b_i=b_i, b_t=b_t))
    pipe = FeaturePipeline(
        interop.cws_params(np.asarray(jp.r), np.asarray(jp.log_c),
                           np.asarray(jp.beta), device="cpu"),
        FeatureSpec(num_hashes=33, b_i=b_i, b_t=b_t))
    want = jpipe.hashes(jnp.asarray(x))
    got = pipe.hashes(x)
    assert_raw_exact_or_near_tie([g.numpy() for g in got], want, x,
                                 (jp.r, jp.log_c, jp.beta))
    codes = pipe.codes(x)
    assert (codes[5] == -1).all()
    if all((g.numpy() == np.asarray(w)).all() for g, w in zip(got, want)):
        np.testing.assert_array_equal(codes.numpy(),
                                      np.asarray(jpipe.codes(jnp.asarray(x))))
    empty = pipe.hashes(np.zeros((0, 17), np.float32))
    assert empty[0].shape == empty[1].shape == (0, 33)
    assert empty[0].dtype == torch.int32


def test_estimator_slice_matches_reference():
    n_docs, k, reps = 1024, 64, 3
    u, v = tsyn.word_pair("HONG-KONG", n_docs=n_docs)
    support = np.flatnonzero((u > 0) | (v > 0))
    x = np.stack([u[support], v[support]])
    d = x.shape[1]
    ju, jv = jsyn.word_pair("HONG-KONG", n_docs=n_docs)
    np.testing.assert_array_equal(x, np.stack([ju[support], jv[support]]))

    k_true = float(tk.minmax_gram(torch.from_numpy(x[:1]),
                                  torch.from_numpy(x[1:]))[0, 0])
    want_k = float(jk.minmax_pair(jnp.asarray(x[0]), jnp.asarray(x[1])))
    assert abs(k_true - want_k) <= 4 * d * U * want_k

    keys = np.random.default_rng(9).integers(0, 2 ** 32, (reps, 2),
                                             dtype=np.uint64)
    keys = keys.astype(np.uint32)
    spec = FeatureSpec(num_hashes=k, b_i=1)
    pipe = FeaturePipeline.create_regen(keys[0], d, spec, device="cpu")
    jpipe = JPipe.create_regen(jnp.asarray(keys[0]), d,
                               JSpec(num_hashes=k, b_i=1))
    ests = []
    for key in keys:
        i_s, t_s = pipe.with_key(key).hashes(x)
        want = jpipe.with_key(jnp.asarray(key)).hashes(jnp.asarray(x))
        jp = regen_params(jnp.asarray(key), d, k)
        assert_raw_exact_or_near_tie([i_s.numpy(), t_s.numpy()], want, x,
                                     (jp.r, jp.log_c, jp.beta))
        est_full = th.full_collision_estimate(i_s[0], t_s[0], i_s[1], t_s[1])
        est_0bit = th.collision_estimate(i_s[0], i_s[1])
        one = pipe.with_key(key).codes(x)            # b_i = 1: i* parity
        assert (one == (i_s & 1)).all()
        est_1bit = th.full_collision_estimate(i_s[0], t_s[0] & 1,
                                              i_s[1], t_s[1] & 1)
        assert 0.0 <= float(est_full) <= float(est_1bit) <= 1.0
        assert float(est_full) <= float(est_0bit)
        ests.append(float(est_0bit))
    # 0-bit estimates of K: within 4 binomial standard deviations
    sd = np.sqrt(want_k * (1 - want_k) / k)
    assert abs(np.mean(ests) - want_k) < 4 * sd
