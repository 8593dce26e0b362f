"""Port parity: embedding-bag scoring.

``bag_logits`` / ``bag_logits_packed`` against ``repro.core.linear_model``
on the same table and features.  Logits are float32 sums of k gathered
rows taken in another order by each framework, so they are compared with
rtol 1e-5 / atol 1e-6 (k <= 40 terms of magnitude ~1); the validation
errors must be raised where the reference raises them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import linear_model as jlm
from repro_torch import interop
from repro_torch.core import hashing as th
from repro_torch.core import linear_model as tlm

K, C = 40, 3


def _table(num_features, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((num_features, C)).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


@pytest.mark.parametrize("b_i", [1, 4, 8])
def test_bag_logits_matches_reference(b_i):
    w, b = _table(K << b_i)
    rng = np.random.default_rng(b_i)
    codes = rng.integers(-1, 1 << b_i, (11, K)).astype(np.int32)
    idx = np.asarray(jh.feature_indices(jnp.asarray(codes), b_i=b_i))
    want = np.asarray(jlm.bag_logits(jlm.LinearParams(jnp.asarray(w),
                                                      jnp.asarray(b)),
                                     jnp.asarray(idx)))
    got = tlm.bag_logits(interop.linear_params(w, b, device="cpu"),
                         torch.from_numpy(idx.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bag_logits_clamps_out_of_range_like_reference():
    w, b = _table(K * 2)
    idx = np.array([[-5, 3, 10 ** 6] + [0] * (K - 3)], np.int32)
    want = np.asarray(jlm.bag_logits(jlm.LinearParams(jnp.asarray(w),
                                                      jnp.asarray(b)),
                                     jnp.asarray(idx)))
    got = tlm.bag_logits(interop.linear_params(w, b, device="cpu"),
                         torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_bag_logits_packed_matches_reference(b):
    w, bias = _table(tlm.check_bag_table_size(K, b))
    rng = np.random.default_rng(b)
    codes = rng.integers(0, 1 << b, (9, K)).astype(np.int32)
    packed = np.asarray(jh.pack_codes(jnp.asarray(codes), b=b))
    want = np.asarray(jlm.bag_logits_packed(
        jlm.LinearParams(jnp.asarray(w), jnp.asarray(bias)),
        jnp.asarray(packed), num_hashes=K, b=b))
    params = interop.linear_params(w, bias, device="cpu")
    got = tlm.bag_logits_packed(params, th.pack_codes(
        torch.from_numpy(codes), b=b), num_hashes=K, b=b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # and equal to bag_logits on the unpacked global indices
    idx = th.feature_indices(torch.from_numpy(codes), b_i=b)
    torch.testing.assert_close(got, tlm.bag_logits(params, idx))


def _raises_both(jfn, tfn, match):
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_validation_errors_where_reference_raises():
    w, b = _table(K << 4)
    jp = jlm.LinearParams(jnp.asarray(w), jnp.asarray(b))
    tp = interop.linear_params(w, b, device="cpu")
    words = np.zeros((2, jh.packed_width(K, 4)), np.uint32)
    tw = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    # packed width mismatch
    _raises_both(lambda: jlm.bag_logits_packed(jp, jnp.asarray(words[:, 1:]),
                                               num_hashes=K, b=4),
                 lambda: tlm.bag_logits_packed(tp, tw[:, 1:], num_hashes=K,
                                               b=4), "width mismatch")
    # wrong dtype
    _raises_both(lambda: jlm.bag_logits_packed(
                     jp, jnp.asarray(words.view(np.int32)), num_hashes=K,
                     b=4),
                 lambda: tlm.bag_logits_packed(tp, tw.view(torch.int32),
                                               num_hashes=K, b=4), "uint32")
    # table sized for another b
    _raises_both(lambda: jlm.bag_logits_packed(
                     jp, jnp.asarray(np.zeros((2, jh.packed_width(K, 2)),
                                              np.uint32)),
                     num_hashes=K, b=2),
                 lambda: tlm.bag_logits_packed(
                     tp, th.pack_codes(torch.zeros((2, K), dtype=torch.int32),
                                       b=2), num_hashes=K, b=2),
                 "feature-table mismatch")
    # non-2D indices
    _raises_both(lambda: jlm.bag_logits(jp, jnp.zeros((K,), jnp.int32)),
                 lambda: tlm.bag_logits(tp, torch.zeros(K, dtype=torch.int32)),
                 r"\(n, k\)")
    # table/feature-space mismatch
    _raises_both(lambda: jlm.validate_bag_features(jp, (K << 4) + 1),
                 lambda: tlm.validate_bag_features(tp, (K << 4) + 1),
                 "mismatch")


def test_table_size_guard_matches_reference():
    for k, b in ((1 << 23, 8), (3, 4)):
        assert tlm.check_bag_table_size(k, b) == jlm.check_bag_table_size(k, b)
    _raises_both(lambda: jlm.check_bag_table_size((1 << 23) + 1, 8),
                 lambda: tlm.check_bag_table_size((1 << 23) + 1, 8),
                 "overflow")
    p = tlm.init_bag_packed(K, 4, C, device="cpu")
    assert p.w.shape == (K << 4, C) and float(p.w.abs().sum()) == 0.0
