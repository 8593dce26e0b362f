"""Port parity: CWS sample encodings and the packed code format.

All integer math, so ``repro_torch.core.hashing`` must equal
``repro.core.hashing`` exactly: sentinels (-1 for all-zero rows), the
bucket-0 fold, ragged k*b, and zero pad bits in the last packed word.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th


def _hashes(n=9, k=23, seed=0):
    rng = np.random.default_rng(seed)
    i_star = rng.integers(0, 5000, (n, k)).astype(np.int32)
    t_star = rng.integers(-2 ** 30, 2 ** 30, (n, k)).astype(np.int32)
    i_star[2] = -1          # all-zero row: sentinel i*, t* = 0
    t_star[2] = 0
    return i_star, t_star


@pytest.mark.parametrize("b_i", [0, 1, 4, 8])
@pytest.mark.parametrize("b_t", [0, 1, 2])
def test_encode_exact(b_i, b_t):
    i_star, t_star = _hashes()
    want = np.asarray(jh.encode(jnp.asarray(i_star), jnp.asarray(t_star),
                                b_i=b_i, b_t=b_t))
    got = th.encode(torch.from_numpy(i_star), torch.from_numpy(t_star),
                    b_i=b_i, b_t=b_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[2] == -1).all()


@pytest.mark.parametrize("b_i,b_t", [(1, 0), (4, 2), (8, 0)])
def test_feature_indices_exact(b_i, b_t):
    i_star, t_star = _hashes()
    codes = np.array(jh.encode(jnp.asarray(i_star), jnp.asarray(t_star),
                               b_i=b_i, b_t=b_t))
    want = np.asarray(jh.feature_indices(jnp.asarray(codes), b_i=b_i,
                                         b_t=b_t))
    got = th.feature_indices(torch.from_numpy(codes), b_i=b_i, b_t=b_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert th.hashed_dim(23, b_i, b_t) == jh.hashed_dim(23, b_i, b_t)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 23, 64])
def test_pack_unpack_exact(b, k):
    rng = np.random.default_rng(b * 100 + k)
    codes = rng.integers(-1, 1 << b, (6, k)).astype(np.int32)   # -1: sentinel
    want = np.asarray(jh.pack_codes(jnp.asarray(codes), b=b))
    got = th.pack_codes(torch.from_numpy(codes), b=b)
    assert got.dtype == torch.uint32
    assert got.shape == (6, th.packed_width(k, b)) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # pad bits past code k-1 in the last word are zero
    cpw = 32 // b
    used = k - (th.packed_width(k, b) - 1) * cpw
    if used < cpw:
        assert (got.numpy()[:, -1] >> np.uint32(used * b) == 0).all()
    back = th.unpack_codes(got, k, b=b)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jh.unpack_codes(jnp.asarray(want), k, b=b)))
    np.testing.assert_array_equal(back.numpy(), np.maximum(codes, 0))


def test_packed_format_guards():
    with pytest.raises(ValueError, match="packed encoding"):
        th.check_packed_bits(3)
    assert [th.check_packed_bits(b) for b in th.PACKED_BITS] == \
        [jh.check_packed_bits(b) for b in jh.PACKED_BITS]
    with pytest.raises(ValueError, match="width mismatch"):
        th.unpack_codes(torch.zeros((2, 3), dtype=torch.int32).view(
            torch.uint32), 40, b=4)
