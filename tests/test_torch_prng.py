"""Port parity: the reference's key arithmetic.

``repro_torch.core.regen``'s ``prng_key``, ``fold_in``, ``split``,
``random_bits32`` and ``permutation`` against ``jax.random`` (threefry,
``jax_threefry_partitionable`` on) on the same seeds.  All of it is
integer arithmetic, so every word and every position must match exactly:
the port walks the reference's epoch shuffles, with no permutation
handed over.  The sizes straddle the boundary where ``permutation`` goes
from one sort round to two (n = 1,625 / 1,626) and include 60,000 rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import regen as R

# 2^32, 2^40 + 5 and -1: the reference keeps a seed's low 32 bits (64-bit
# types off), in two's complement below 0
SEEDS = (0, 7, 2 ** 31 - 1, 2 ** 32, 2 ** 40 + 5, -1)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_partitionable_threefry_is_the_reference_default():
    # the words below are those of the partitionable threefry
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_words(seed):
    np.testing.assert_array_equal(R.prng_key(seed),
                                  np.asarray(_jkey(seed)))
    assert R.prng_key(seed).dtype == np.uint32


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", (0, 1, 3, 499, 2 ** 32 - 1))
def test_fold_in_exact(seed, data):
    want = np.asarray(jax.random.fold_in(_jkey(seed), np.uint32(data)))
    np.testing.assert_array_equal(R.fold_in(R.prng_key(seed), data), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (2, 3, 5))
def test_split_exact(seed, num):
    want = np.asarray(jax.random.split(_jkey(seed), num))
    np.testing.assert_array_equal(R.split(R.prng_key(seed), num), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits32_exact(seed):
    key = jax.random.fold_in(_jkey(seed), 2)
    want = np.asarray(jax.random.bits(key, (1000,), jnp.uint32))
    got = R.random_bits32(np.asarray(key), 1000)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("epoch", (0, 3))
@pytest.mark.parametrize("n", (1, 2, 100, 1625, 1626, 60000))
def test_epoch_permutation_exact(seed, epoch, n):
    want = np.asarray(jax.random.permutation(
        jax.random.fold_in(_jkey(seed), epoch), n))
    got = R.permutation(R.fold_in(R.prng_key(seed), epoch), n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_permutation_round_count_boundary():
    # 1,625 rows take one sort round and 1,626 two, in the reference's
    # float64 arithmetic: the boundary the tests above straddle
    rounds = lambda n: int(np.ceil(3 * np.log(n) /
                                   np.log(np.iinfo(np.uint32).max)))
    assert (rounds(1625), rounds(1626)) == (1, 2)


def test_permutation_is_a_permutation():
    got = R.permutation(R.prng_key(3), 777)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert sorted(got.tolist()) == list(range(777))


def test_prng_key_rejects_negative_seed():
    # a negative seed within int64 is taken in two's complement (-1 is in
    # SEEDS); one below int64 is refused, as the reference refuses it
    for seed in (-2 ** 63 - 1, -2 ** 64):
        with pytest.raises(OverflowError):
            _jkey(seed)
        with pytest.raises(OverflowError, match="int64"):
            R.prng_key(seed)


@pytest.mark.parametrize("seed", (2 ** 63, 2 ** 64 - 1))
def test_prng_key_rejects_seeds_beyond_int64(seed):
    with pytest.raises(OverflowError):
        _jkey(seed)
    with pytest.raises(OverflowError, match="int64"):
        R.prng_key(seed)


@pytest.mark.parametrize("seed", (-2 ** 63, 2 ** 63 - 1, 2 ** 32 - 1))
def test_prng_key_int64_edges(seed):
    np.testing.assert_array_equal(R.prng_key(seed),
                                  np.asarray(_jkey(seed)))
