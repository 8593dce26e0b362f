"""Port parity: counter-based CWS parameter regeneration.

``repro_torch.core.regen`` against ``repro.core.regen`` on the same key
words and coordinates (handed over as numpy):
  * threefry words and the 24-bit uniforms (beta) are integer math and
    must match exactly;
  * r and log_c go through log1p / log, whose CPU implementations differ
    between the two frameworks by up to 2 ulp (torch's vs XLA's), so r is
    held within 4 ulp (two log1p terms summed) and log_c within an
    absolute 1e-6 (a 2-ulp change of c near 1 moves log c by ~2.4e-7,
    plus one ulp of the log itself).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regen as jregen
from repro_torch.core import regen as tregen

KEYS = [(0, 0), (0x12345678, 0x9ABCDEF0), (0xFFFFFFFF, 0x00000001)]


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("k0,k1", KEYS)
def test_threefry_words_exact(k0, k1):
    rng = np.random.default_rng(k0 ^ k1)
    x0 = rng.integers(0, 2 ** 32, (17, 9), dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2 ** 32, (17, 9), dtype=np.uint64).astype(np.uint32)
    j0, j1 = jregen.threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                                 jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = tregen.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                                 torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


def test_uniforms_exact():
    bits = np.random.default_rng(3).integers(0, 2 ** 32, 4096,
                                             dtype=np.uint64)
    j = np.asarray(jregen._uniform(jnp.asarray(bits.astype(np.uint32))))
    t = tregen._uniform(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.float32 and t.min() >= 0 and t.max() < 1


@pytest.mark.parametrize("k0,k1", KEYS)
@pytest.mark.parametrize("d0,kh0,bd,bk", [(0, 0, 33, 21), (7, 130, 16, 40)])
def test_regen_tile_matches_reference(k0, k1, d0, kh0, bd, bk):
    jr, jlc, jbe = (np.asarray(a) for a in jregen.regen_tile(
        jnp.uint32(k0), jnp.uint32(k1), d0, kh0, bd, bk))
    tr, tlc, tbe = (a.numpy() for a in tregen.regen_tile(k0, k1, d0, kh0,
                                                         bd, bk))
    np.testing.assert_array_equal(tbe, jbe)
    assert _ulp_diff(tr, jr).max() <= 4
    np.testing.assert_allclose(tlc, jlc, rtol=0, atol=1e-6)
    assert tr.min() >= np.float32(1e-12)


def test_tile_decomposition_invariance():
    """Global coordinates: any tiling of (D, k) gives the same params."""
    full = tregen.regen_tile(5, 9, 0, 0, 24, 40)
    part = tregen.regen_tile(5, 9, 8, 16, 10, 20)
    for f, p in zip(full, part):
        torch.testing.assert_close(p, f[8:18, 16:36], rtol=0, atol=0)


def test_key_words_from_numpy_tensor_and_jax_key():
    kw = np.asarray(jax.random.key_data(jax.random.PRNGKey(42)), np.uint32)
    expect = tuple(int(w) for w in kw)
    assert tregen.key_words(kw) == expect
    assert tregen.key_words(torch.from_numpy(kw.astype(np.int64))) == expect
    assert tuple(int(w) for w in jregen.key_words(
        jax.random.PRNGKey(42))) == expect
    with pytest.raises(ValueError, match="two uint32"):
        tregen.key_words(np.zeros(3, np.uint32))


def test_regen_params_matches_reference_shape_and_beta():
    kw = np.array([11, 22], np.uint32)
    jp = jregen.regen_params(jnp.asarray(kw), 12, 30)
    tp = tregen.regen_params(kw, 12, 30, device="cpu")
    assert tp.r.shape == (12, 30) and tp.num_hashes == 30 and tp.dim == 12
    np.testing.assert_array_equal(tp.beta.numpy(), np.asarray(jp.beta))
    assert _ulp_diff(tp.r.numpy(), np.asarray(jp.r)).max() <= 4
