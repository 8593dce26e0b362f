"""Port parity: the min-sum Gram ops, the Table 1 Grams, the kernel SVM
and the synthetic datasets.

Inputs are made with numpy and handed to both packages.  ``min_sum`` /
``minmax_gram`` (the port's plain path, what a CPU tensor runs;
``chip_smoke.py`` holds the CUDA kernel against it on the card) are
compared with ``repro.kernels.ops`` in ``pallas-interpret`` mode with
small blocks (bm=8, bn=8, bd=16, ragged on every axis) and with its
``reference`` oracle.

Tolerances, from the arithmetic.  Every min-sum term is nonnegative, and
two recursive fp32 sums of the same D terms in different orders differ by
at most about 2·D·2^-24 of the sum; so ``|S_port - S_ref| <= 2·D·2^-24·S
+ 1e-30``.  A min-max entry is S over (sum x + sum y - S), each side off by
that much: relative 4·D·2^-24.  The sum-to-one Grams (n-min-max,
intersection) also normalise each row by a sum taken in another order:
relative 8·D·2^-24.  The linear Gram is a dot product of unit-L2 rows:
relative 8·D·2^-24 as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_svm as jsvm
from repro.core import kernels as jk
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import kernel_svm as tsvm
from repro_torch.core import kernels as tk
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

U = 2.0 ** -24
BLOCKS = dict(bm=8, bn=8, bd=16)


def _pair(m=19, n=13, d=23, seed=0, zero_rows=True):
    rng = np.random.default_rng(seed)

    def rows(r):
        a = (np.abs(rng.standard_normal((r, d))) *
             np.exp(rng.standard_normal((r, d)))).astype(np.float32)
        a *= rng.random((r, d)) < 0.6
        return a

    x, y = rows(m), rows(n)
    if zero_rows:
        x[3] = 0.0
        y[0] = 0.0
    return x, y


def assert_min_sum_close(got, want, d):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 2 * d * U * np.abs(want) + 1e-30
    assert (np.abs(got - want) <= bound).all(), \
        float((np.abs(got - want) / bound).max())


def assert_rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = rel * np.abs(want) + 1e-30
    assert (np.abs(got - want) <= bound).all(), \
        float((np.abs(got - want) / bound).max())


@pytest.mark.parametrize("impl", ["pallas-interpret", "reference"])
@pytest.mark.parametrize("shape", [(19, 13, 23), (8, 16, 32), (1, 5, 1)])
def test_min_sum_and_minmax_gram_match_reference(shape, impl):
    m, n, d = shape
    x, y = _pair(m, n, d, zero_rows=m > 3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = jops.min_sum(jnp.asarray(x), jnp.asarray(y), impl=impl, **BLOCKS)
    got = tops.min_sum(tx, ty)
    assert got.dtype == torch.float32
    assert_min_sum_close(got, want, d)
    want = jops.minmax_gram(jnp.asarray(x), jnp.asarray(y), impl=impl,
                            **BLOCKS)
    assert_rel_close(tops.minmax_gram(tx, ty), want, 4 * d * U)


def test_naive_oracles_match_reference_oracles():
    x, y = _pair(seed=1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert_min_sum_close(tref.min_sum_ref(tx, ty), jref.min_sum_ref(jx, jy),
                         x.shape[1])
    assert_rel_close(tref.minmax_gram_ref(tx, ty),
                     jref.minmax_gram_ref(jx, jy), 4 * x.shape[1] * U)
    # the min-sum identity (plain path) against the naive sum of maxima
    assert_rel_close(tops.minmax_gram(tx, ty), tref.minmax_gram_ref(tx, ty),
                     4 * x.shape[1] * U)


def test_minmax_gram_takes_nonnegative_parts():
    x, y = _pair(seed=2, zero_rows=False)
    x[1, :5] = -3.0
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert_rel_close(tops.minmax_gram(tx, ty),
                     jops.minmax_gram(jnp.asarray(x), jnp.asarray(y),
                                      impl="pallas-interpret", **BLOCKS),
                     4 * x.shape[1] * U)


GRAM_REL = {"linear": 8, "min-max": 4, "n-min-max": 8, "intersection": 8,
            "resemblance": 4}


@pytest.mark.parametrize("name", sorted(GRAM_REL))
def test_gram_fns_match_reference(name):
    assert sorted(tk.GRAM_FNS) == sorted(jk.GRAM_FNS) == sorted(GRAM_REL)
    x, y = _pair(seed=3)
    got = tk.GRAM_FNS[name](torch.from_numpy(x), torch.from_numpy(y))
    want = jk.GRAM_FNS[name](jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float32
    assert_rel_close(got, want, GRAM_REL[name] * x.shape[1] * U)


def test_pair_kernels_match_reference():
    x, _ = _pair(seed=4, zero_rows=False)
    u, v = x[0], x[1]
    for t_fn, j_fn in ((tk.minmax_pair, jk.minmax_pair),
                       (tk.resemblance_pair, jk.resemblance_pair)):
        got = float(t_fn(torch.from_numpy(u), torch.from_numpy(v)))
        want = float(j_fn(jnp.asarray(u), jnp.asarray(v)))
        assert abs(got - want) <= 4 * u.size * U * want


def _svm_problem(n_classes, n=40, d=12, seed=5):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n + 20, d))).astype(np.float32)
    y = rng.integers(0, n_classes, n + 20).astype(np.int32)
    x[np.arange(n + 20), y % d] += 2.0      # learnable class signal
    K = np.array(jk.minmax_gram(jnp.asarray(x), jnp.asarray(x[:n])))
    return K[:n], K[n:], y[:n], y[n:]


@pytest.mark.parametrize("n_classes", [2, 3])
def test_dual_coefficients_match_reference(n_classes):
    """Same coordinate steps in the same order: the dual coefficients
    after 3 sweeps agree to float32 rounding carried through 120 steps
    (atol 1e-5 on coefficients of order 0.1-10, rtol 1e-4)."""
    K, _, y, _ = _svm_problem(n_classes)
    for C in (0.1, 10.0):
        want = jsvm.fit_kernel_svm(jnp.asarray(K), jnp.asarray(y), C=C,
                                   sweeps=3, n_classes=n_classes)
        got = tsvm.fit_kernel_svm(torch.from_numpy(K), torch.from_numpy(y),
                                  C=C, sweeps=3, n_classes=n_classes)
        assert tuple(got.alpha.shape) == want.alpha.shape
        np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got.y_signed.numpy(),
                                      np.asarray(want.y_signed))


def test_c_grid_batch_equals_separate_fits():
    K, _, y, _ = _svm_problem(3)
    Cs = (0.01, 1.0, 1000.0)
    tK, ty = torch.from_numpy(K), torch.from_numpy(y)
    batch = tsvm.fit_kernel_svm_grid(tK, ty, Cs=Cs, sweeps=4, n_classes=3)
    for C, model in zip(Cs, batch):
        alone = tsvm.fit_kernel_svm(tK, ty, C=C, sweeps=4, n_classes=3)
        torch.testing.assert_close(model.alpha, alone.alpha, rtol=0, atol=0)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_decision_values_on_carried_coefficients(n_classes):
    """The reference's model carried across by ``interop.svm_model``:
    decision values are one (m, n) x (n, C) product in each package
    (rtol 1e-5, atol 1e-5), and the predictions agree."""
    K, K_test, y, _ = _svm_problem(n_classes)
    jm = jsvm.fit_kernel_svm(jnp.asarray(K), jnp.asarray(y), C=1.0,
                             sweeps=5, n_classes=n_classes)
    tm = interop.svm_model(np.asarray(jm.alpha), np.asarray(jm.y_signed),
                           np.asarray(jm.classes), device="cpu")
    got = tsvm.decision_values(tm, torch.from_numpy(K_test)).numpy()
    want = np.asarray(jsvm.decision_values(jm, jnp.asarray(K_test)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tsvm.predict(tm, torch.from_numpy(K_test)).numpy(),
        np.asarray(jsvm.predict(jm, jnp.asarray(K_test))))


def test_accuracy_on_reference_suite():
    """Table 1's path on a small JAX-generated template suite handed over
    as arrays: per kernel, the best accuracy over the C grid is within one
    test row (1/80) of the reference's, and min-max beats linear."""
    ds = jsyn.make_template_classification(0, n_train=120, n_test=80,
                                           dim=32)
    best = {}
    for name in ("linear", "min-max"):
        accs = []
        for gram, svm, arr in ((jk.GRAM_FNS[name], jsvm, jnp.asarray),
                               (tk.GRAM_FNS[name], tsvm, torch.tensor)):
            xtr, xte = arr(ds.x_train), arr(ds.x_test)
            acc, _ = svm.best_accuracy_over_C(
                gram(xtr, xtr), gram(xte, xtr), arr(ds.y_train),
                arr(ds.y_test), n_classes=ds.n_classes, sweeps=10)
            accs.append(acc)
        assert abs(accs[0] - accs[1]) <= 1 / 80 + 1e-6, (name, accs)
        best[name] = accs[1]
    assert best["min-max"] >= best["linear"]


def test_word_pairs_bit_identical():
    for name in tsyn.WORD_PAIRS:
        for a, b in zip(tsyn.word_pair(name, n_docs=4096),
                        jsyn.word_pair(name, n_docs=4096)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(tsyn.word_pair("CREDIT-CARD"),
                    jsyn.word_pair("CREDIT-CARD")):
        assert a.shape == (2 ** 16,) and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(tsyn.CLASSIFICATION_SUITES))
def test_classification_suites_have_reference_shapes(name):
    """numpy-drawn suites: same shapes, dtypes, class counts and
    nonnegativity as the reference's, and deterministic."""
    got = tsyn.CLASSIFICATION_SUITES[name]()
    again = tsyn.CLASSIFICATION_SUITES[name]()
    want = jsyn.CLASSIFICATION_SUITES[name]()
    assert got.n_classes == want.n_classes and got.name == want.name
    for f in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, getattr(again, f))
    assert (got.x_train >= 0).all() and (got.x_test >= 0).all()
    assert set(np.unique(got.y_train)) == set(range(got.n_classes))
    if name == "ratio-xor":     # the label is the XOR of the dominances
        x = got.x_train
        np.testing.assert_array_equal(
            got.y_train, (x[:, 0] > x[:, 1]) ^ (x[:, 2] > x[:, 3]))
