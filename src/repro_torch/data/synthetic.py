"""Deterministic synthetic datasets with the paper's data characteristics
(port of ``repro.data.synthetic``).

The UCI/LIBSVM datasets of Table 1 are replaced by generators with the
same qualitative structure the paper exploits: nonnegative, sparse,
heavy-tailed magnitudes, with class structure carried by which
coordinates are active and by their relative magnitudes; and word-count
vector pairs over 2^16 documents (Table 2 / Figs 4-5).

``Dataset``, ``make_word_pair``, ``WORD_PAIRS`` and ``word_pair`` are
numpy-only in the reference too, and these copies give the same bits.
The classification generators draw the reference's own ``jax.random``
streams through ``repro_torch.core.regen``'s samplers, line by line in
the reference's order and float32 arithmetic: labels, zero patterns and
the uniform and Bernoulli draws are the reference's bits, and values go
through exp / log1p / erfinv / pow, where PyTorch's CPU math and XLA's
differ in the last bits of some draws.  A dataset is made on the host,
as numpy arrays.

``make_template_classification`` alone keeps a second stream,
``draws="numpy"`` (``numpy.random.default_rng(seed)``, the same
distributions, not the reference's data): ``chip_smoke.py``'s train
phase holds the card's features to the CPU's bit for bit, and on the
reference's draws of its dataset that gate fails (ROADMAP A16), so the
phase keeps the numpy dataset its gates were recorded on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import regen as R


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int


# ---------------------------------------------------------------------------
# classification data
# ---------------------------------------------------------------------------

def _heavy_tailed(key, shape, tail: float = 1.2) -> torch.Tensor:
    """Pareto-ish magnitudes: exp of exponential => polynomial tail."""
    e = R.exponential(key, shape)
    return torch.exp(e / tail) - 1.0


def _split(name, x, y, n_train, n_classes) -> Dataset:
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    return Dataset(name, x[:n_train], y[:n_train], x[n_train:], y[n_train:],
                   n_classes)


def make_template_classification(seed: int, *, n_train=1200, n_test=800,
                                 dim=256, n_classes=6, density=0.25,
                                 mult_noise=1.3, spike_prob=0.10,
                                 spike_scale=12.0, name="template",
                                 draws: str = "jax") -> Dataset:
    """Sparse nonneg class templates + heavy multiplicative noise + spikes.

    The spikes and multiplicative noise dominate <u,v>, while min-max (a
    bounded ratio) stays informative: the paper's min-max > intersection >
    linear ordering.  ``draws="numpy"``: the numpy stream (module
    docstring).
    """
    if draws == "numpy":
        return _template_numpy(seed, n_train, n_test, dim, n_classes,
                               density, mult_noise, spike_prob, spike_scale,
                               name)
    if draws != "jax":
        raise ValueError(f"draws must be 'jax' or 'numpy'; got {draws!r}")
    k_t, k_m, k_s = R.split(R.prng_key(seed), 3)
    n = n_train + n_test
    tmpl_mask = R.bernoulli(k_t, density, (n_classes, dim))
    tmpl_mag = _heavy_tailed(R.fold_in(k_t, 1), (n_classes, dim))
    templates = tmpl_mask.to(torch.float32) * (0.5 + tmpl_mag)
    labels = R.randint(R.fold_in(k_m, 0), (n,), 0, n_classes)
    base = templates[labels.long()]
    mnoise = torch.exp(mult_noise * R.normal(R.fold_in(k_m, 1), (n, dim)))
    keep = R.bernoulli(R.fold_in(k_m, 2), 0.9, (n, dim))
    x = base * mnoise * keep.to(torch.float32)
    spikes = (R.bernoulli(k_s, spike_prob, (n, dim)).to(torch.float32)
              * spike_scale * _heavy_tailed(R.fold_in(k_s, 1), (n, dim)))
    return _split(name, (x + spikes).numpy(), labels.numpy(), n_train,
                  n_classes)


def _template_numpy(seed, n_train, n_test, dim, n_classes, density,
                    mult_noise, spike_prob, spike_scale, name) -> Dataset:
    rng = np.random.default_rng(seed)
    heavy = lambda shape: np.exp(rng.standard_exponential(shape) / 1.2) - 1.0
    n = n_train + n_test
    tmpl_mask = rng.random((n_classes, dim)) < density
    templates = tmpl_mask * (0.5 + heavy((n_classes, dim)))
    labels = rng.integers(0, n_classes, n)
    mnoise = np.exp(mult_noise * rng.standard_normal((n, dim)))
    keep = rng.random((n, dim)) < 0.9
    x = templates[labels] * mnoise * keep
    spikes = ((rng.random((n, dim)) < spike_prob) * spike_scale *
              heavy((n, dim)))
    return _split(name, x + spikes, labels, n_train, n_classes)


def make_ratio_xor(seed: int, *, n_train=1200, n_test=800, dim=16,
                   name="ratio-xor") -> Dataset:
    """Binary labels from an XOR over coordinate-pair dominance:
    label = {x_0 > x_1} XOR {x_2 > x_3}.  Linearly inseparable by
    construction; the four dominance patterns form four clusters under
    min-max similarity."""
    key = R.prng_key(seed)
    n = n_train + n_test
    n_pairs = 2
    x = 0.3 * torch.abs(R.normal(key, (n, dim))) + 0.05
    flips = R.bernoulli(R.fold_in(key, 7), 0.5, (n, n_pairs))
    for p in range(n_pairs):
        hi = 3.0 + R.uniform(R.fold_in(key, 10 + p), (n,))
        lo = 0.2 + 0.2 * R.uniform(R.fold_in(key, 20 + p), (n,))
        x[:, 2 * p] = torch.where(flips[:, p], hi, lo)
        x[:, 2 * p + 1] = torch.where(flips[:, p], lo, hi)
    y = flips.sum(dim=1) % 2
    return _split(name, x.numpy(), y.numpy(), n_train, 2)


def make_histogram_mixture(seed: int, *, n_train=1200, n_test=800, dim=128,
                           n_classes=10, conc_scale=6.0,
                           name="hist-mix") -> Dataset:
    """Dirichlet histograms per class with heavy-tailed total mass
    (bag-of-words / visual-word histograms; total counts vary by 2-3
    orders of magnitude per sample).  The Gamma boost underflows for the
    smallest concentrations (alpha about 0.05), which leaves some entries
    exactly zero; the reference's backend flushes subnormal results, and
    ``regen``'s samplers do the same, so the zero pattern is the
    reference's."""
    key = R.prng_key(seed)
    n = n_train + n_test
    conc = torch.full((dim,), 0.25, dtype=torch.float32)
    protos = R.dirichlet(key, conc, (n_classes,))
    labels = R.randint(R.fold_in(key, 1), (n,), 0, n_classes)
    alpha = conc_scale * protos[labels.long()] + 0.05
    gam = R.gamma(R.fold_in(key, 2), alpha)
    p = R.flush_subnormal(gam / gam.sum(dim=1, keepdim=True))
    mass = torch.exp(3.0 * R.normal(R.fold_in(key, 3), (n, 1)))
    x = R.flush_subnormal(R.flush_subnormal(p * mass) * 100.0)
    return _split(name, x.numpy(), labels.numpy(), n_train, n_classes)


# Table 1's suites, as the reference's
CLASSIFICATION_SUITES = {
    "template": lambda: make_template_classification(0),
    "template-hard": lambda: make_template_classification(
        1, n_classes=10, density=0.15, mult_noise=1.2, spike_prob=0.08,
        name="template-hard"),
    "ratio-xor": lambda: make_ratio_xor(2),
    "hist-mix": lambda: make_histogram_mixture(3),
}


# ---------------------------------------------------------------------------
# word-frequency pairs (Table 2 / Figures 4-5), numpy in the reference too
# ---------------------------------------------------------------------------

def make_word_pair(seed: int, *, n_docs=2 ** 16, f1=3000, f2=2500,
                   overlap=0.5, zipf_a=1.6) -> Tuple[np.ndarray, np.ndarray]:
    """Two word-count vectors over n_docs documents.

    ``overlap`` controls the shared active-document fraction, Zipfian
    per-document counts give the heavy tail the paper highlights.
    """
    rng = np.random.default_rng(seed)
    shared = int(round(overlap * min(f1, f2)))
    # scale down when the union would not fit in n_docs (small-doc runs)
    union = f1 + f2 - shared
    if union > n_docs:
        sc = 0.98 * n_docs / union
        f1, f2 = max(int(f1 * sc), 2), max(int(f2 * sc), 2)
        shared = int(round(overlap * min(f1, f2)))
    docs = rng.permutation(n_docs)
    s_docs = docs[:shared]
    u_docs = docs[shared:shared + (f1 - shared)]
    v_docs = docs[shared + (f1 - shared):shared + (f1 - shared) + (f2 - shared)]

    def counts(size):
        z = rng.zipf(zipf_a, size=size).astype(np.float32)
        return np.minimum(z, 5000.0)

    u = np.zeros(n_docs, np.float32)
    v = np.zeros(n_docs, np.float32)
    u[s_docs] = counts(shared)
    # correlated counts on the shared support (same doc popularity)
    v[s_docs] = np.maximum(np.round(u[s_docs] *
                                    np.exp(0.5 * rng.standard_normal(shared))), 1.0)
    u[u_docs] = counts(f1 - shared)
    v[v_docs] = counts(f2 - shared)
    return u, v


WORD_PAIRS = {
    # name: (seed, f1, f2, overlap), spanning the R/MM range of Table 2
    "HONG-KONG":      (11, 940, 948, 0.96),
    "UNITED-STATES":  (12, 4079, 3981, 0.75),
    "GAMBIA-KIRIBATI": (13, 206, 186, 0.84),
    "OF-AND":         (14, 37339, 36289, 0.87),
    "A-THE":          (15, 39063, 42754, 0.80),
    "CREDIT-CARD":    (16, 2999, 2697, 0.45),
    "SAN-FRANCISCO":  (17, 3194, 1651, 0.65),
    "THIS-TODAY":     (18, 27695, 5775, 0.55),
    "TIME-JOB":       (19, 37339, 36289, 0.22),
    "PAPER-REVIEW":   (20, 1944, 3197, 0.18),
    "AIR-DOCTOR":     (21, 3159, 860, 0.14),
    "PIPELINE-FLUSH": (22, 139, 118, 0.08),
    "ADDICT-PRICELESS": (23, 77, 77, 0.01),
}


def word_pair(name: str, n_docs: int = 2 ** 16):
    seed, f1, f2, ov = WORD_PAIRS[name]
    return make_word_pair(seed, n_docs=n_docs, f1=f1, f2=f2, overlap=ov)
