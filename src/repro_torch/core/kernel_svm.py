"""L2-regularized L2-loss (squared hinge) kernel SVM by dual coordinate
descent (port of ``repro.core.kernel_svm``).

Per binary problem (the LIBLINEAR dual the paper uses through LIBSVM's
precomputed kernels):

    min_{alpha >= 0}  1/2 alpha^T Qbar alpha - e^T alpha,
    Qbar = (y y^T) .* K + I / (2C)

with the one-coordinate update
    alpha_i <- max(alpha_i - ((Qbar alpha)_i - 1) / Qbar_ii, 0)

keeping g = Qbar @ alpha up to date.  The reference ``vmap``s the binary
solver over one-vs-rest classes; here the class dimension is written out,
and so, optionally, is a leading dimension of C values: every problem of
the batch takes its coordinate step together, so a (C grid x classes)
batch costs one pass of n coordinate steps per sweep, each a handful of
launches on (batch, n) tensors.  Each problem's arithmetic is the same as
it would be alone.  The loop indexes with Python ints and never reads a
device value back to the host.

Decision value for a test Gram row K_test (m, n):
    f_c(x) = sum_i alpha_{c,i} y_{c,i} K(x_i, x)
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class SVMModel(NamedTuple):
    alpha: torch.Tensor     # (C, n) or (n,) dual coefficients
    y_signed: torch.Tensor  # matching signed labels
    classes: torch.Tensor


def _signed_labels(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(P, n) float32 targets in {-1, +1}: one row in the binary case
    (class 1 positive), one per class (one-vs-rest) otherwise."""
    if n_classes == 2:
        return torch.where(labels == 1, 1.0, -1.0)[None, :]
    classes = torch.arange(n_classes, device=labels.device)
    return torch.where(labels[None, :] == classes[:, None], 1.0, -1.0)


def _dual_cd(K: torch.Tensor, ys: torch.Tensor, Cs: Sequence[float],
             sweeps: int) -> torch.Tensor:
    """Dual coordinate descent on K (n, n) for every (C, problem) pair at
    once: ys (P, n) signed targets -> alpha (len(Cs), P, n)."""
    n = K.shape[0]
    dev = K.device
    Kt = K.t().contiguous()               # Kt[i] is column i of K
    two_c = torch.tensor([2.0 * float(c) for c in Cs], dtype=torch.float32,
                         device=dev)[:, None]                   # (B, 1)
    inv_two_c = torch.tensor([1.0 / (2.0 * float(c)) for c in Cs],
                             dtype=torch.float32, device=dev)[:, None]
    qbar_diag = torch.diagonal(K)[None, None, :] + inv_two_c[:, :, None]
    alpha = torch.zeros((len(Cs),) + ys.shape, dtype=torch.float32,
                        device=dev)
    g = torch.zeros_like(alpha)
    for _ in range(sweeps):
        for i in range(n):
            a_i = alpha[:, :, i]                                # (B, P)
            grad = g[:, :, i] - 1.0
            new_ai = torch.clamp_min(a_i - grad / qbar_diag[:, :, i], 0.0)
            d = new_ai - a_i
            # column i of Qbar: y_i * y * K[:, i], plus the I/(2C) diagonal
            col = ys[:, i:i + 1] * ys * Kt[i]                   # (P, n)
            g += d[:, :, None] * col
            g[:, :, i] += d / two_c
            alpha[:, :, i] = new_ai
    return alpha


def fit_kernel_svm_grid(K: torch.Tensor, labels: torch.Tensor, *,
                        Cs: Sequence[float], sweeps: int = 30,
                        n_classes: int = 2):
    """One ``SVMModel`` per C in ``Cs``, all solved in one batched pass;
    each equals ``fit_kernel_svm(K, labels, C=C, ...)``."""
    K = K.to(torch.float32)
    labels = torch.as_tensor(labels, device=K.device)
    ys = _signed_labels(labels, n_classes)
    alphas = _dual_cd(K, ys, Cs, sweeps)
    classes = torch.arange(n_classes, device=K.device)
    if n_classes == 2:
        return [SVMModel(a[0], ys[0], classes) for a in alphas]
    return [SVMModel(a, ys, classes) for a in alphas]


def fit_kernel_svm(K: torch.Tensor, labels: torch.Tensor, *, C: float = 1.0,
                   sweeps: int = 30, n_classes: int = 2) -> SVMModel:
    """K: (n, n) precomputed Gram; labels: (n,) ints in [0, n_classes)."""
    return fit_kernel_svm_grid(K, labels, Cs=(C,), sweeps=sweeps,
                               n_classes=n_classes)[0]


def decision_values(model: SVMModel, K_test: torch.Tensor) -> torch.Tensor:
    """K_test: (m, n) Gram between test and train rows -> (m, C) or (m,)."""
    coef = model.alpha * model.y_signed
    K_test = K_test.to(torch.float32)
    if coef.ndim == 1:
        return K_test @ coef
    return K_test @ coef.T


def predict(model: SVMModel, K_test: torch.Tensor) -> torch.Tensor:
    f = decision_values(model, K_test)
    if f.ndim == 1:
        return (f > 0).to(torch.int32)
    return torch.argmax(f, dim=-1).to(torch.int32)


def accuracy(model: SVMModel, K_test: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    labels = torch.as_tensor(labels, device=K_test.device)
    return (predict(model, K_test) == labels).to(torch.float32).mean()


def best_accuracy_over_C(K_train, K_test, y_train, y_test, *, n_classes,
                         Cs=(0.01, 0.1, 1.0, 10.0, 100.0, 1000.0),
                         sweeps: int = 30):
    """The paper reports the best accuracy over a wide C grid (Table 1).
    The grid is solved as one batch; returns (best, [accuracy per C])."""
    models = fit_kernel_svm_grid(K_train, y_train, Cs=Cs, sweeps=sweeps,
                                 n_classes=n_classes)
    accs = torch.stack([accuracy(m, K_test, y_test) for m in models])
    accs = [float(a) for a in accs.cpu()]
    return max(accs), accs
