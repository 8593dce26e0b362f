"""Linear classifiers on dense and CWS-hashed features (port of
``repro.core.linear_model``).

A hashed example is k one-hot indices into a flat (F, C) table, so its
logits are ``sum_j W[idx_j] + b``: a gather and a sum, which is plain
PyTorch (the reference leaves it to XLA, not to a Pallas kernel).  The
head (``_BagLogits``) rounds the same on every device: the k rows, and
the bias's gradient over the batch, are summed in float64 and rounded
once to float32, and the table's gradient adds each row's terms in
position order.  A float32 reduction, or ``index_select``'s backward
(``index_add_``, which adds with atomics on CUDA), would round in each
device's own order, so two runs, or the card and the CPU, would give
tables a few ulps apart, which AdamW's g / sqrt(v) grows into steps the
size of lr.  Two float64 sums of the same float32 terms in other orders
differ by a few float64 ulps when they are inexact, so they round to
one float32 unless a float32 rounding boundary falls between them (as
with the clip norm in ``repro_torch.optim``).

Training: squared hinge (one-vs-rest, the paper's LIBLINEAR L2-loss
setting) or softmax cross-entropy, plus ``l2 * ||W||^2``, minimised by
``make_linear_tx`` (global-norm clipping, then AdamW on a cosine
schedule), full batch or on minibatches walked in the reference's own
epoch shuffle (``repro_torch.core.regen.permutation``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import optim
from repro_torch.core.hashing import (check_packed_bits, packed_width,
                                      unpack_codes)
from repro_torch.core.regen import fold_in, permutation, prng_key
from repro_torch.device import resolve_device


class LinearParams(NamedTuple):
    w: torch.Tensor  # dense: (D, C); hashed: (k, width, C); bag: (F, C)
    b: torch.Tensor  # (C,) float32


def _zeros(shape, n_classes: int, device) -> LinearParams:
    device = resolve_device(device)
    return LinearParams(
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros((n_classes,), dtype=torch.float32, device=device))


def init_dense(dim: int, n_classes: int, *, device=None) -> LinearParams:
    """Zero (D, C) weights and bias, on the card unless ``device`` says
    otherwise."""
    return _zeros((dim, n_classes), n_classes, device)


def init_hashed(k: int, width: int, n_classes: int, *,
                device=None) -> LinearParams:
    """Zero (k, width, C) table for per-hash codes, and bias."""
    return _zeros((k, width, n_classes), n_classes, device)


def init_bag(num_features: int, n_classes: int, *,
             device=None) -> LinearParams:
    """Zero flat embedding-bag table (F, C) and bias (C,)."""
    return _zeros((num_features, n_classes), n_classes, device)


def _sum_f64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` accumulated in float64, rounded once to float32:
    one reduction, the same float32 on every device (see above)."""
    return x.sum(dim, dtype=torch.float64).float()


class _BagLogits(torch.autograd.Function):
    """``sum_j table[flat rows of example i] + bias`` for (n, k) indices,
    the rows and the bias's gradient summed by ``_sum_f64``.  The table's
    gradient adds each row's terms in the order of their positions, from
    zero: on the CPU by ``index_add_`` (a serial loop; the CPU
    ``index_put_`` adds in parallel with atomics), on CUDA by
    ``index_put_(accumulate=True)`` (a stable sort of the indices, then
    each index's run summed in sorted order)."""

    @staticmethod
    def forward(ctx, table, bias, idx):
        n, k = idx.shape
        flat = idx.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.dims = (n, k, table.shape[0])
        rows = table.index_select(0, flat).view(n, k, table.shape[1])
        return _sum_f64(rows, 1) + bias

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        n, k, num_rows = ctx.dims
        g_table = g_bias = None
        if ctx.needs_input_grad[0]:
            terms = grad[:, None, :].expand(n, k, grad.shape[1]).reshape(
                n * k, grad.shape[1])
            g_table = grad.new_zeros((num_rows, grad.shape[1]))
            if g_table.is_cuda:
                g_table.index_put_((flat,), terms, accumulate=True)
            else:
                g_table.index_add_(0, flat, terms)
        if ctx.needs_input_grad[1]:
            g_bias = _sum_f64(grad, 0)
        return g_table, g_bias, None


def _gather_sum(table: torch.Tensor, bias: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """sum_j table[idx[:, j]] + bias over a flat (F, C) table; the
    [0, F-1] clamp guards a features/table mismatch, as the reference's
    clipped take does (validate_bag_features makes it loud)."""
    flat = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
    return _BagLogits.apply(table, bias, flat)


def dense_logits(params: LinearParams, x: torch.Tensor) -> torch.Tensor:
    return x @ params.w + params.b


def hashed_logits(params: LinearParams, codes: torch.Tensor) -> torch.Tensor:
    """codes (n, k) bucket ids in [0, width) against a (k, width, C)
    table.  Sentinel codes (-1, all-zero rows) clamp to bucket 0, as the
    fused pipeline does; codes >= width (a spec/params mismatch) clamp to
    width - 1, as the reference's clipped gather does."""
    k, width, n_classes = params.w.shape
    offs = torch.arange(k, dtype=torch.int64, device=codes.device) * width
    idx = offs + codes.to(torch.int64).clamp(0, width - 1)
    return _gather_sum(params.w.reshape(k * width, n_classes), params.b,
                       idx)


def bag_logits(params: LinearParams, idx: torch.Tensor) -> torch.Tensor:
    """idx (n, k) int32 global feature indices in [0, F) -> (n, C)."""
    if idx.ndim != 2:
        raise ValueError(f"bag indices must be (n, k); got {tuple(idx.shape)}")
    if params.w.ndim != 2:
        raise ValueError("bag params must be a flat (F, C) table "
                         f"(init_bag); got w {tuple(params.w.shape)}")
    return _gather_sum(params.w, params.b, idx)


def check_bag_table_size(num_hashes: int, b: int) -> int:
    """Row count ``num_hashes * 2^b`` of a packed bag table; raises when
    the top index would not fit int32 (the index type the kernels emit)."""
    check_packed_bits(b)
    num_features = num_hashes * (1 << b)
    if num_features > 2 ** 31:
        raise ValueError(
            f"packed bag table overflow: {num_hashes} hashes at b = {b} "
            f"index {num_features} features, but the top index "
            f"{num_features - 1} exceeds int32 max ({2 ** 31 - 1}); keep "
            f"num_hashes * 2^b <= 2^31 (at b = {b}: num_hashes <= "
            f"{2 ** 31 >> b})")
    return num_features


def bag_logits_packed(params: LinearParams, packed: torch.Tensor, *,
                      num_hashes: int, b: int) -> torch.Tensor:
    """Logits straight from bit-packed features (n, ceil(k*b/32)) uint32:
    unpack, add the per-hash offsets ``j * 2^b`` and gather as
    ``bag_logits`` does."""
    if packed.ndim != 2:
        raise ValueError(f"packed features must be (n, words); "
                         f"got {tuple(packed.shape)}")
    if packed.dtype != torch.uint32:
        raise ValueError(f"packed features must be uint32 words; "
                         f"got {packed.dtype}")
    if packed.shape[-1] != packed_width(num_hashes, b):
        raise ValueError(
            f"packed width mismatch: got {packed.shape[-1]} words but "
            f"{num_hashes} hashes at b = {b} pack into "
            f"{packed_width(num_hashes, b)}")
    if params.w.ndim != 2:
        raise ValueError("bag params must be a flat (F, C) table "
                         f"(init_bag); got w {tuple(params.w.shape)}")
    num_features = params.w.shape[0]
    if num_features != check_bag_table_size(num_hashes, b):
        raise ValueError(
            f"feature-table mismatch: table has {num_features} rows but "
            f"{num_hashes} hashes at b = {b} index {num_hashes * (1 << b)} "
            f"features; build with init_bag_packed(num_hashes, b, C)")
    codes = unpack_codes(packed, num_hashes, b=b).to(torch.int64)
    offs = torch.arange(num_hashes, dtype=torch.int64,
                        device=packed.device) * (1 << b)
    return _gather_sum(params.w, params.b, offs + codes)


def init_bag_packed(num_hashes: int, b: int, n_classes: int, *,
                    device=None) -> LinearParams:
    """Zero table sized for packed b-bit features: (num_hashes * 2^b, C)."""
    return init_bag(check_bag_table_size(num_hashes, b), n_classes,
                    device=device)


def validate_bag_features(params: LinearParams, num_features: int, *,
                          spec=None) -> None:
    """Raise when a (F, C) table does not match the feature space: a
    mismatched table would make every gather clamp silently.  A packed
    ``spec`` pins F to ``num_hashes * 2^bits``."""
    if params.w.ndim != 2:
        raise ValueError("bag params must be a flat (F, C) table "
                         f"(init_bag); got w {tuple(params.w.shape)}")
    if spec is not None and getattr(spec, "packed", False):
        expected = spec.num_hashes * (1 << spec.bits)
        if params.w.shape[0] != expected:
            raise ValueError(
                f"feature-table mismatch: table has {params.w.shape[0]} "
                f"rows but the packed pipeline ({spec.num_hashes} hashes "
                f"at b = {spec.bits}) indexes {expected} features; build "
                f"with init_bag_packed(num_hashes, b, n_classes)")
        return
    if params.w.shape[0] != num_features:
        raise ValueError(
            f"feature-table mismatch: table has {params.w.shape[0]} rows "
            f"but the pipeline emits indices into {num_features} features; "
            f"build with init_bag(pipe.num_features, n_classes)")


_LOGITS_FNS = {"dense": dense_logits, "hashed": hashed_logits,
               "bag": bag_logits}


def squared_hinge_loss(logits: torch.Tensor, labels: torch.Tensor,
                       n_classes: int) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes)
    y = torch.where(onehot > 0, 1.0, -1.0)
    margins = torch.clamp_min(1.0 - y * logits, 0.0)
    return torch.mean(torch.sum(torch.square(margins), dim=-1))


def softmax_xent_loss(logits: torch.Tensor, labels: torch.Tensor,
                      n_classes: int) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    n_classes: int
    steps: int = 400          # UPDATE steps (not epochs), any batch_size
    lr: float = 0.05
    l2: float = 1e-4          # = 1/(2C) scaled by n
    batch_size: int = 0       # 0 => explicit full batch; > 0 => minibatch
    loss: str = "squared_hinge"


def _loss_fn(params: LinearParams, xb, yb, cfg: TrainCfg,
             logits_fn: Callable) -> torch.Tensor:
    logits = logits_fn(params, xb)
    if cfg.loss == "squared_hinge":
        data = squared_hinge_loss(logits, yb, cfg.n_classes)
    else:
        data = softmax_xent_loss(logits, yb, cfg.n_classes)
    reg = cfg.l2 * torch.sum(torch.square(params.w))
    return data + reg


def value_and_grad(fn: Callable, params, *args):
    """``jax.value_and_grad(fn)(params, *args)`` for a tree of float
    tensors: the value and the gradient tree, both detached.  ``fn`` may
    return ``(value, aux)`` (``has_aux``), which comes back whole.  A leaf
    that the value does not depend on gets a zero gradient, as in JAX (the
    token table of an LM fed embeddings)."""
    leaves = optim.tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    out = fn(optim.tree_map(lambda _: next(it), params), *args)
    value = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(value, live, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    grads = optim.tree_map(lambda _: next(it), params)
    if isinstance(out, tuple):
        return (value.detach(),) + tuple(out[1:]), grads
    return value.detach(), grads


def make_linear_tx(cfg: TrainCfg) -> optim.Transform:
    """The one optimizer recipe for the linear tier, shared by the
    full-batch and minibatch paths here and the streaming trainer
    (repro_torch.training.linear_trainer), so their updates are
    bit-comparable."""
    return optim.chain(optim.clip_by_global_norm(10.0),
                       optim.adamw(optim.cosine_schedule(cfg.lr, cfg.steps)))


def same_device(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of ``tensors``; raises when they differ (nothing is
    moved quietly)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on different devices "
                         f"{sorted(map(str, devices))}; move them to one "
                         f"device first")
    return devices.pop()


def fit_linear(params: LinearParams, x: torch.Tensor, labels: torch.Tensor,
               *, cfg: TrainCfg, kind: str = "dense",
               shuffle_key=None) -> LinearParams:
    """Adam on materialized features: full batch (``cfg.batch_size`` 0)
    or minibatches of the reference's epoch permutation
    ``permutation(fold_in(shuffle_key, epoch), n)`` (``shuffle_key``
    defaults to ``prng_key(0)``; the ragged remainder of each permutation
    is dropped).  ``cfg.steps`` counts updates on both paths.

    ``batch_size == n`` takes the full-batch gradient without a gather,
    bit-identical to ``batch_size == 0``.  ``params``, ``x`` and
    ``labels`` must share one device; ``params`` is not modified."""
    logits_fn = _LOGITS_FNS[kind]
    n = x.shape[0]
    bs = cfg.batch_size
    if bs < 0:
        raise ValueError(f"batch_size must be >= 0; got {bs}")
    if bs > n:
        raise ValueError(
            f"batch_size {bs} exceeds the {n} available rows; pass "
            f"batch_size=0 for the explicit full-batch path")
    device = same_device("fit_linear", params.w, params.b, x, labels)
    tx = make_linear_tx(cfg)
    state = tx.init(params)

    def step(params, state, xb, yb, i):
        _, grads = value_and_grad(_loss_fn, params, xb, yb, cfg, logits_fn)
        with torch.no_grad():
            updates, state = tx.update(grads, state, params, i)
            return optim.apply_updates(params, updates), state

    if bs in (0, n):
        for i in range(cfg.steps):
            params, state = step(params, state, x, labels, i)
        return params

    steps_per_epoch = n // bs
    key = shuffle_key if shuffle_key is not None else prng_key(0)
    perm = None
    for i in range(cfg.steps):
        epoch, pos = divmod(i, steps_per_epoch)
        if pos == 0:
            perm = permutation(fold_in(key, epoch), n).to(device,
                                                          non_blocking=True)
        idx = perm[pos * bs:(pos + 1) * bs]
        params, state = step(params, state, x.index_select(0, idx),
                             labels.index_select(0, idx), i)
    return params


@torch.no_grad()
def linear_accuracy(params: LinearParams, x: torch.Tensor,
                    labels: torch.Tensor, kind: str = "dense") -> float:
    """The share of rows whose argmax is the label, as the count over n
    (the reference's float32 mean rounds through CUDA's reciprocal of n
    on the card, so it would differ by device in the last bits)."""
    pred = torch.argmax(_LOGITS_FNS[kind](params, x), dim=-1)
    return int((pred == labels).sum()) / labels.shape[0]


def _best_over_l2(l2s, steps, lr, n_classes, init, x_tr, y_tr, x_te, y_te,
                  kind) -> float:
    best = 0.0
    for l2 in l2s:
        cfg = TrainCfg(n_classes=n_classes, steps=steps, lr=lr, l2=float(l2))
        p = fit_linear(init(), x_tr, y_tr, cfg=cfg, kind=kind)
        best = max(best, linear_accuracy(p, x_te, y_te, kind=kind))
    return best


def best_linear_accuracy_over_C(x_tr, y_tr, x_te, y_te, *, n_classes,
                                kind="dense",
                                l2s=(1e-6, 1e-5, 1e-4, 1e-3),
                                steps=400, lr=0.05) -> float:
    """The paper's C sweep for the dense linear learner (hashed and bag
    features go through best_hashed_accuracy_over_C or
    best_bag_accuracy_over_C)."""
    if kind != "dense":
        raise ValueError("use best_hashed_accuracy_over_C / "
                         "best_bag_accuracy_over_C for hashed features")
    init = lambda: init_dense(x_tr.shape[-1], n_classes, device=x_tr.device)
    return _best_over_l2(l2s, steps, lr, n_classes, init, x_tr, y_tr, x_te,
                         y_te, "dense")


def best_hashed_accuracy_over_C(codes_tr, y_tr, codes_te, y_te, *,
                                n_classes, k: int, width: int,
                                l2s=(1e-6, 1e-5, 1e-4),
                                steps=400, lr=0.05) -> float:
    init = lambda: init_hashed(k, width, n_classes, device=codes_tr.device)
    return _best_over_l2(l2s, steps, lr, n_classes, init, codes_tr, y_tr,
                         codes_te, y_te, "hashed")


def best_bag_accuracy_over_C(idx_tr, y_tr, idx_te, y_te, *, n_classes,
                             num_features: int,
                             l2s=(1e-6, 1e-5, 1e-4),
                             steps=400, lr=0.05) -> float:
    """C sweep over pipeline feature indices."""
    init = lambda: init_bag(num_features, n_classes, device=idx_tr.device)
    return _best_over_l2(l2s, steps, lr, n_classes, init, idx_tr, y_tr,
                         idx_te, y_te, "bag")
