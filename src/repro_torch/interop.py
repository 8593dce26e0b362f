"""Carry the JAX package's parameters and state into the port.

The reference hands its arrays over as numpy (``np.asarray`` of any JAX
array); these functions turn them into the port's types on a given
device.  The served-model bundle (``repro_torch.serving.bundle``) is the
same hand-over on disk.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.cws import CWSParams
from repro_torch.core.kernel_svm import SVMModel
from repro_torch.core.linear_model import LinearParams
from repro_torch.core.regen import key_words as _key_words
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, _torch_dtype
from repro_torch.models.model import init_model
from repro_torch.optim import AdamState


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32, copy=True), device=device)


def linear_params(w, b, *, device=None) -> LinearParams:
    """Reference ``LinearParams`` (w (F, C), b (C,)) -> the port's."""
    device = resolve_device(device)
    return LinearParams(_tensor(w, device), _tensor(b, device))


def linear_opt_state(state, *, device=None):
    """Reference ``make_linear_tx`` state, ``((), AdamState(mu, nu))``
    with ``LinearParams`` moments (leaves as numpy) -> the port's, so both
    frameworks can take a step from the same (params, state)."""
    device = resolve_device(device)
    clip_state, adam = state
    if tuple(clip_state) != ():
        raise ValueError(f"clip_by_global_norm carries no state; got "
                         f"{clip_state!r}")
    moments = lambda m: LinearParams(_tensor(m[0], device),
                                     _tensor(m[1], device))
    return (), AdamState(mu=moments(adam.mu), nu=moments(adam.nu))


def cws_params(r, log_c, beta, *, device=None) -> CWSParams:
    """Reference ``CWSParams`` matrices (D, k) -> the port's."""
    device = resolve_device(device)
    return CWSParams(_tensor(r, device), _tensor(log_c, device),
                     _tensor(beta, device))


def svm_model(alpha, y_signed, classes, *, device=None) -> SVMModel:
    """Reference ``SVMModel`` (alpha and y_signed (C, n) or (n,), classes
    (C,)) -> the port's, so both packages' ``decision_values`` can be
    compared on identical coefficients."""
    device = resolve_device(device)
    return SVMModel(_tensor(alpha, device), _tensor(y_signed, device),
                    torch.as_tensor(np.asarray(classes, np.int64),
                                    device=device))


def key_words(words) -> Tuple[int, int]:
    """Reference key words (``uint32[2]``, e.g. ``np.asarray(pipe.
    _key_words)`` or ``jax.random.key_data(key)``) -> the port's key
    words: two Python ints, which the kernels take as scalars, so they
    live on no device."""
    return _key_words(np.asarray(words, np.uint32))


def _float_tensor(a, dtype, device) -> torch.Tensor:
    # numpy has no bfloat16: widen to float32 (exact), then narrow on the
    # device to the port's dtype
    return _tensor(np.asarray(a, np.float32), device).to(dtype)


def lm_params(params, cfg: ModelConfig, *, device=None,
              dtype: torch.dtype = None, rules=None) -> dict:
    """The reference's LM parameters (the nested dict of ``init_model``,
    leaves as numpy) -> the port's: ``embed/tokens`` (and ``head`` when
    untied), ``units/block{i}/{norm1, mixer/..., norm2, mlp/...}`` with the
    leading unit axis, ``final_norm``.  Each leaf takes the dtype the port's
    ``init_model`` gives it (the reference's: ``cfg.master_dtype``, fp32
    for ``model.FP32_LEAVES``), or ``dtype`` for every leaf.  Keys and
    shapes must be exactly the port's (checked against ``init_model(cfg,
    device="meta")``).  Under ``rules`` each rank keeps its slices
    (``param_pspecs``), as ``make_serve_steps(cfg, rules)`` and
    ``init_train_state(rules=)`` hold them."""
    device = resolve_device(device)
    if rules is not None:
        from repro_torch.models.sharding import map_specs, shard_of
        from repro_torch.training.trainer import param_pspecs
        whole = lm_params(params, cfg, device="cpu", dtype=dtype)
        return map_specs(lambda t, sp: shard_of(t, rules.mesh, sp).to(
            device, copy=True), whole, param_pspecs(cfg, rules))

    def convert(ref, want, path):
        if not isinstance(ref, dict) or set(ref) != set(want):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                             f"{sorted(ref) if isinstance(ref, dict) else ref!r}"
                             f" != {sorted(want)}")
        out = {}
        for key, spec in want.items():
            where = path + (key,)
            if isinstance(spec, dict):
                out[key] = convert(ref[key], spec, where)
                continue
            a = np.asarray(ref[key])
            if a.shape != tuple(spec.shape):
                raise ValueError(f"{'/'.join(where)}: shape {a.shape} != "
                                 f"{tuple(spec.shape)}")
            out[key] = _float_tensor(a, dtype or spec.dtype, device)
        return out

    return convert(params, init_model(cfg, device="meta"), ())


def lm_train_state(state, cfg: ModelConfig, *, device=None, rules=None):
    """The reference's LM ``TrainState`` (params, mu, nu, step,
    ef_residual; leaves as numpy or JAX arrays) -> the port's: the
    parameters through ``lm_params`` (each leaf in its own dtype), the
    moments in ``cfg.moment_dtype`` and the residual in fp32 (every leaf,
    as the reference's ``adamw.init`` and ``init_residual`` make them),
    the step as a () int32 tensor.  Under ``rules`` each rank keeps its
    slices (``state_pspecs``), as ``init_train_state(rules=)`` holds
    them."""
    from repro_torch.training.trainer import (TrainHparams, TrainState,
                                              state_pspecs)
    device = resolve_device(device)
    moments = _torch_dtype(cfg.moment_dtype)
    ef = state.ef_residual
    if rules is not None:
        from repro_torch.models.sharding import map_specs, shard_of
        whole = lm_train_state(state, cfg, device="cpu")
        specs = state_pspecs(cfg, rules,
                             TrainHparams(compress_grads=ef is not None))
        return map_specs(lambda t, sp: shard_of(t, rules.mesh, sp).to(
            device, copy=True), whole, specs)
    return TrainState(
        params=lm_params(state.params, cfg, device=device),
        mu=lm_params(state.mu, cfg, device=device, dtype=moments),
        nu=lm_params(state.nu, cfg, device=device, dtype=moments),
        step=torch.as_tensor(np.array(state.step, np.int32),
                             device=device),
        ef_residual=None if ef is None else lm_params(
            ef, cfg, device=device, dtype=torch.float32))
