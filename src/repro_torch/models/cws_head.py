"""CWSClassifierHead: the paper's pipeline as a model head.

Port of ``repro.models.cws_head``.  A backbone's pooled features, made
nonnegative by ReLU -> CWS featurization (``repro_torch.pipeline``, the
``cws_encode`` kernel on CUDA tensors, TPU kernel row 2) -> an
embedding-bag linear classifier.  The hash codes are one-hot per hash, so
the classifier weight (k, 2^{b_i}, C) is an embedding table.  The CWS
parameters are buffers, not trained.  The reference's ``use_pallas``
switch has no counterpart: the features' device chooses the kernel or its
plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cws import CWSParams, make_cws_params
from repro_torch.core.linear_model import LinearParams, bag_logits
from repro_torch.pipeline import FeaturePipeline, FeatureSpec


class CWSHeadParams(NamedTuple):
    cws: CWSParams           # frozen hashing buffers (D, k)
    table: torch.Tensor      # (k, 2^{b_i}, n_classes)
    bias: torch.Tensor       # (n_classes,)


def init_cws_head(generator: torch.Generator, feature_dim: int, *, k: int,
                  b_i: int, n_classes: int) -> CWSHeadParams:
    """Fresh CWS parameters from ``generator`` (on its device) and a zero
    table and bias."""
    cws = make_cws_params(generator, feature_dim, k)
    dev = cws.r.device
    return CWSHeadParams(
        cws=cws,
        table=torch.zeros((k, 1 << b_i, n_classes), device=dev),
        bias=torch.zeros((n_classes,), device=dev))


def head_pipeline(params: CWSHeadParams, *, b_i: int) -> FeaturePipeline:
    spec = FeatureSpec(num_hashes=params.cws.num_hashes, b_i=b_i)
    return FeaturePipeline(params.cws, spec)


def cws_head_logits(params: CWSHeadParams, features: torch.Tensor, *,
                    b_i: int) -> torch.Tensor:
    """features: (B, D) -> logits (B, C).  Nonnegativity enforced by ReLU
    (the min-max kernel is defined on nonnegative data)."""
    feats = torch.relu(features.float())
    idx = head_pipeline(params, b_i=b_i).features(feats)   # (B, k) indices
    flat = params.table.reshape(-1, params.table.shape[-1])
    return bag_logits(LinearParams(flat, params.bias), idx)


def pool_hidden(hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, D) mean-pool (backbone feature extraction)."""
    return hidden.mean(dim=1)
