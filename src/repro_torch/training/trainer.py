"""LM step functions (port of ``repro.training.trainer``, serving part).

Only ``make_serve_steps`` is ported; the training step, its optimizer
and compression wait for the training slice (ROADMAP A12).  One device:
there are no axis rules to install.
"""
from __future__ import annotations

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


def make_serve_steps(cfg: ModelConfig):
    """(prefill_step(params, inputs, caches), decode_one(params, tokens,
    pos, caches)) bound to ``cfg``; each returns (logits, caches)."""
    def prefill_step(params, inputs, caches):
        return prefill(params, inputs, cfg, caches)

    def decode_one(params, tokens, pos, caches):
        return decode_step(params, tokens, pos, cfg, caches)

    return prefill_step, decode_one
