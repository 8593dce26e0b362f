"""Serve a small LM with batched requests: prefill + KV-cache decode,
plus the paper's CWS classifier head reading the pooled hidden states
(e.g. for on-the-fly topic routing of generations).  Port of
``examples/serve_lm.py``: gemma3_12b's smoke config through
``make_serve_steps``, unsharded (the reference's local mesh of one
device).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import forward, init_caches, init_model
from repro_torch.models.cws_head import (cws_head_logits, init_cws_head,
                                         pool_hidden)
from repro_torch.training import make_serve_steps

ARCH, BATCH, PROMPT_LEN, GEN = "gemma3_12b", 4, 32, 12
HEAD_B_I = 4


@torch.no_grad()
def run(device=None, log=print) -> dict:
    """The generated ids, the head's routing logits, the vocabulary, and
    the pooled hidden state and the head that the logits read."""
    dev = resolve_device(device)
    cfg = get_config(ARCH, "smoke")
    batch, prompt_len, gen = BATCH, PROMPT_LEN, GEN
    max_len = prompt_len + gen
    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    head = init_cws_head(torch.Generator(dev).manual_seed(7), cfg.d_model,
                         k=64, b_i=HEAD_B_I, n_classes=3)
    prefill_step, decode_one = make_serve_steps(cfg)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                              dtype=torch.int32, device=dev)
    caches = init_caches(cfg, batch, max_len, device=dev)
    logits, caches = prefill_step(params, prompts, caches)
    tokens = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    generated = [tokens.cpu().numpy()]
    for t in range(gen - 1):
        logits, caches = decode_one(params, tokens, prompt_len + t, caches)
        tokens = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        generated.append(tokens.cpu().numpy())

    # CWS head over the prompt representation (paper technique applied to
    # backbone features; the head is untrained here: shapes and flow)
    hidden, _, _ = forward(params, prompts, cfg)
    pooled = pool_hidden(hidden)
    route_logits = cws_head_logits(head, pooled, b_i=HEAD_B_I)

    gen_ids = np.concatenate(generated, axis=1)
    route = route_logits.float().cpu().numpy()
    log(f"generated ids:\n {gen_ids}")
    log(f"CWS-head routing logits:\n {route}")
    return {"generated": gen_ids, "route_logits": route,
            "vocab": cfg.vocab, "pooled": pooled, "head": head}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
