"""Serving drivers: the featurize->score service, and LM decode.

  * ``--bundle DIR`` boots a replica from a served-model bundle and drives
    synthetic request traffic through its gateway:

      PYTHONPATH=src python -m repro_torch.launch.serve --bundle DIR \
          --requests 200 --max-rows 48 --stats-port 0 [--device cuda]

  * ``--arch NAME`` runs the LM path: a synthetic prompt batch through
    prefill (flash attention with ``--attn-impl flash``), then decode with
    the KV caches:

      PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \
          --variant full --attn-impl flash --batch 4 --prompt-len 2048 \
          --gen 17

    Every config of ``repro_torch.configs.ARCHS`` serves, the MoE, SSM and
    RG-LRU ones included (``--layers N`` cuts the depth: llama4's 48
    layers of bf16 weights do not fit one card).

    Under ``torchrun`` every rank joins one gloo process group and serves
    its shard under the reference's local mesh and rules
    (``make_local_mesh()``: data = N, model = 1; ``--mesh D M`` for
    another; ``make_serve_steps(cfg, rules)``): its slices of the weights,
    its rows of the batch, its shards of the caches.  Each rank's device
    is ``cuda:{LOCAL_RANK % device_count}``; logs come from rank 0:

      torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch \
          gemma3_12b --variant smoke --batch 4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist


def synthetic_rows(rng: np.random.Generator, m: int, dim: int) -> np.ndarray:
    """``m`` sparse nonnegative rows, about 30% nonzero."""
    x = np.abs(rng.standard_normal((m, dim))).astype(np.float32)
    x *= rng.random((m, dim)) < 0.3
    return x


def serve_bundle(args) -> dict:
    """Load the bundle, warm the buckets, fire synthetic traffic, print the
    monitoring snapshot; returns it with the wall time and request rate."""
    from repro_torch.serving import ServingService

    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    svc = ServingService.from_bundle(
        args.bundle, device=args.device, buckets=buckets,
        default_deadline_s=args.deadline_s,
        hard_timeout_s=args.hard_timeout_s)
    try:
        if args.stats_port is not None:
            url = svc.start_stats_server(port=args.stats_port).url
            print(f"stats endpoint: {url}")
        print(f"warmed {len(svc.runner.buckets)} buckets "
              f"{svc.runner.buckets} in {svc.warmup_s * 1e3:.1f} ms")

        rng = np.random.default_rng(args.seed)
        dim = svc.runner.pipe.dim
        futures = []
        t0 = time.perf_counter()
        for _ in range(args.requests):
            m = int(rng.integers(1, args.max_rows + 1))
            futures.append(svc.submit(synthetic_rows(rng, m, dim)))
        for f in futures:
            f.result(timeout=args.deadline_s + 30.0)
        wall = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        svc.stop()
    lat = stats["latency_ms"]
    print(f"{args.requests} requests ({stats['rows']} rows) in "
          f"{wall:.3f}s -> {args.requests / wall:,.1f} req/s; latency "
          f"p50 {lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms")
    print(json.dumps(stats, indent=1, sort_keys=True))
    return {"stats": stats, "wall_s": wall,
            "req_per_s": args.requests / wall}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args, params=None) -> dict:
    """Prefill ``--batch`` x ``--prompt-len`` synthetic tokens, then decode
    ``--gen`` - 1 more, greedily (exact argmax) or, with a temperature, by
    sampling from a seeded ``torch.Generator`` (not the reference's
    ``jax.random`` draws).  Weights are drawn from ``--seed`` and cast once
    to the compute dtype (the same bits as casting the masters at each
    use); a caller may pass ``params`` already built for the config.
    Prints prefill ms, decode tok/s and the first generated ids; returns
    them with the prompts and the prefill logits.

    In a process group of more than one rank the steps run under the
    local mesh's rules: ``params`` (drawn, or passed) are this rank's
    slices, the prompts' rows and the caches this rank's shards; the
    generated ids returned are the whole batch's, gathered."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.models import cast_params, init_caches, init_model
    from repro_torch.models.model import embed_generated
    from repro_torch.models.sharding import (TrainLayout, gather_params,
                                             make_rules, shard_of, spec_at)
    from repro_torch.training import make_serve_steps
    from repro_torch.training.trainer import input_specs, param_pspecs

    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rules = layout = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(*args.mesh) if args.mesh else make_local_mesh()
        rules = make_rules(mesh)
        layout = TrainLayout(rules, param_pspecs(cfg, rules))
    rank0 = rules is None or rules.mesh.rank == 0
    log = print if rank0 else (lambda *a, **k: None)
    if params is None:
        gen = torch.Generator(device).manual_seed(args.seed)
        keep = None if layout is None else (
            lambda path, t: shard_of(t, rules.mesh, spec_at(
                layout.specs, path)).clone())
        params = cast_params(init_model(cfg, gen, device, keep=keep),
                             cfg.compute_dtype)
    prefill_step, decode_one = make_serve_steps(cfg, rules)

    rng = np.random.default_rng(args.seed)
    if cfg.input_mode == "embeddings":
        prompts = torch.as_tensor(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32),
            device=device)
    else:
        prompts = torch.as_tensor(rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len)), device=device)
    mine, rows = prompts, None
    if rules is not None:
        rows = input_specs(cfg, rules, shape="prefill",
                           seq_len=args.prompt_len,
                           global_batch=args.batch)["inputs"].spec[:1]
        mine = shard_of(prompts, rules.mesh, rows)
    caches = init_caches(cfg, args.batch, args.prompt_len + args.gen,
                         rules=rules, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, mine, caches)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    sampler = torch.Generator(device).manual_seed(args.seed)
    tokens = logits[:, :cfg.vocab].argmax(-1)[:, None]
    outs = [tokens]
    t0 = time.perf_counter()
    for t in range(args.gen - 1):
        step_in = tokens
        if cfg.input_mode == "embeddings":
            # stub frontends embed generated ids via the output table
            step_in = embed_generated(params, tokens, cfg, layout=layout)
        logits, caches = decode_one(params, step_in, args.prompt_len + t,
                                    caches)
        if args.temperature > 0:
            probs = torch.softmax(
                logits[:, :cfg.vocab].float() / args.temperature, -1)
            tokens = torch.multinomial(probs, 1, generator=sampler)
        else:
            tokens = logits[:, :cfg.vocab].argmax(-1)[:, None]
        outs.append(tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0

    generated = torch.cat(outs, 1)
    if rules is not None:
        generated = gather_params(generated, rules, rows + (None,))
    generated = generated.cpu().numpy()
    steps = args.gen - 1
    tok_s = args.batch * steps / max(t_decode, 1e-9)
    log(f"prefill: {t_prefill * 1e3:.1f} ms for "
        f"{args.batch}x{args.prompt_len} tokens")
    log(f"decode : {tok_s:,.1f} tok/s ({steps} steps)")
    log("generated ids (first row):", generated[0][:16])
    return {"prompts": prompts, "prefill_logits": prefill_logits,
            "generated": generated,
            "prefill_ms": t_prefill * 1e3, "decode_s": t_decode,
            "decode_tok_s": tok_s}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                    "PyTorch kernels)")
    ap.add_argument("--seed", type=int, default=0)
    # featurize->score service
    ap.add_argument("--bundle", default=None,
                    help="served-model bundle directory -> run the "
                    "featurize+score service instead of the LM path")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--max-rows", type=int, default=32,
                    help="synthetic request sizes draw from [1, max-rows]")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket ladder override")
    ap.add_argument("--deadline-s", type=float, default=30.0)
    ap.add_argument("--hard-timeout-s", type=float, default=0.0)
    ap.add_argument("--stats-port", type=int, default=None,
                    help="expose GET /stats on this port (0 = pick free)")
    # LM decode
    ap.add_argument("--arch", default=None,
                    help="LM architecture (repro_torch.configs.ARCHS)")
    ap.add_argument("--variant", default="smoke", choices=("full", "smoke"))
    ap.add_argument("--attn-impl", default=None,
                    choices=("naive", "chunked", "flash"),
                    help="override the config's attn_impl")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="under torchrun: a (data, model) mesh over the "
                         "ranks (default: the local mesh, data = the "
                         "ranks)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, a multiple of "
                    "the block pattern (0 = the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    return ap


def main(argv=None):
    from repro_torch.launch.mesh import join_torchrun_group
    ap = parser()
    args = ap.parse_args(argv)
    if args.bundle is not None:
        serve_bundle(args)
    elif args.arch is not None:
        args.device, made = join_torchrun_group(args.device)
        try:
            return serve_lm(args)
        finally:
            if made:
                dist.destroy_process_group()
    else:
        ap.error("pass --bundle DIR (featurize->score service) or "
                 "--arch NAME (LM decode)")


if __name__ == "__main__":
    main()
