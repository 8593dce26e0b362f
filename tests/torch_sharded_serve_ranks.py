"""The ranks of ``tests/test_torch_lm_sharded_serve.py``: each world size
runs its cases in one gloo group, rank 0 writing the results.  A module of
its own, without JAX: the spawned ranks import it, and the reference's
weights reach them as numpy trees.
"""
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as t_model
from repro_torch.models import sharding as t_sharding
from repro_torch.training import trainer as t_trainer

PROMPT, STEPS = 96, 4
# prompt + steps + 4 slots: 104 divides over 2, 4 and 8 ranks, so the
# caches' slots are sliced, not left whole
MAX_LEN = PROMPT + STEPS + 4
IMPLS = ("chunked", "flash")
# name -> (arch, long, global batch).  A long cache's batch of 1 stays
# whole on every data rank (its slots span data too)
CONFIGS = {
    "gemma3": ("gemma3_12b", False, 2),
    "gemma3-long": ("gemma3_12b", True, 1),
    "granite": ("granite_34b", False, 2),
    "starcoder2": ("starcoder2_7b", False, 2),
    "musicgen": ("musicgen_large", False, 2),
}
MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2), (4, 1)]}
CASES = [(name, impl, mesh) for mesh in MESHES[2] + MESHES[4]
         for name in CONFIGS for impl in IMPLS]
# the reference's serving cells (batch, cache slots, long) whose cache
# shards every config allocates at every mesh
CELLS = {"prefill_32k": (32, 32768, False), "decode_32k": (128, 32768, False),
         "long_500k": (1, 524288, True)}


def port_cfg(name, impl):
    arch = CONFIGS[name][0]
    return dataclasses.replace(t_configs.get_config(arch, "smoke"),
                               attn_impl=impl)


def prompts(cfg, batch):
    """The global prompts: token ids, or embeddings for the stub
    frontends, from one numpy seed."""
    rng = np.random.default_rng(9)
    if cfg.input_mode == "embeddings":
        return rng.standard_normal((batch, PROMPT, cfg.d_model)).astype(
            np.float32)
    return rng.integers(0, cfg.vocab, (batch, PROMPT))


def serve(cfg, params, inputs, batch, long=False, rules=None):
    """Prefill, then STEPS greedy decode steps through
    ``make_serve_steps(cfg, rules)``: every step's logits (B, STEPS + 1,
    V), the ids (B, STEPS) and the caches."""
    pre, dec = t_trainer.make_serve_steps(cfg, rules)
    layout = None if rules is None else t_sharding.TrainLayout(
        rules, t_trainer.param_pspecs(cfg, rules))
    caches = t_model.init_caches(cfg, batch, MAX_LEN, long=long, rules=rules,
                                 device="cpu")
    logits, caches = pre(params, torch.from_numpy(inputs), caches)
    outs, ids = [logits], []
    for t in range(STEPS):
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        ids.append(tok)
        step_in = tok if cfg.input_mode != "embeddings" else \
            t_model.embed_generated(params, tok, cfg, layout=layout)
        logits, caches = dec(params, step_in, PROMPT + t, caches)
        outs.append(logits)
    return torch.stack(outs, 1), torch.cat(ids, 1), caches


def rank_case(name, impl, data, model, ref_params):
    """One case on this rank: the whole batch's logits and ids, the
    caches gathered whole, and every rank's ids; or the refusal."""
    arch, long, batch = CONFIGS[name]
    cfg = port_cfg(name, impl)
    mesh = t_mesh.make_mesh(data, model)
    rules = t_sharding.make_rules(mesh)
    rows = t_trainer.input_specs(cfg, rules, shape="prefill", seq_len=PROMPT,
                                 global_batch=batch)["inputs"].spec[:1]
    try:
        params = interop.lm_params(ref_params[arch], cfg, device="cpu",
                                   rules=rules)
        mine = t_sharding.shard_of(torch.from_numpy(prompts(cfg, batch)),
                                   mesh, rows).numpy()
        logits, ids, caches = serve(cfg, params, mine, batch, long, rules)
    except NotImplementedError as e:
        return {"refused": str(e)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.rank, t_sharding.shard_bounds(
        (batch,), rows, mesh)[0], ids))
    return {"logits": t_sharding.gather_params(logits, rules,
                                               rows + (None, None)),
            "ids": t_sharding.gather_params(ids, rules, rows + (None,)),
            "every_ids": every,
            "caches": t_sharding.gather_params(tuple(caches), rules,
                                               caches.specs),
            "local_shapes": [tuple(t.shape) for _, t in
                             t_sharding.named_leaves(tuple(caches))]}


def shard_shapes(data, model):
    """{(arch, cell): True where init_caches(rules=, long=, device="meta")
    allocates exactly this rank's shard_bounds of cache_pspecs, on every
    rank} for the ten full configs at the reference's serving cells."""
    mesh = t_mesh.make_mesh(data, model)
    rules = t_sharding.make_rules(mesh)
    out = {}
    for arch in t_configs.ARCHS:
        cfg = t_configs.get_config(arch, "full")
        for cell, (batch, max_len, long) in CELLS.items():
            got = t_model.init_caches(cfg, batch, max_len, long=long,
                                      rules=rules, device="meta")
            specs = t_trainer.cache_pspecs(cfg, rules, batch=batch,
                                           max_len=max_len, long=long)
            whole = t_model.init_caches(cfg, batch, max_len, device="meta")
            ok = got.specs == specs and all(
                tuple(t.shape) == tuple(hi - lo for lo, hi in
                                        t_sharding.shard_bounds(
                                            w.shape, sp, mesh))
                and t.device.type == "meta"
                for (_, t), (_, w), (_, sp) in zip(
                    t_sharding.named_leaves(tuple(got)),
                    t_sharding.named_leaves(whole),
                    t_sharding.named_specs(whole, specs)))
            out[(arch, cell)] = ok
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return {k: all(r[k] for r in every) for k in out}


def refusals():
    """``make_serve_steps(cfg, rules)`` on the MoE, SSM and RG-LRU blocks
    (ported: "ran", a prefill and a decode step each), and on sequence
    axes other than the tp axes (refused): each outcome."""
    out = {}
    for name, arch, (data, model), over in (
            ("moe", "olmoe_1b_7b", (2, 1), None),
            ("ssm", "mamba2_780m", (1, 2), None),
            ("rglru", "recurrentgemma_2b", (1, 2), None),
            ("sp_axes", "gemma3_12b", (2, 1), {"sp": "data"})):
        rules = t_sharding.make_rules(t_mesh.make_mesh(data, model), over)
        cfg = t_configs.get_config(arch, "smoke")
        try:
            pre, dec = t_trainer.make_serve_steps(cfg, rules)
            params = t_model.init_model(cfg, device="cpu", keep=lambda p, t: (
                t_sharding.shard_of(t, rules.mesh, t_sharding.spec_at(
                    t_trainer.param_pspecs(cfg, rules), p)).clone()))
            caches = t_model.init_caches(cfg, 2, 24, rules=rules,
                                         device="cpu")
            toks = torch.zeros((2 // data, 16), dtype=torch.long)
            logits, caches = pre(params, toks, caches)
            logits, caches = dec(params, toks[:, :1], 16, caches)
            out[name] = "ran" if bool(torch.isfinite(logits).all()) else \
                "non-finite logits"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def rank_main(rank, world, init, outdir, ref_params):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=180))
    try:
        res = {}
        for data, model in MESHES[world]:
            for name in CONFIGS:
                for impl in IMPLS:
                    res[(name, impl, (data, model))] = rank_case(
                        name, impl, data, model, ref_params)
            res[("shapes", (data, model))] = shard_shapes(data, model)
        if world == 2:
            res["refusals"] = refusals()
        if rank == 0:
            torch.save(res, os.path.join(outdir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def start_worlds(ref_params, root):
    """Spawn every world size's group at once (``join=False``); returns
    {world: (process context, its directory)}."""
    out = {}
    for world in MESHES:
        d = os.path.join(root, f"world{world}")
        os.makedirs(d, exist_ok=True)
        ctx = mp.spawn(rank_main, args=(world, f"file://{d}/rendezvous", d,
                                        ref_params),
                       nprocs=world, join=False)
        out[world] = (ctx, d)
    return out


def join_worlds(started):
    """Every case's results, after every rank of every world ends."""
    out = {}
    for world, (ctx, d) in started.items():
        while not ctx.join():
            pass
        out.update(torch.load(os.path.join(d, "rank0.pt"),
                              weights_only=False))
    return out


def serve_rank(rank, world, port, argv, outdir):
    """One rank of ``launch.serve``'s ``main`` in torchrun's environment;
    rank 0 writes what ``serve_lm`` returned."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    out = t_serve.main(argv)
    if rank == 0:
        torch.save({"generated": out["generated"],
                    "prefill_logits": out["prefill_logits"]},
                   os.path.join(outdir, "serve.pt"))
