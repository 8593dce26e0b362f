"""The ranks of ``tests/test_torch_sharded_attn_bwd.py``: the
sequence-parallel attention schedules and the sequence-parallel LM forward
differentiated over gloo ranks.  Each world size runs its cases in one
group, rank 0 writing the results.  A module of its own, without JAX: the
spawned ranks import it, and the reference's weights reach them as numpy
trees.
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
from repro_torch.data.loader import TokenBatchLoader
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import collectives
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import sharding as t_sharding
from repro_torch.optim import tree_leaves

# the schedules' cases: (b, S, H, G, D) at windows 0 and 32
SHAPE = (2, 128, 4, 2, 16)
WINDOWS = (0, 32)
SCHEDULES = ("ring", "allgather")
# the LM forward: a gemma3-shaped smoke model, 2 layers (one local with
# window 32, one global), 2 x 192 tokens; the attention routes it is
# differentiated through, by config overrides (attn_ring_min_sk at the
# sequence sends the flash route around the ring)
LM_BATCH, LM_SEQ = 2, 192
LM_OVER = dict(n_layers=2, block_pattern=("local", "attn"))
IMPLS = {"naive": dict(attn_impl="naive"),
         "chunked": dict(attn_impl="chunked"),
         "flash": dict(attn_impl="flash"),
         "ring": dict(attn_impl="flash", attn_ring_min_sk=LM_SEQ)}
# world size -> the cases it runs: the schedules at 2 and 4 ranks, the LM
# forward at 1, 3 and 4
WORLDS = {1: ("lm",), 2: ("schedules",), 3: ("lm",),
          4: ("schedules", "lm")}


def qkv(seed, window, shape=SHAPE):
    """q, k, v and the output's cotangent (numpy fp32, N(0, 1)) of
    ``shape`` (b, S, H, G, D)."""
    b, s, h, g, d = shape
    rng = np.random.default_rng(seed + window)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, g, d)).astype(np.float32),
            rng.standard_normal((b, s, g, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32))


def schedule_case(mesh, name, window):
    """This rank's shards through ``name``'s schedule and its backward:
    the output rows, dq rows and the dk / dv of its home shard, gathered
    whole along the sequence."""
    n, me = mesh.shape["model"], mesh.axis_index("model")
    q, k, v, g = (torch.from_numpy(a) for a in qkv(7, window))
    sl = q.shape[1] // n
    rows = [t.narrow(1, me * sl, sl).clone().requires_grad_(t is not g)
            for t in (q, k, v, g)]
    fn = fa.ring_flash_attention if name == "ring" else \
        fa.sharded_flash_attention
    kw = {} if name == "ring" else {"chunk": 32}
    out = fn(*rows[:3], window=window, mesh=mesh, seq_axes=("model",), **kw)
    grads = torch.autograd.grad(out, rows[:3], rows[3])
    return [collectives.all_gather_dim(t.detach(), mesh, "model", dim=1)
            for t in (out,) + grads]


def lm_cfg(impl):
    return dataclasses.replace(t_configs.get_config("gemma3_12b", "smoke"),
                               **LM_OVER, **IMPLS[impl])


def lm_batch(vocab):
    x, y = next(TokenBatchLoader(vocab=vocab, global_batch=LM_BATCH,
                                 seq_len=LM_SEQ, seed=0))
    return torch.from_numpy(x), torch.from_numpy(y)


def lm_grads(cfg, weights, rules=None):
    """The mean next-token nll of ``lm_batch`` and its gradient for every
    leaf: under ``use_rules(rules)`` each rank feeds its shard of the
    sequence, divides its nll sum by the global token count and sums the
    leaves' gradients over the ranks (the weights are whole on every
    rank)."""
    params = interop.lm_params(weights, cfg, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens, labels = lm_batch(cfg.vocab)
    if rules is None:
        loss, _ = t_model.train_loss(params, tokens, labels, cfg)
    else:
        tokens, labels = (t_sharding.local_shard(t, rules, "batch", "sp")
                          for t in (tokens, labels))
        with t_sharding.use_rules(rules):
            hidden, _, _ = t_model.forward(params, tokens, cfg)
        tot, cnt = t_layers.cross_entropy_sums(params["embed"], hidden,
                                               labels, cfg)
        axes = rules.mesh.axis_names
        loss = tot / collectives.axis_sum(cnt.detach(), rules.mesh, axes)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if rules is not None:
        axes = rules.mesh.axis_names
        loss = collectives.axis_sum(loss.detach(), rules.mesh, axes)
        grads = [collectives.axis_sum(g, rules.mesh, axes) for g in grads]
    return float(loss), [g.detach() for g in grads]


def rank_main(rank, world, init, outdir, weights):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        res = {}
        mesh = t_mesh.make_mesh(1, world)
        if "schedules" in WORLDS[world]:
            for name in SCHEDULES:
                for w in WINDOWS:
                    res[("schedule", name, w, world)] = schedule_case(
                        mesh, name, w)
        if "lm" in WORLDS[world]:
            rules = t_sharding.make_rules(mesh)
            for impl in IMPLS:
                res[("lm", impl, world)] = lm_grads(lm_cfg(impl), weights,
                                                    rules)
        if rank == 0:
            torch.save(res, os.path.join(outdir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def start_worlds(weights, root):
    """Spawn every world size's group at once (``join=False``); returns
    {world: (process context, its directory)}."""
    out = {}
    for world in WORLDS:
        d = os.path.join(root, f"world{world}")
        os.makedirs(d, exist_ok=True)
        ctx = mp.spawn(rank_main, args=(world, f"file://{d}/rendezvous", d,
                                        weights),
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
