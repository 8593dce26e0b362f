"""The ranks of ``tests/test_torch_grouped_heads.py``: attention heads that
do not divide over ``model``, trained and served under the sharded layout
over gloo ranks.  Each world size runs its cases in one group, rank 0
writing the results.  A module of its own, without JAX: the spawned ranks
import it, and the reference's states and weights reach them as the
port's trees of numpy arrays.
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
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import model as t_model
from repro_torch.models import sharding as t_sharding
from repro_torch.optim import tree_leaves
from repro_torch.training import trainer as t_trainer

# name -> (arch, overrides of its smoke config): starcoder2's own smoke
# config (6 / 2 heads), and smoke configs carrying the full configs' head
# counts at head dim 16: recurrentgemma's 10 / 1, starcoder2's 36 / 4 and
# llama4's 40 / 8 (with its qk-norm, which acts per head)
CONFIGS = {
    "starcoder2": ("starcoder2_7b", {}),
    "rg10": ("recurrentgemma_2b", dict(n_heads=10, n_kv_heads=1,
                                       head_dim=16)),
    "sc36": ("starcoder2_7b", dict(n_heads=36, n_kv_heads=4, head_dim=16)),
    "ll40": ("llama4_maverick_400b_a17b", dict(n_heads=40, n_kv_heads=8,
                                               head_dim=16)),
}
# "flash" on the plain version of row 8 (the all-gather route at these
# lengths), "ring" the same with attn_ring_min_sk lowered to the sequence
# so that the flash route takes row 9's ring and its reverse-ring
# backward, "chunked" the grouped cores
IMPLS = {"flash": dict(attn_impl="flash"),
         "ring": dict(attn_impl="flash", attn_ring_min_sk=96),
         "chunked": dict(attn_impl="chunked")}
# world size -> meshes (data, model)
MESHES = {3: [(1, 3)], 4: [(1, 4)]}
LR, STEPS, BATCH, SEQ = 1e-3, 3, 2, 96
# serving: PROMPT tokens into SLOTS slots (dividing over 3 and 4, so the
# slots are sliced over kv_seq), GEN greedy steps
SV_BATCH, PROMPT, SLOTS, GEN = 2, 96, 108, 8


def port_cfg(name, impl):
    arch, over = CONFIGS[name]
    return dataclasses.replace(t_configs.get_config(arch, "smoke"),
                               **over, **IMPLS[impl])


def hparams():
    return t_trainer.TrainHparams(lr=LR, warmup=2, total_steps=30)


def batches(vocab):
    """STEPS global batches of TokenBatchLoader(seed=0)."""
    ld = TokenBatchLoader(vocab=vocab, global_batch=BATCH, seq_len=SEQ,
                          seed=0)
    return [next(ld) for _ in range(STEPS)]


def run_train(cfg, state, rules=None):
    """STEPS steps: every step's loss, the first step's gradients and the
    final state."""
    grads = []
    step = t_trainer.make_train_step(
        cfg, hparams(), rules,
        on_grads=lambda g: grads.append(g) if not grads else None)
    losses = []
    for x, y in batches(cfg.vocab):
        state, m = step(state, {"inputs": torch.from_numpy(x),
                                "labels": torch.from_numpy(y)})
        losses.append(float(m["loss"]))
    return losses, grads[0], state


def prompts(cfg):
    return np.random.default_rng(9).integers(0, cfg.vocab,
                                             (SV_BATCH, PROMPT))


def serve(cfg, params, rules=None):
    """A prefill and GEN greedy decode steps through
    ``make_serve_steps(cfg, rules)``: every step's logits (B, GEN + 1, V)
    and the ids."""
    pre, dec = t_trainer.make_serve_steps(cfg, rules)
    caches = t_model.init_caches(cfg, SV_BATCH, SLOTS, rules=rules,
                                 device="cpu")
    with torch.no_grad():
        logits, caches = pre(params, torch.from_numpy(prompts(cfg)), caches)
        outs, ids = [logits], []
        for t in range(GEN):
            tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
            ids.append(tok)
            logits, caches = dec(params, tok, PROMPT + t, caches)
            outs.append(logits)
    return torch.stack(outs, 1), torch.cat(ids, 1)


def rank_case(name, impl, rules, payload):
    """One case on this rank: the train losses, step 1's gradients and
    the final parameters gathered whole; the served logits and ids."""
    cfg = port_cfg(name, impl)
    state = interop.lm_train_state(payload["states"][name], cfg,
                                   device="cpu", rules=rules)
    losses, g0, state = run_train(cfg, state, rules)
    specs = t_trainer.param_pspecs(cfg, rules)
    params = interop.lm_params(payload["weights"][name], cfg, device="cpu",
                               rules=rules)
    logits, ids = serve(cfg, params, rules)
    return {"losses": losses,
            "grads": tree_leaves(t_sharding.gather_params(g0, rules, specs)),
            "params": tree_leaves(t_sharding.gather_params(
                state.params, rules, specs)),
            "logits": logits, "ids": ids,
            "wq_local": next(tuple(b["mixer"]["wq"].shape)
                             for b in state.params["units"].values()
                             if "wq" in b["mixer"])}


def rank_main(rank, world, init, outdir, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        res = {}
        for data, model in MESHES[world]:
            rules = t_sharding.make_rules(t_mesh.make_mesh(data, model))
            for name in CONFIGS:
                for impl in IMPLS:
                    res[(name, impl, (data, model))] = rank_case(
                        name, impl, rules, payload)
        if rank == 0:
            torch.save(res, os.path.join(outdir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def start_worlds(payload, root):
    """Spawn every world size's group at once (``join=False``); returns
    {world: (process context, its directory)}."""
    out = {}
    for world in MESHES:
        d = os.path.join(root, f"world{world}")
        os.makedirs(d, exist_ok=True)
        ctx = mp.spawn(rank_main, args=(world, f"file://{d}/rendezvous", d,
                                        payload),
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
