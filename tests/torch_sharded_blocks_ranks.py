"""The ranks of ``tests/test_torch_lm_sharded_blocks.py`` and
``tests/test_torch_lm_sharded_blocks_serve.py``: the MoE, SSM and RG-LRU
configs' smoke models trained, served and run sequence-parallel over gloo
ranks.  Each world size runs its cases in one group, rank 0 writing the
results.  A module of its own, without JAX: the spawned ranks import it,
and the reference's states and weights reach them as the port's trees of
numpy arrays.
"""
import contextlib
import dataclasses
import datetime
import os
import threading

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_sharded_ranks as SR
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import sharding as t_sharding
from repro_torch.optim import tree_leaves
from repro_torch.training import trainer as t_trainer

ARCHS = {"olmoe": "olmoe_1b_7b", "llama4": "llama4_maverick_400b_a17b",
         "mamba2": "mamba2_780m", "recurrentgemma": "recurrentgemma_2b"}
# world size -> meshes (data, model); every smoke config's heads, SSM
# heads and RG-LRU width divide over model = 1, 2 and 4
MESHES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4), (4, 1)]}
# the sequence-parallel forward: the global batch and sequence (128 tokens
# pass the smoke configs' attn_chunk of 64, so attention takes the flash
# schedules that the forward requires)
FWD_BATCH, FWD_SEQ = 2, 128
# serving: a prompt of PROMPT tokens into SLOTS cache slots, GEN greedy
# steps; the trap's prompt: olmoe's smoke config routes top-2, so 160
# tokens make 320 pairs (over the dropless limit of 256) while each of
# two sequence shards holds 80 tokens, 160 pairs (under it)
SV_BATCH, PROMPT, GEN, SLOTS = 2, 96, 4, 104
TRAP_PROMPT, TRAP_MESH = 160, (1, 2)
# the SSM fallback: mamba2's smoke config with 2 heads of 64 (its d_in of
# 128 still divides over model = 4, so out_proj shards off the heads)
SSM_WIDE_HEADS = {"head_dim": 64}


def port_cfg(arch, impl="chunked", ssm=None):
    cfg = dataclasses.replace(t_configs.get_config(ARCHS[arch], "smoke"),
                              attn_impl=impl)
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm))
    return cfg


def hparams():
    return t_trainer.TrainHparams(lr=SR.LR, warmup=2, total_steps=30)


def compute_copy(cfg, params):
    """The train step's differentiated copy: masters in the compute
    dtype, the fp32 leaves as they are."""
    return {k: compute_copy(cfg, v) if isinstance(v, dict) else
            (v.to(cfg.compute_dtype) if v.dtype == cfg.master_dtype else v)
            for k, v in params.items()}


_SPY = threading.Lock()


@contextlib.contextmanager
def spy_slots():
    """Record this thread's ``moe.dispatch_slots`` calls' (slot, valid);
    one spy at a time (the tests run their oracles in threads)."""
    seen = []
    real = t_moe.dispatch_slots
    me = threading.get_ident()

    def spy(top_i, n_experts, cap):
        out = real(top_i, n_experts, cap)
        if threading.get_ident() == me:
            seen.append(out)
        return out
    with _SPY:
        t_moe.dispatch_slots = spy
        try:
            yield seen
        finally:
            t_moe.dispatch_slots = real


def forward_slots(cfg, params, tokens, rules=None):
    """One forward of the model's first batch (this rank's rows): every
    MoE block's slots and kept flags (B, S*K), gathered over the batch
    ranks, and the aux terms."""
    layout = None
    if rules is not None:
        layout = t_sharding.TrainLayout(rules,
                                        t_trainer.param_pspecs(cfg, rules))
    with torch.no_grad(), spy_slots() as seen:
        _, _, aux = t_model.forward(compute_copy(cfg, params),
                                    torch.as_tensor(tokens), cfg,
                                    layout=layout)
    got = [torch.stack([slot, valid.long()]) for slot, valid in seen]
    if rules is not None:
        rows = t_trainer.input_specs(cfg, rules, shape="train",
                                     seq_len=SR.SEQ,
                                     global_batch=SR.BATCH)["inputs"].spec
        got = [t_sharding.gather_params(t, rules, (None,) + rows)
               for t in got]
    return got, {k: float(v) for k, v in aux.items()}


def run_train(cfg, state, batch_list, rules=None):
    """STEPS steps: every step's metrics, the first step's gradients and
    the final state."""
    grads = []
    step = t_trainer.make_train_step(
        cfg, hparams(), rules,
        on_grads=lambda g: grads.append(g) if not grads else None)
    metrics = []
    for x, y in batch_list:
        state, m = step(state, {"inputs": torch.from_numpy(x),
                                "labels": torch.from_numpy(y)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads[0], state


def train_case(arch, mesh, rules, states):
    cfg = port_cfg(arch)
    state = interop.lm_train_state(states[arch], cfg, device="cpu",
                                   rules=rules)
    mine = SR.batches(cfg.vocab, *mesh_rows(mesh))
    slots, _ = forward_slots(cfg, state.params, mine[0][0], rules)
    metrics, g0, state = run_train(cfg, state, mine, rules)
    specs = t_trainer.param_pspecs(cfg, rules)
    return {"metrics": metrics, "slots": slots,
            "grads": tree_leaves(t_sharding.gather_params(g0, rules, specs)),
            "params": tree_leaves(t_sharding.gather_params(
                state.params, rules, specs)),
            "local_shapes": {"/".join(p): tuple(t.shape) for p, t in
                             t_sharding.named_leaves(state.params)}}


def mesh_rows(mesh):
    return mesh.shape["data"], mesh.coords["data"]


def fwd_tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab,
                                             (FWD_BATCH, FWD_SEQ))


def seq_forward(cfg, params, rules=None):
    """The forward of ``fwd_tokens`` under ``use_rules(rules)`` (this
    rank's shard of the batch and the sequence), the hidden state gathered
    whole, and the aux terms."""
    tokens = torch.from_numpy(fwd_tokens(cfg))
    if rules is None:
        hidden, _, aux = t_model.forward(params, tokens, cfg)
    else:
        local = t_sharding.local_shard(tokens, rules, "batch", "sp")
        with t_sharding.use_rules(rules):
            hidden, _, aux = t_model.forward(params, local, cfg)
        hidden = t_sharding.gather_shards(hidden, rules,
                                          tuple(tokens.shape) +
                                          (cfg.d_model,), "batch", "sp")
    return hidden, {k: float(v) for k, v in aux.items()}


def prompts(cfg, batch, prompt):
    return np.random.default_rng(9).integers(0, cfg.vocab, (batch, prompt))


def serve(cfg, params, inputs, batch, prompt, slots, steps, rules=None):
    """A prefill through ``forward`` (its aux kept) and ``steps`` greedy
    decode steps through ``make_serve_steps(cfg, rules)``: every step's
    logits (B, steps + 1, V), the ids, the caches and the prefill's
    aux."""
    _, dec = t_trainer.make_serve_steps(cfg, rules)
    layout = None if rules is None else t_sharding.TrainLayout(
        rules, t_trainer.param_pspecs(cfg, rules))
    caches = t_model.init_caches(cfg, batch, slots, rules=rules,
                                 device="cpu")
    with torch.no_grad():
        hidden, caches, aux = t_model.forward(
            params, torch.as_tensor(inputs), cfg, caches=caches,
            update_cache=True, layout=layout)
        last = hidden[:, -1:] if layout is None else \
            t_model.last_position(hidden, layout)
        logits = t_model._logits(params, last, cfg, layout)[:, 0]
        outs, ids = [logits], []
        for t in range(steps):
            tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
            ids.append(tok)
            logits, caches = dec(params, tok, prompt + t, caches)
            outs.append(logits)
    return (torch.stack(outs, 1), torch.cat(ids, 1), caches,
            {k: float(v) for k, v in aux.items()})


def serve_case(arch, mesh, rules, weights, prompt=PROMPT, slots=SLOTS,
               steps=GEN):
    """A serving case on this rank: the whole batch's logits and ids, the
    caches gathered whole, the prefill's aux and every rank's ids."""
    cfg = port_cfg(arch)
    rows = t_trainer.input_specs(cfg, rules, shape="prefill",
                                 seq_len=prompt,
                                 global_batch=SV_BATCH)["inputs"].spec[:1]
    params = interop.lm_params(weights[arch], cfg, device="cpu", rules=rules)
    mine = t_sharding.shard_of(torch.from_numpy(prompts(cfg, SV_BATCH,
                                                        prompt)),
                               mesh, rows)
    logits, ids, caches, aux = serve(cfg, params, mine, SV_BATCH, prompt,
                                     slots, steps, rules)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.rank, t_sharding.shard_bounds(
        (SV_BATCH,), rows, mesh)[0], ids))
    return {"logits": t_sharding.gather_params(logits, rules,
                                               rows + (None, None)),
            "ids": t_sharding.gather_params(ids, rules, rows + (None,)),
            "every_ids": every,
            "caches": t_sharding.gather_params(tuple(caches), rules,
                                               caches.specs),
            "local_shapes": [tuple(t.shape) for _, t in
                             t_sharding.named_leaves(tuple(caches))],
            "aux": aux}


def ssm_fallback_case(mesh, rules, weights):
    """mamba2 with heads that do not divide over model: one train step's
    loss and gathered gradients, and a serving run's logits."""
    cfg = port_cfg("mamba2", ssm=SSM_WIDE_HEADS)
    whole = t_model.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    specs = t_trainer.param_pspecs(cfg, rules)
    hp = hparams()
    out = {}
    for name, r in (("sharded", rules), ("whole", None)):
        state = t_trainer.init_train_state(
            cfg, hp, generator=torch.Generator().manual_seed(3),
            device="cpu", rules=r)
        mine = SR.batches(cfg.vocab, *mesh_rows(mesh))[:1] if r else \
            SR.batches(cfg.vocab)[:1]
        metrics, g0, _ = run_train(cfg, state, mine, r)
        if r is not None:
            g0 = t_sharding.gather_params(g0, rules, specs)
        inputs = prompts(cfg, SV_BATCH, PROMPT)
        params = whole if r is None else t_sharding.shard_params(whole,
                                                                 rules, specs)
        logits = serve(cfg, params, inputs, SV_BATCH, PROMPT, SLOTS, GEN,
                       r)[0]
        out[name] = {"loss": metrics[0]["loss"], "grads": tree_leaves(g0),
                     "logits": logits}
    out["specs"] = {k: specs["units"]["block0"]["mixer"][k]
                    for k in ("conv_w", "out_proj")}
    return out


def rank_main(rank, world, init, outdir, job, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=180))
    try:
        res = {}
        for data, model in MESHES[world]:
            mesh = t_mesh.make_mesh(data, model)
            rules = t_sharding.make_rules(mesh)
            for arch in ARCHS:
                if job == "train":
                    res[("train", arch, (data, model))] = train_case(
                        arch, mesh, rules, payload)
                    res[("fwd", arch, (data, model))] = seq_forward(
                        port_cfg(arch, "flash"), interop.lm_params(
                            payload[arch].params, port_cfg(arch, "flash"),
                            device="cpu"), rules)
                else:
                    res[("serve", arch, (data, model))] = serve_case(
                        arch, mesh, rules, payload)
            if job == "serve" and (data, model) == TRAP_MESH:
                res[("trap", "olmoe", TRAP_MESH)] = serve_case(
                    "olmoe", mesh, rules, payload, prompt=TRAP_PROMPT,
                    slots=TRAP_PROMPT + 8, steps=1)
            if job == "train" and (data, model) == (1, 4):
                res["ssm_fallback"] = ssm_fallback_case(mesh, rules,
                                                        payload)
        if rank == 0:
            torch.save(res, os.path.join(outdir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def start_worlds(job, payload, root):
    """Spawn every world size's group at once (``join=False``); returns
    {world: (process context, its directory)}."""
    out = {}
    for world in MESHES:
        d = os.path.join(root, f"{job}{world}")
        os.makedirs(d, exist_ok=True)
        ctx = mp.spawn(rank_main, args=(world, f"file://{d}/rendezvous", d,
                                        job, payload),
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
