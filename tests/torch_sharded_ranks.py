"""The ranks of ``tests/test_torch_lm_sharded_train.py``: each world size
runs its cases in one gloo group, rank 0 writing the results.  A module of
its own, without JAX: the spawned ranks import it, and the reference's
states reach them as the port's ``TrainState`` of numpy arrays.
"""
import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.checkpoint import checkpointer as t_ckpt
from repro_torch.data.loader import TokenBatchLoader
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import train as t_train
from repro_torch.models import layers as t_layers
from repro_torch.models import sharding as t_sharding
from repro_torch.optim import compression as t_comp
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim import tree_leaves
from repro_torch.training import trainer as t_trainer

LR, STEPS, BATCH, SEQ = 1e-3, 3, 4, 128

# name -> (arch, config overrides, hparam overrides)
CONFIGS = {
    "gemma3-chunked-2micro": ("gemma3_12b", {}, dict(n_microbatches=2)),
    # more microbatches than a data rank's rows (ROADMAP C11)
    "gemma3-chunked-4micro": ("gemma3_12b", {}, dict(n_microbatches=4)),
    "gemma3-flash": ("gemma3_12b", dict(attn_impl="flash"), {}),
    "starcoder2-flash": ("starcoder2_7b", dict(attn_impl="flash"), {}),
    "nemotron-bf16": ("nemotron_4_340b", {}, {}),
    "mamba2": ("mamba2_780m", {}, {}),
    "recurrentgemma": ("recurrentgemma_2b", {}, {}),
    "gemma3-compressed": ("gemma3_12b", {}, dict(compress_grads=True)),
}
# world size -> [(config, data, model)]
CASES = {
    1: [("gemma3-chunked-2micro", 1, 1), ("gemma3-flash", 1, 1)],
    2: [("gemma3-chunked-2micro", 2, 1), ("gemma3-chunked-2micro", 1, 2),
        ("gemma3-flash", 2, 1), ("gemma3-flash", 1, 2), ("mamba2", 2, 1),
        ("recurrentgemma", 2, 1), ("gemma3-chunked-4micro", 2, 1)],
    4: [("gemma3-chunked-2micro", 2, 2), ("gemma3-chunked-2micro", 1, 4),
        ("gemma3-flash", 2, 2), ("gemma3-flash", 1, 4),
        ("starcoder2-flash", 2, 2), ("nemotron-bf16", 2, 2),
        ("mamba2", 4, 1), ("recurrentgemma", 4, 1),
        ("gemma3-compressed", 2, 2)],
}

def port_cfg(name):
    """(the port's smoke config, its hparams) of case config ``name``."""
    arch, over, hp_over = CONFIGS[name]
    cfg = dataclasses.replace(t_configs.get_config(arch, "smoke"), **over)
    return cfg, t_trainer.TrainHparams(lr=LR, warmup=2, total_steps=30,
                                       **hp_over)


def batches(vocab, data=1, index=0):
    """STEPS batches of the global batch (the loader of one process, whose
    rows are the reference's bit for bit), or data rank ``index``'s rows
    of it when ``data`` > 1: every mesh sees the same global batch."""
    ld = TokenBatchLoader(vocab=vocab, global_batch=BATCH, seq_len=SEQ,
                          seed=0)
    rows = slice(index * BATCH // data, (index + 1) * BATCH // data)
    out = []
    for _ in range(STEPS):
        x, y = next(ld)
        out.append((x[rows], y[rows]))
    return out


def run_port(name, state, batch_list, rules=None, colls=None):
    """(losses, grad norms, first step's gradients, final state); the
    first step's ``collectives_snapshot`` appended to ``colls``."""
    cfg, hp = port_cfg(name)
    grads = []
    step = t_trainer.make_train_step(
        cfg, hp, rules, on_grads=lambda g: grads.append(g) if not grads
        else None)
    losses, norms = [], []
    for x, y in batch_list:
        coll.reset_collectives()
        state, m = step(state, {"inputs": torch.from_numpy(x),
                                "labels": torch.from_numpy(y)})
        if colls is not None and not losses:
            colls.append(coll.collectives_snapshot())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, grads[0], state


def rank_case(name, data, model, states, res):
    tc, ht = port_cfg(name)
    mesh = t_mesh.make_mesh(data, model)
    rules = t_sharding.make_rules(mesh)
    state = interop.lm_train_state(states[name], tc, device="cpu",
                                   rules=rules)
    mine = batches(tc.vocab, data, mesh.coords["data"])
    colls = []
    losses, norms, g0, state = run_port(name, state, mine, rules, colls)
    # every rank's first-step collectives, for the dry run's count
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, colls[0])
    specs = t_trainer.param_pspecs(tc, rules)
    g0 = t_sharding.gather_params(g0, rules, specs)
    params = t_sharding.gather_params(state.params, rules, specs)
    res[f"{name}@{data}x{model}"] = {
        "losses": losses, "norms": norms, "grads": tree_leaves(g0),
        "params": tree_leaves(params), "collectives": every}
    return mesh, rules, state


def unit_checks(world, res):
    """The collectives' backward (gradcheck), the vocab-sharded loss, the
    int8 shard and the global norm over shards, on every rank."""
    mesh = t_mesh.make_mesh(1, world)
    axes, me = ("model",), mesh.rank
    torch.manual_seed(1)
    # the same x on every rank, and one function of it on every rank:
    # a replicated input reaches rank-local work through Megatron's f
    # (``sum_backward``), rank-local results leave through g
    # (``sum_forward``) into their blocks of one replicated output.  Each
    # collective is taken as the model takes it: an all-gather's result
    # feeds rank-local work (its backward sums the ranks' partial
    # gradients), a ``sum_forward``'s feeds work the same on every rank
    x = torch.randn(2 * world, 4 * world, 2, dtype=torch.float64,
                    requires_grad=True)

    def mine(t, dim):
        return coll.sum_backward(t, mesh, axes).chunk(world, dim)[me]

    def place(y):
        parts = [torch.zeros_like(y) for _ in range(world)]
        parts[me] = y
        return coll.sum_forward(torch.cat(parts, 0), mesh, axes)

    ok = []
    for fn in (lambda t: place(coll.all_gather_grad(mine(t, 1), mesh, axes,
                                                    1)),
               lambda t: place(coll.reduce_scatter_grad(
                   coll.sum_backward(t, mesh, axes) * (me + 1), mesh, axes,
                   1)),
               lambda t: coll.sum_forward(mine(t, 1), mesh, axes),
               lambda t: place(coll.sum_backward(t, mesh, axes) * (me + 1)),
               lambda t: place(coll.reshard_grad(mine(t, 0), mesh, axes, 1,
                                                 0))):
        ok.append(bool(torch.autograd.gradcheck(fn, (x,), eps=1e-6,
                                                atol=1e-8)))
    m = coll.max_nograd(x.abs() * (me + 1), mesh, axes)
    ok.append(bool(torch.equal(m, (x.abs() * world).detach())))
    res["gradcheck"] = ok

    # the vocab-sharded loss against chunked_cross_entropy, with a vocab
    # of 300 (padded 512), labels -1 and beyond the vocabulary
    tc, _ = port_cfg("starcoder2-flash")
    tc = dataclasses.replace(tc, vocab=300, loss_chunk=24,
                             logit_softcap=30.0)
    rules = t_sharding.make_rules(mesh)
    gen = torch.Generator().manual_seed(5)
    head = torch.randn(tc.d_model, tc.padded_vocab, generator=gen) * 0.3
    hid = torch.randn(2, 8 * world, tc.d_model, generator=gen)
    labels = torch.randint(0, 300, (2, 8 * world), generator=gen)
    labels[0, :3] = -1
    labels[1, 5] = 400
    out = {}
    for tied in (False, True):
        cfg = dataclasses.replace(tc, tie_embeddings=tied)
        specs = t_trainer.param_pspecs(cfg, rules)["embed"]
        whole = {"tokens": torch.randn(cfg.padded_vocab, cfg.d_model,
                                       generator=gen)}
        if not tied:
            whole["head"] = head
        local = {k: t_sharding.shard_of(v, mesh, specs[k]).clone()
                 .requires_grad_(True) for k, v in whole.items()}
        h_local = t_layers.seq_shard(hid, t_sharding.TrainLayout(
            rules, {"embed": specs})).clone().requires_grad_(True)
        layout = t_sharding.TrainLayout(rules, {"embed": specs})
        tot, cnt = t_layers.cross_entropy_sums_tp(local, h_local, labels,
                                                  cfg, layout, specs)
        (tot / cnt).backward()
        w = "tokens" if tied else "head"
        out[tied] = (float((tot / cnt).detach()), float(cnt),
                     coll.all_gather_dim(h_local.grad, mesh, axes, 1),
                     t_sharding.gather_params({w: local[w].grad}, rules,
                                              {w: specs[w]})[w],
                     whole[w], hid, labels, cfg)
    res["ce"] = out

    # int8 compression and the global norm over shards
    gen = torch.Generator().manual_seed(7)
    tree = {"a": torch.randn(4 * world, 6, generator=gen),
            "b": torch.randn(5, generator=gen)}
    spec = {"a": ("model", None), "b": (None,)}
    resid = {"a": torch.randn(4 * world, 6, generator=gen) * 0.01,
             "b": torch.randn(5, generator=gen) * 0.01}
    loc = t_sharding.shard_params(tree, rules, spec)
    loc_r = t_sharding.shard_params(resid, rules, spec)
    comp, new_r = t_comp.error_feedback_compress(loc, loc_r, mesh=mesh)
    want_c, want_r = t_comp.error_feedback_compress(tree, resid)
    ok = [torch.equal(comp["a"], t_sharding.shard_of(want_c["a"], mesh,
                                                     spec["a"])),
          torch.equal(comp["b"], want_c["b"]),
          torch.equal(new_r["a"], t_sharding.shard_of(want_r["a"], mesh,
                                                      spec["a"]))]
    counted = [t_sharding.owns_replica(mesh, spec[k]) for k in ("a", "b")]
    ok.append(torch.equal(t_opt.global_norm(loc, counted=counted, mesh=mesh),
                          t_opt.global_norm(tree)))
    res["shard_units"] = ok


def refusals(res):
    """Under the train layout: the MoE with the batch split, the SSM and
    RG-LRU with model > 1 (ROADMAP A12.8) and heads that do not divide
    over model (A12.6) train; sequence axes other than the tp axes and a
    sequence that does not divide over model raise."""
    out = {}
    gemma = t_configs.get_config("gemma3_12b", "smoke")
    for name, cfg, (data, model), seq, over in (
            ("moe", t_configs.get_config("olmoe_1b_7b", "smoke"), (2, 1),
             SEQ, None),
            ("ssm", t_configs.get_config("mamba2_780m", "smoke"), (1, 2),
             SEQ, None),
            ("rglru", t_configs.get_config("recurrentgemma_2b", "smoke"),
             (1, 2), SEQ, None),
            ("heads", dataclasses.replace(gemma, n_heads=3, n_kv_heads=1),
             (1, 2), SEQ, None),
            ("sp_axes", gemma, (2, 1), SEQ, {"sp": "data"}),
            ("ragged", gemma, (1, 2), SEQ - 1, None)):
        rules = t_sharding.make_rules(t_mesh.make_mesh(data, model), over)
        hp = t_trainer.TrainHparams()
        try:
            st = t_trainer.init_train_state(cfg, hp, device="cpu",
                                            rules=rules)
            step = t_trainer.make_train_step(cfg, hp, rules)
            toks = torch.zeros((BATCH // data, seq), dtype=torch.int32)
            _, m = step(st, {"inputs": toks, "labels": toks})
            out[name] = "ran" if bool(torch.isfinite(m["loss"])) else \
                f"loss {float(m['loss'])}"
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    res["refusals"] = out


def checkpoint_case(outdir, states, res):
    """gemma3 at (2, 2): two steps, a sharded save, then restores at
    (4, 1) and by each rank of (2, 2), gathered; the unsharded and the
    reference's restores run in the parent."""
    name = "gemma3-chunked-2micro"
    tc, ht = port_cfg(name)
    mesh = t_mesh.make_mesh(2, 2)
    rules = t_sharding.make_rules(mesh)
    state = interop.lm_train_state(states[name], tc, device="cpu",
                                   rules=rules)
    _, _, _, state = run_port(name, state, batches(
        tc.vocab, 2, mesh.coords["data"])[:2], rules)
    specs = t_trainer.state_pspecs(tc, rules, ht)
    d = os.path.join(outdir, "ckpt")
    ck = t_ckpt.Checkpointer(d, mesh=mesh, specs=specs)
    ck.save_async(2, state, extra={"loader": {"step": 2, "seed": 0}})
    ck.wait()
    whole = t_sharding.map_specs(
        lambda t, sp: t_sharding.gather_params(t, rules, sp), state, specs)
    template = t_trainer.init_train_state(tc, ht, device="meta")
    out = {"saved": tree_leaves(whole)}
    for data, model in ((4, 1), (2, 2), (1, 4)):
        m2 = t_mesh.make_mesh(data, model)
        r2 = t_sharding.make_rules(m2)
        sp2 = t_trainer.state_pspecs(tc, r2, ht)
        got = t_ckpt.restore_checkpoint(d, 2, template, device="cpu",
                                        shardings=sp2, mesh=m2)
        got = t_sharding.map_specs(
            lambda t, sp: t_sharding.gather_params(t, r2, sp), got, sp2)
        out[f"{data}x{model}"] = tree_leaves(got)
    res["checkpoint"] = out


def rank_main(rank, world, init, outdir, cases, states):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=180))
    try:
        res = {}
        for name, data, model in cases:
            rank_case(name, data, model, states, res)
        if world > 1:
            unit_checks(world, res)
        if world == 2:
            refusals(res)
        if world == 4:
            checkpoint_case(outdir, states, res)
        if rank == 0:
            torch.save(res, os.path.join(outdir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def start_worlds(states, root):
    """Spawn every world size's group at once (``join=False``); returns
    {world: (process context, its directory)}."""
    out = {}
    for world, cases in CASES.items():
        d = os.path.join(root, f"world{world}")
        os.makedirs(d, exist_ok=True)
        ctx = mp.spawn(rank_main, args=(world, f"file://{d}/rendezvous", d,
                                        cases, states),
                       nprocs=world, join=False)
        out[world] = (ctx, d)
    return out


def join_worlds(started):
    """{world: rank 0's results}, after every rank of every world ends."""
    out = {}
    for world, (ctx, d) in started.items():
        while not ctx.join():
            pass
        out[world] = torch.load(os.path.join(d, "rank0.pt"),
                                weights_only=False)
        out[world]["dir"] = d
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def driver_rank(rank, world, port, argv):
    """One rank of ``launch.train``'s ``main`` in torchrun's environment."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    t_train.main(argv)
