"""Port parity: the MoE, SSM and RG-LRU configs served sharded
(``make_serve_steps(cfg, rules)``: the experts over ``model``, the SSM
state's heads and the RG-LRU state's width over ``tp``, the KV caches by
``cache_pspecs``) against the reference's unsharded serving, on the CPU.

The smoke configs of ``olmoe_1b_7b``, ``llama4_maverick``,
``mamba2_780m`` and ``recurrentgemma_2b`` at every mesh of 1, 2 and 4 ranks
(``torch_sharded_blocks_ranks.MESHES``; each world one spawn over a
``file://`` rendezvous, the three at once, the oracles meanwhile in this
process): the reference's weights carried across (each rank its slices),
a 96-token prompt from a numpy seed into caches of 104 slots, each data
rank its rows of the batch, then 4 greedy decode steps.  The reference's
mesh paths fail under jax 0.9.0 (ROADMAP C): its oracle is its unsharded
``make_serve_steps(cfg, None)``.

Tolerances (fp32): the sharded steps do the unsharded steps' operations
with sums split over ranks and added in rank order: every step's logits
within ``MODEL_TOL`` = 1e-4 of the largest logit of the reference's
(``tests/test_torch_lm_sharded_serve.py``'s), the same greedy ids on every
rank; the caches gathered from the ranks within ``CACHE_TOL`` = 1e-5 of
each leaf's largest magnitude of the port's unsharded caches, the lengths
equal; the prefill's ``moe_dropped`` exactly.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import torch_sharded_blocks_ranks as R  # noqa: E402
import torch_sharded_serve_ranks as SVR  # noqa: E402
from torch_sharded_ranks import free_port  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402

MODEL_TOL, CACHE_TOL = 1e-4, 1e-5
CASES = [(arch, mesh) for world, meshes in R.MESHES.items()
         for mesh in meshes for arch in R.ARCHS]
IDS = [f"{a}@{m[0]}x{m[1]}" for a, m in CASES]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


_WEIGHTS = {}


def _weights(arch):
    """The reference's smoke weights from PRNGKey(0), as numpy."""
    if arch not in _WEIGHTS:
        cfg = ref_configs.get_config(R.ARCHS[arch], "smoke")
        _WEIGHTS[arch] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            ref_model.init_model(jax.random.PRNGKey(0), cfg))
    return _WEIGHTS[arch]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    weights = {arch: _weights(arch) for arch in R.ARCHS}
    started = R.start_worlds("serve", weights,
                             str(tmp_path_factory.mktemp("blocks_serve")))
    jobs = [(arch, R.PROMPT, R.GEN) for arch in R.ARCHS] + \
        [("olmoe", R.TRAP_PROMPT, 1)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(_oracles, *job) for job in jobs]:
            fut.result()
    return R.join_worlds(started)


_ORACLES = {}


def _oracles(arch, prompt, steps):
    """(the reference's logits (B, steps + 1, V) and ids, the port's
    unsharded run: logits, ids, caches, the prefill's aux)."""
    key = (arch, prompt)
    if key not in _ORACLES:
        rc = dataclasses.replace(ref_configs.get_config(R.ARCHS[arch],
                                                        "smoke"),
                                 attn_impl="chunked")
        params = jax.tree_util.tree_map(jnp.asarray, _weights(arch))
        pre, dec = ref_trainer.make_serve_steps(rc, None)
        pre, dec = jax.jit(pre), jax.jit(dec)
        slots = R.SLOTS if prompt == R.PROMPT else prompt + 8
        caches = ref_model.init_caches(rc, R.SV_BATCH, slots)
        cfg = R.port_cfg(arch)
        inputs = R.prompts(cfg, R.SV_BATCH, prompt)
        logits, caches = pre(params, jnp.asarray(inputs), caches)
        outs, ids = [logits], []
        for t in range(steps):
            tok = jnp.argmax(logits[:, :rc.vocab], -1)[:, None]
            ids.append(np.asarray(tok))
            logits, caches = dec(params, tok, jnp.int32(prompt + t), caches)
            outs.append(logits)
        ref = (np.stack([np.asarray(o, np.float32) for o in outs], 1),
               np.concatenate(ids, 1))
        port = R.serve(cfg, interop.lm_params(_weights(arch), cfg,
                                              device="cpu"),
                       inputs, R.SV_BATCH, prompt, slots, steps)
        _ORACLES[key] = (ref, port)
    return _ORACLES[key]


def _check(got, ref, port):
    r_logits, r_ids = ref
    p_logits, p_ids, p_caches, p_aux = port
    scale = float(np.abs(r_logits).max())
    np.testing.assert_allclose(got["logits"].numpy(), r_logits, rtol=0,
                               atol=MODEL_TOL * scale)
    np.testing.assert_array_equal(got["ids"].numpy(), r_ids)
    for rank, (lo, hi), ids in got["every_ids"]:
        np.testing.assert_array_equal(ids.numpy(), r_ids[lo:hi],
                                      err_msg=f"rank {rank}")
    for (path, a), (_, b) in zip(t_sharding.named_leaves(got["caches"]),
                                 t_sharding.named_leaves(tuple(p_caches))):
        if path[-1] == "length":
            assert torch.equal(a, b), path
        else:
            bound = CACHE_TOL * max(float(b.abs().max()), 1.0)
            assert float((a.float() - b.float()).abs().max()) <= bound, path
    assert got["aux"]["moe_dropped"] == p_aux["moe_dropped"]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_sharded_serving_tracks_the_reference(ranks, arch, mesh):
    got = ranks[("serve", arch, mesh)]
    _check(got, *_oracles(arch, R.PROMPT, R.GEN))
    # the ranks held shards: the SSM's and RG-LRU's states over model
    # (their heads, their width), the KV caches by cache_pspecs
    whole = [tuple(t.shape) for _, t in t_sharding.named_leaves(
        tuple(_oracles(arch, R.PROMPT, R.GEN)[1][2]))]
    assert len(got["local_shapes"]) == len(whole)
    if mesh[1] > 1 or (mesh[0] > 1 and R.SV_BATCH % mesh[0] == 0):
        # (a batch of 2 stays whole over data = 4)
        assert any(s != w for s, w in zip(got["local_shapes"], whole))
    if mesh[1] > 1 and arch in ("mamba2", "recurrentgemma"):
        h = [(s, w) for (p, _), s, w in zip(
            t_sharding.named_leaves(got["caches"]), got["local_shapes"],
            whole) if p[-1] == "h"]
        assert h and all(s[2] == w[2] // mesh[1] for s, w in h), h


def test_prefill_capacity_decided_on_the_global_length(ranks):
    """olmoe at (1, 2), a 160-token prompt: 320 (token, choice) pairs over
    the whole row pass the dropless limit of 256, while each sequence
    shard's 80 tokens make 160 pairs under it.  The prefill must take the
    capacity of the global length, as the unsharded prefill does: it
    drops pairs (``moe_dropped`` > 0, equal to the unsharded prefill's)
    and its logits are the reference's."""
    k = R.port_cfg("olmoe").moe.top_k
    sp = R.TRAP_MESH[1]
    assert R.TRAP_PROMPT // sp * k <= 256 < R.TRAP_PROMPT * k
    ref, port = _oracles("olmoe", R.TRAP_PROMPT, 1)
    assert port[3]["moe_dropped"] > 0
    got = ranks[("trap", "olmoe", R.TRAP_MESH)]
    _check(got, ref, port)


@pytest.mark.parametrize("arch", list(R.ARCHS))
def test_serve_lm_under_torchrun_on_two_ranks(tmp_path, arch):
    """``launch.serve``'s ``main`` in a torchrun-like environment, two CPU
    ranks on the local mesh (data = 2: the MoE's aux and capacity over the
    global batch, the recurrent states a rank's rows): the generated ids
    equal one process's ``serve_lm``."""
    argv = ["--arch", R.ARCHS[arch], "--variant", "smoke", "--batch", "4",
            "--prompt-len", "32", "--gen", "4", "--device", "cpu",
            "--seed", "4"]
    mp.spawn(SVR.serve_rank, args=(2, free_port(), argv, str(tmp_path)),
             nprocs=2, join=True)
    got = torch.load(tmp_path / "serve.pt", weights_only=False)
    want = t_serve.serve_lm(t_serve.parser().parse_args(argv))
    np.testing.assert_array_equal(got["generated"], want["generated"])
