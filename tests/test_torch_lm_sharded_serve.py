"""Port parity: sharded LM serving (``make_serve_steps(cfg, rules)``:
prefill and greedy decode over FSDP x TP slices of the weights and caches
sharded on heads, ``kv_seq`` and ``long_seq``) against the reference's
unsharded ``make_serve_steps(cfg, None)`` on the CPU.

The 2- and 4-rank worlds are ``torch.multiprocessing`` spawns over a
``file://`` rendezvous (``torch_sharded_serve_ranks``, a module without
JAX) that run at once, the unsharded runs of both packages meanwhile in
this process.  Each case carries the reference's weights across
(``interop.lm_params(..., rules=)``: each rank its slices), prefills a
96-token prompt from a numpy seed (each data rank its rows of the batch;
a batch that does not divide stays whole) into caches of 104 slots
(``init_caches(rules=, long=)``: 104 divides over every mesh, so the slots
are sliced), then takes 4 greedy decode steps.  The reference's mesh
paths fail under jax 0.9.0 (ROADMAP C), so the oracle is unsharded.

Tolerances.  fp32 throughout: the sharded steps do the unsharded steps'
operations with sums split over ranks (the row-parallel projections'
partial sums, the tied table's logits over D / tp columns, a sliced
cache's softmax sums over its ranks) and added in rank order, a few
1e-7 relative; against the reference the operations differ as in
``tests/test_torch_lm.py`` (its ``MODEL_TOL``): every step's logits within
``MODEL_TOL`` = 1e-4 of the largest logit, the same greedy ids on every
rank.  The caches gathered from the ranks against the port's unsharded
caches: k / v within ``CACHE_TOL`` = 1e-5 (the projections at other GEMM
shapes; values O(1)), the lengths equal.  A (1, 1) mesh gives the
unsharded steps' bits.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import torch_sharded_serve_ranks as R  # noqa: E402
from torch_sharded_ranks import free_port  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402

MODEL_TOL, CACHE_TOL = 1e-4, 1e-5
ARCHS = sorted({arch for arch, _, _ in R.CONFIGS.values()})
UNSHARDED = [(name, impl) for name in R.CONFIGS for impl in R.IMPLS]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: PyTorch's default count spins badly when
    several test processes (and XLA's threads) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


_REF_PARAMS = {}


def _ref_params(arch):
    """The reference's smoke weights from PRNGKey(0), as numpy."""
    if arch not in _REF_PARAMS:
        p = ref_model.init_model(jax.random.PRNGKey(0),
                                 ref_configs.get_config(arch, "smoke"))
        _REF_PARAMS[arch] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), p)
    return _REF_PARAMS[arch]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's rank-0 results; the two worlds run at once, the
    unsharded runs of both packages meanwhile here."""
    params = {arch: _ref_params(arch) for arch in ARCHS}
    started = R.start_worlds(params, str(tmp_path_factory.mktemp("serve")))
    # the reference's compiles release the interpreter lock: overlap them
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(_oracles, *case) for case in UNSHARDED]:
            fut.result()
    return R.join_worlds(started)


# ---------------------------------------------------------------------------
# the unsharded oracles
# ---------------------------------------------------------------------------

_ORACLES = {}


def _reference(name, impl):
    """The reference's ``make_serve_steps(cfg, None)``, jitted: every
    step's logits (B, STEPS + 1, V) and the greedy ids (B, STEPS)."""
    arch, _, batch = R.CONFIGS[name]
    rc = dataclasses.replace(ref_configs.get_config(arch, "smoke"),
                             attn_impl=impl)
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params(arch))
    pre, dec = ref_trainer.make_serve_steps(rc, None)
    pre, dec = jax.jit(pre), jax.jit(dec)
    caches = ref_model.init_caches(rc, batch, R.MAX_LEN)
    inputs = R.prompts(R.port_cfg(name, impl), batch)
    logits, caches = pre(params, jnp.asarray(inputs), caches)
    outs, ids = [logits], []
    for t in range(R.STEPS):
        tok = jnp.argmax(logits[:, :rc.vocab], -1)[:, None]
        ids.append(np.asarray(tok))
        step_in = tok if rc.input_mode != "embeddings" else jnp.take(
            params["embed"]["tokens"], tok, axis=0).astype(rc.compute_dtype)
        logits, caches = dec(params, step_in, jnp.int32(R.PROMPT + t),
                             caches)
        outs.append(logits)
    return (np.stack([np.asarray(o, np.float32) for o in outs], 1),
            np.concatenate(ids, 1))


def _oracles(name, impl):
    """(the reference's run, the port's unsharded run) of a case."""
    key = (name, impl)
    if key not in _ORACLES:
        arch, long, batch = R.CONFIGS[name]
        cfg = R.port_cfg(name, impl)
        port = R.serve(cfg, interop.lm_params(_ref_params(arch), cfg,
                                              device="cpu"),
                       R.prompts(cfg, batch), batch, long)
        _ORACLES[key] = (_reference(name, impl), port)
    return _ORACLES[key]


# ---------------------------------------------------------------------------
# the sharded cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,impl,mesh", R.CASES,
                         ids=[f"{n}-{i}@{m[0]}x{m[1]}" for n, i, m in R.CASES])
def test_sharded_serving_tracks_the_reference(ranks, name, impl, mesh):
    got = ranks[(name, impl, mesh)]
    # (starcoder2_smoke's 6 heads over model = 4 take the sequence-sharded
    # route for heads that do not divide, ROADMAP A12.6)
    (r_logits, r_ids), (p_logits, p_ids, p_caches) = _oracles(name, impl)
    logits = got["logits"].numpy()
    scale = float(np.abs(r_logits).max())
    np.testing.assert_allclose(logits, r_logits, rtol=0,
                               atol=MODEL_TOL * scale)
    np.testing.assert_array_equal(got["ids"].numpy(), r_ids)
    for rank, (lo, hi), ids in got["every_ids"]:
        np.testing.assert_array_equal(ids.numpy(), r_ids[lo:hi],
                                      err_msg=f"rank {rank}")
    # the caches gathered from the ranks: the port's unsharded caches
    for (path, a), (_, b) in zip(t_sharding.named_leaves(got["caches"]),
                                 t_sharding.named_leaves(tuple(p_caches))):
        if path[-1] == "length":
            assert torch.equal(a, b), path
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=CACHE_TOL, err_msg=str(path))
    # the ranks held shards: every cache leaf but the lengths is cut where
    # its spec divides (the slots over kv_seq / long_seq, or the heads)
    n_leaves = len(got["local_shapes"])
    whole = [tuple(t.shape) for _, t in
             t_sharding.named_leaves(tuple(p_caches))]
    if mesh != (1, 1) and (mesh[1] > 1 or R.CONFIGS[name][1]):
        assert any(s != w for s, w in zip(got["local_shapes"], whole)), \
            (got["local_shapes"], whole)
    assert n_leaves == len(whole)


@pytest.mark.parametrize("mesh", R.MESHES[2] + R.MESHES[4],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_cache_shards_are_the_specs_bounds(ranks, arch, mesh):
    """``init_caches(rules=, long=, device="meta")`` allocates exactly each
    rank's ``shard_bounds`` of ``cache_pspecs`` at the reference's three
    serving cells (prefill_32k, decode_32k, long_500k), on every rank."""
    got = ranks[("shapes", mesh)]
    for cell in R.CELLS:
        assert got[(arch, cell)], (arch, cell)


def test_refusals_name_their_items(ranks):
    """The MoE, SSM and RG-LRU blocks serve sharded now (ROADMAP A12.8);
    sequence axes other than the tp axes still refuse, naming them.
    (Heads that do not divide, A12.6, serve: starcoder2's cases above.)"""
    got = ranks["refusals"]
    for name in ("moe", "ssm", "rglru"):
        assert got[name] == "ran", got[name]
    assert "tp axes" in got["sp_axes"], got["sp_axes"]


# ---------------------------------------------------------------------------
# one rank: the unsharded bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,impl", UNSHARDED,
                         ids=[f"{n}-{i}" for n, i in UNSHARDED])
def test_one_rank_mesh_gives_the_unsharded_bits(name, impl):
    """``make_serve_steps(cfg, rules)`` over a (1, 1) mesh (no process
    group) gives ``make_serve_steps(cfg)``'s bits: logits, ids and
    caches; and those are the reference's within ``MODEL_TOL``."""
    arch, long, batch = R.CONFIGS[name]
    cfg = R.port_cfg(name, impl)
    rules = t_sharding.make_rules(t_mesh.make_mesh(1, 1))
    params = interop.lm_params(_ref_params(arch), cfg, device="cpu")
    want = R.serve(cfg, params, R.prompts(cfg, batch), batch, long)
    got = R.serve(cfg, interop.lm_params(_ref_params(arch), cfg,
                                         device="cpu", rules=rules),
                  R.prompts(cfg, batch), batch, long, rules)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        t_sharding.named_leaves(tuple(got[2])),
        t_sharding.named_leaves(tuple(want[2]))))
    r_logits, r_ids = _oracles(name, impl)[0]
    np.testing.assert_allclose(want[0].numpy(), r_logits, rtol=0,
                               atol=MODEL_TOL * float(np.abs(r_logits).max()))
    np.testing.assert_array_equal(want[1].numpy(), r_ids)


# ---------------------------------------------------------------------------
# launch.serve under torchrun
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,batch", [("gemma3_12b", 4),
                                        ("musicgen_large", 3)])
def test_serve_lm_under_torchrun_on_two_ranks(tmp_path, arch, batch):
    """``launch.serve``'s ``main`` in a torchrun-like environment, two CPU
    ranks on the local mesh (data = 2): each rank serves its rows (a
    batch of 3 stays whole) from its slices of the seed's weights; the
    generated ids equal one process's ``serve_lm``."""
    argv = ["--arch", arch, "--variant", "smoke", "--batch", str(batch),
            "--prompt-len", "32", "--gen", "5", "--device", "cpu",
            "--seed", "4"]
    mp.spawn(R.serve_rank, args=(2, free_port(), argv, str(tmp_path)),
             nprocs=2, join=True)
    got = torch.load(tmp_path / "serve.pt", weights_only=False)
    want = t_serve.serve_lm(t_serve.parser().parse_args(argv))
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["generated"].shape == (batch, 5)
