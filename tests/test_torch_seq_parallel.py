"""Port parity: the sequence-parallel LM forward over ``torch.distributed``
(mesh, axis rules, sequence-sharded residual stream), against the JAX
package's unsharded ``forward``.

A gemma3-shaped smoke model (2 layers, one local with window 32 and one
global, the smoke widths) runs in 4 gloo ranks (subprocesses, one group,
a ``file://`` rendezvous) on CPU tensors: as ``model`` = 4 with the ring
schedule (``attn_ring_min_sk`` = 128) and with the all-gather one, and as
``data`` x ``model`` = 2 x 2.  Each rank feeds its shard of the tokens
(``sharding.local_shard``); the hidden states, put back together
(``sharding.gather_shards``), and each rank's last-position logits are
held against the reference's forward on the whole batch and sequence,
with the reference's weights carried across by ``interop.lm_params``.
The reference's flash route runs its Pallas kernel in interpret mode.

Tolerances.  fp32 on both sides; the sums run in other orders (the ring
folds K/V shard by shard, the reference walks 64-key tiles) and the
elementwise functions differ by an ulp, a few 1e-7 of the values per
layer (tests/test_torch_lm.py's ``LAYER_TOL = 1e-5``).  Through two
layers and the final norm the hidden states stay within ``TOL = 1e-4`` of
``max |hidden|`` and the 512-way logits within ``1e-4`` of
``max |logit|`` (test_torch_lm.py's ``MODEL_TOL``).
"""
import dataclasses
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402
from repro_torch.models.layers import lm_logits  # noqa: E402

TOL = 1e-4
WORLD = 4
SEQ = 256
# name: (data, model, batch, attn_ring_min_sk)
RUNS = {"ring_1x4": (1, 4, 2, 128), "allgather_1x4": (1, 4, 2, 0),
        "ring_2x2": (2, 2, 2, 128),
        # 3 rows do not divide data = 2: the batch stays whole on each rank
        "ring_2x2_b3": (2, 2, 3, 128)}
OVER = dict(n_layers=2, block_pattern=("local", "attn"), attn_impl="flash")


def _cfgs(ring_min_sk):
    over = dict(OVER, attn_ring_min_sk=ring_min_sk)
    return (dataclasses.replace(ref_configs.get_config("gemma3_12b",
                                                       "smoke"), **over),
            dataclasses.replace(t_configs.get_config("gemma3_12b", "smoke"),
                                **over))


def _tokens(batch):
    cfg, _ = _cfgs(0)
    return np.random.default_rng(batch).integers(0, cfg.vocab, (batch, SEQ))


@functools.lru_cache(maxsize=None)
def _ref_params():
    ref_cfg, _ = _cfgs(0)
    params = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)


@functools.lru_cache(maxsize=None)
def _ref_forward(batch, ring_min_sk):
    """The reference's unsharded hidden states and logits, as numpy."""
    ref_cfg, _ = _cfgs(ring_min_sk)
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params())
    fwd = jax.jit(functools.partial(ref_model.forward, cfg=ref_cfg))
    hidden, _, _ = fwd(params, jnp.asarray(_tokens(batch), jnp.int32))
    logits = ref_layers.lm_logits(params["embed"], hidden, ref_cfg)
    return np.asarray(hidden), np.asarray(logits)


def _counting(calls, key, fn):
    return lambda *a, **kw: calls.__setitem__(key, calls[key] + 1) or \
        fn(*a, **kw)


def _forward_run(params, data, model, batch, ring_min_sk, res, name):
    _, cfg = _cfgs(ring_min_sk)
    mesh = t_mesh.make_mesh(data, model)
    rules = t_sharding.make_rules(mesh)
    tokens = torch.from_numpy(_tokens(batch))
    local = t_sharding.local_shard(tokens, rules, "batch", "sp")
    calls = {"step": 0, "fwd": 0}
    table = registry.IMPLS
    table["flash_attention_step"]["reference"] = _counting(
        calls, "step", fa.flash_attention_step_plain)
    table["flash_attention"]["reference"] = _counting(
        calls, "fwd", fa.flash_attention_fwd_plain)
    with t_sharding.use_rules(rules):
        hidden, _, _ = t_model.forward(params, local, cfg)
    res[f"{name}_calls"] = np.array([calls["step"], calls["fwd"]])
    res[f"{name}_local_shape"] = np.array(local.shape)
    res[f"{name}_hidden"] = t_sharding.gather_shards(
        hidden, rules, (batch, SEQ, cfg.d_model), "batch", "sp").numpy()
    res[f"{name}_last_logits"] = lm_logits(params["embed"],
                                           hidden[:, -1:], cfg)[:, 0].numpy()
    res[f"{name}_coords"] = np.array([mesh.coords["data"],
                                      mesh.coords["model"]])
    if name == "ring_1x4":
        # the same shard with local positions 0 .. S/N - 1: RoPE and the
        # window then see the wrong coordinates
        with t_sharding.use_rules(rules):
            wrong, _, _ = t_model.forward(
                params, local, cfg,
                positions=torch.arange(local.shape[1])[None])
        res["local_positions_hidden"] = wrong.numpy()


def _mesh_facts(res, rank):
    """The mesh's layout and groups, on a 2 x 2 mesh and the others."""
    mesh = t_mesh.make_mesh(2, 2)
    res["coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
    res["index"] = np.array([mesh.axis_index("data"),
                             mesh.axis_index("model"),
                             mesh.axis_index(("data", "model")),
                             mesh.axis_index(("model", "data"))])
    res["ranks_data"] = np.array(mesh.ranks("data"))
    res["ranks_model"] = np.array(mesh.ranks("model"))
    res["sizes"] = np.array([t_mesh.data_axis_size(mesh),
                             t_mesh.axis_size(mesh, "model"),
                             t_mesh.axis_size(mesh, ("data", "model")),
                             t_mesh.axis_size(mesh, None)])
    res["backend_gloo"] = np.array(
        dist.get_backend(mesh.group("model")) == "gloo")
    local = t_mesh.make_local_mesh()
    res["local_shape"] = np.array([local.shape["data"],
                                   local.shape["model"]])
    try:
        t_mesh.make_data_mesh(2)
        res["data_mesh_2"] = np.array(1)
    except ValueError:
        res["data_mesh_2"] = np.array(0)
    try:
        t_mesh.make_data_mesh(5)
        res["data_mesh_5"] = np.array(1)
    except ValueError:
        res["data_mesh_5"] = np.array(0)


def _ragged_facts(res):
    """A 250-token sequence over model = 4: cutting it to shards and
    putting shards back together both raise; 3 batch rows over data = 2
    stay whole beside a sequence that divides."""
    rules = t_sharding.make_rules(t_mesh.make_mesh(1, WORLD))
    tokens = torch.zeros((2, 250), dtype=torch.long)
    raised = []
    for fn in (lambda: t_sharding.local_shard(tokens, rules, "batch", "sp"),
               lambda: t_sharding.gather_shards(tokens[:, :62], rules,
                                                (2, 250), "batch", "sp")):
        try:
            fn()
            raised.append(0)
        except ValueError as e:
            raised.append(int("does not divide" in str(e)))
    res["ragged_raises"] = np.array(raised)
    rules = t_sharding.make_rules(t_mesh.make_mesh(2, 2))
    res["batch_kept_shape"] = np.array(t_sharding.local_shard(
        torch.zeros((3, 8)), rules, "batch", "sp").shape)


def _rank_main(rank, world, init, outdir, ref_params):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        res = {}
        _mesh_facts(res, rank)
        _ragged_facts(res)
        _, cfg = _cfgs(0)
        params = interop.lm_params(ref_params, cfg, device="cpu")
        for name, (data, model, batch, thr) in RUNS.items():
            _forward_run(params, data, model, batch, thr, res, name)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results from one gloo group of 4."""
    d = tmp_path_factory.mktemp("seq_parallel")
    mp.spawn(_rank_main, args=(WORLD, f"file://{d}/rendezvous", str(d),
                               _ref_params()), nprocs=WORLD, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# axis rules, in one process
# ---------------------------------------------------------------------------

LOGICAL = [("batch", "sp", None), ("batch", None, "tp", None),
           (("batch", "sp"),), ("long_seq",), ("vocab", "fsdp"),
           ("kv_seq", "experts"), ("unknown",), (None,)]


@pytest.mark.parametrize("overrides", [None, {"sp": None},
                                       {"batch": ("pod", "data", "model")}])
def test_rules_resolve_like_the_reference(overrides):
    """make_rules on a one-rank mesh resolves every logical spec as the
    reference's make_rules does on a one-device mesh."""
    ref = ref_sharding.make_rules(
        jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1]),
        overrides)
    port = t_sharding.make_rules(t_mesh.make_mesh(1, 1), overrides)
    assert port.rules == ref.rules
    assert t_sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    for logical in LOGICAL:
        assert port.resolve(*logical) == tuple(ref.resolve(*logical))


def test_use_rules_nests_and_restores():
    rules = t_sharding.make_rules(t_mesh.make_mesh(1, 1))
    assert t_sharding.current_rules() is None
    assert t_sharding.seq_shards() == ((), 1)
    with t_sharding.use_rules(rules):
        assert t_sharding.current_rules() is rules
        assert t_sharding.seq_shards() == (("model",), 1)
        with t_sharding.use_rules(None):
            assert t_sharding.current_rules() is None
        assert t_sharding.current_rules() is rules
    assert t_sharding.current_rules() is None


def test_one_rank_mesh_runs_the_one_device_route():
    """Under rules on a one-rank mesh the forward is the unsharded one
    (the sequence axes span one rank)."""
    _, cfg = _cfgs(128)
    params = interop.lm_params(_ref_params(), cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(2))
    with t_sharding.use_rules(t_sharding.make_rules(t_mesh.make_mesh(1, 1))):
        hidden, _, _ = t_model.forward(params, tokens, cfg)
    want, _ = _ref_forward(2, 128)
    np.testing.assert_allclose(hidden.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs as many processes"):
        t_mesh.make_mesh(2, 2)
    with pytest.raises(ValueError, match="only 1 exist"):
        t_mesh.make_data_mesh(2)
    with pytest.raises(ValueError, match="no 'data' axis"):
        t_mesh.data_axis_size(t_mesh.Mesh({"model": 1}))


# ---------------------------------------------------------------------------
# the mesh and the forward in 4 gloo ranks
# ---------------------------------------------------------------------------

def test_mesh_layout_is_row_major(ranks):
    """Rank d * 2 + m sits at (data d, model m), as jax.make_mesh lays out
    devices; each axis's group holds the ranks along it, in order."""
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 2)
        np.testing.assert_array_equal(r["coords"], [d, m])
        np.testing.assert_array_equal(r["index"], [d, m, rank, rank])
        np.testing.assert_array_equal(r["ranks_model"], [2 * d, 2 * d + 1])
        np.testing.assert_array_equal(r["ranks_data"], [m, m + 2])
        np.testing.assert_array_equal(r["sizes"], [2, 2, 4, 1])
        assert bool(r["backend_gloo"])
        np.testing.assert_array_equal(r["local_shape"], [WORLD, 1])
        assert int(r["data_mesh_2"]) == (rank < 2)
        assert int(r["data_mesh_5"]) == 0


def test_sequence_that_does_not_divide_raises(ranks):
    """The reference runs a sequence that does not divide replicated; a
    rank here would take it for its shard at global positions
    index * S, so ``local_shard`` and ``gather_shards`` refuse it.  A
    batch that does not divide stays whole, as in the reference."""
    for r in ranks:
        np.testing.assert_array_equal(r["ragged_raises"], [1, 1])
        np.testing.assert_array_equal(r["batch_kept_shape"], [3, 4])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_forward_matches_reference(ranks, name):
    """The gathered hidden states on every rank, and each rank's
    last-position logits, against the reference's unsharded forward."""
    data, model, batch, thr = RUNS[name]
    want, want_logits = _ref_forward(batch, thr)
    scale = np.abs(want).max()
    split_batch = batch % data == 0
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}_hidden"], want, rtol=0,
                                   atol=TOL * scale)
        d, m = r[f"{name}_coords"]
        rows = slice(d * batch // data, (d + 1) * batch // data) \
            if split_batch else slice(None)
        np.testing.assert_array_equal(
            r[f"{name}_local_shape"],
            [batch // data if split_batch else batch, SEQ // model])
        last = (m + 1) * SEQ // model - 1
        logits = want_logits[rows, last]
        np.testing.assert_allclose(r[f"{name}_last_logits"], logits, rtol=0,
                                   atol=TOL * np.abs(want_logits).max())


@pytest.mark.parametrize("name", sorted(RUNS))
def test_forward_routes_every_layer(ranks, name):
    """Ring: each of the 2 layers takes one step per rank of the model
    axis and no one-shot kernel; all-gather: one one-shot call a layer."""
    data, model, batch, thr = RUNS[name]
    want = (2 * model, 0) if thr else (0, 2)
    for r in ranks:
        assert tuple(r[f"{name}_calls"]) == want


def test_global_positions_reach_rope_and_window(ranks):
    """The default positions are global: with local positions 0 .. 63 the
    shards past the first move far outside the tolerance (RoPE and the
    local layer's window see other coordinates), the first not at all."""
    want, _ = _ref_forward(2, 128)
    scale = np.abs(want).max()
    for m, r in enumerate(ranks):
        rows = want[:, m * 64:(m + 1) * 64]
        err = np.abs(r["local_positions_hidden"] - rows).max()
        if m == 0:
            assert err <= TOL * scale
        else:
            assert err > 100 * TOL * scale
