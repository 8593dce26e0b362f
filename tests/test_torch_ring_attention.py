"""Port parity: the block-resumable flash step (TPU kernel table row 9) and
the sequence-parallel attention schedules, against the JAX package.

Row 9's plain version (the CPU path; ``chip_smoke.py`` holds the CUDA
kernel against it on the card) is chained over k shards and compared,
carry and all, with the reference's ``flash_attention_step`` in interpret
mode.  The ring and all-gather schedules run in 2 and 4 gloo ranks
(subprocesses, one group per world size, a ``file://`` rendezvous) on
CPU tensors, each rank with its sequence shard; their outputs, put back
together, are held against the reference's unsharded kernel and its naive
oracle.  Inputs are made with numpy from seeds and handed to both sides.

Tolerances.  Both sides compute scores, the online softmax and p . v in
fp32; only the order of the sums differs (the reference walks 32-key
tiles, the port takes a shard at once).  With N(0, 1) inputs and D <= 16
the outputs are O(1) and their sums differ by a few 1e-7: outputs and the
running max m within ``TOL = 1e-5`` (absolute and relative).  l and acc
are sums of up to 128 terms of size <= 1 (and |v|), so they carry
reorderings of 128 terms: ``SUM_TOL = 1e-5`` relative, ``1e-4`` absolute.
Where a row has seen no visible key yet, the reference keeps tile-
dependent values in l and acc that its next visible key multiplies by
exp(-1e30 - m) = 0, while the port keeps them at 0; there the test
requires m = -1e30 on both sides and compares l and acc only on the
other rows.
"""
import dataclasses
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    RING_MIN_SK as REF_RING_MIN_SK, _ring_fwd_impl,
    flash_attention_fwd as ref_fwd, flash_attention_step as ref_step,
    use_ring as ref_use_ring)
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.sharding import make_rules, use_rules  # noqa: E402

TOL = 1e-5
SUM_TOL, SUM_ATOL = 1e-5, 1e-4
NEG_INF = -1e30
BLOCK = 32


def _qkv(seed, b, sq, sk, h, g, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, g, d)).astype(np.float32),
            rng.standard_normal((b, sk, g, d)).astype(np.float32))


def _naive(q, k, v, window):
    """The reference's naive oracle on numpy inputs, as numpy."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    q5 = jnp.asarray(q).reshape(b, sq, g, h // g, d)
    return np.asarray(ref_attn._naive_grouped(
        q5, jnp.asarray(k), jnp.asarray(v), window=window)).reshape(
            b, sq, h, d)


def _close(got, want, tol=TOL, atol=None):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol if atol is None else atol)


def _check_carry(got, want):
    """m everywhere (-1e30 on the same rows); l and acc where a key was
    seen."""
    gm, gl, gacc = (t.float().numpy() for t in got)
    wm, wl, wacc = (np.asarray(t, np.float32) for t in want)
    unseen = wm <= NEG_INF / 2
    np.testing.assert_array_equal(gm <= NEG_INF / 2, unseen)
    np.testing.assert_array_equal(gm[unseen], wm[unseen])
    seen = ~unseen
    _close(gm[seen], wm[seen])
    _close(gl[seen], wl[seen], SUM_TOL, SUM_ATOL)
    seen_acc = np.broadcast_to(seen, wacc.shape)
    _close(gacc[seen_acc], wacc[seen_acc], SUM_TOL, SUM_ATOL)
    # the port leaves a row that saw no key at its fresh state
    assert (gl[unseen] == 0).all()
    assert (gacc[np.broadcast_to(unseen, gacc.shape)] == 0).all()


# ---------------------------------------------------------------------------
# row 9: the step, chained over k shards, against the reference's
# ---------------------------------------------------------------------------

# (sq, sk, q_base, shard lengths, window, h, g, d, dtype)
STEP_CASES = {
    "even": (128, 128, 0, (32, 32, 32, 32), 0, 4, 2, 16, "float32"),
    "even_window": (128, 128, 0, (32, 32, 32, 32), 48, 4, 2, 16, "float32"),
    # ragged shards that do not divide the 32-key tile: pad rows must not
    # alias the next shard's positions (test_pad_rows_never_alias_next_shard)
    "ragged": (64, 64, 0, (48, 16), 0, 2, 2, 16, "float32"),
    "ragged_window": (96, 96, 0, (40, 24, 32), 20, 6, 3, 16, "float32"),
    # q rows at a global offset against longer k
    "q_base": (64, 192, 128, (64, 64, 64), 0, 4, 1, 16, "float32"),
    "q_base_window": (64, 192, 128, (50, 78, 64), 40, 4, 4, 8, "float32"),
    # bf16 inputs, fp32 carry: both sides widen the same bf16 values
    "bf16": (64, 128, 64, (64, 64), 32, 4, 2, 16, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_chain_matches_reference_carry(case):
    """Each step's carry against the reference step's, then the finalized
    output against the reference's one-shot kernel."""
    sq, sk, q_base, shards, window, h, g, d, dtype = STEP_CASES[case]
    assert sum(shards) == sk
    q, k, v = _qkv(sq + sk + window, 1, sq, sk, h, g, d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    want = got = None
    lo = 0
    for n in shards:
        want = ref_step(jq, jk[:, lo:lo + n], jv[:, lo:lo + n], want,
                        q_base=jnp.int32(q_base), k_base=jnp.int32(lo),
                        window=window, blk_q=BLOCK, blk_k=BLOCK,
                        interpret=True)
        got = fa.flash_attention_step(tq, tk[:, lo:lo + n], tv[:, lo:lo + n],
                                      got, q_base=q_base, k_base=lo,
                                      window=window)
        assert all(t.dtype == torch.float32 for t in got)
        _check_carry(got, want)
        lo += n
    out, lse = fa.finalize(got, tdt)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    one_shot = ref_fwd(jq, jk, jv, window=window, blk_q=BLOCK, blk_k=BLOCK,
                       interpret=True, q_base=jnp.int32(q_base))
    if dtype == "float32":
        _close(out.numpy(), np.asarray(one_shot))
    else:   # one bf16 ulp of the same fp32 result
        np.testing.assert_allclose(out.float().numpy(), np.asarray(
            one_shot.astype(jnp.float32)), rtol=2.0 ** -7, atol=TOL)
    assert lse.shape == (1, sq, h)


@pytest.mark.parametrize("window", [0, 16])
def test_fully_masked_shard_leaves_carry_unchanged(window):
    """A shard wholly after every q row (causal) or wholly before the
    window: the step still runs and hands the carry back exactly, as the
    reference's tile skip does."""
    q, k, v = _qkv(3, 2, 32, 96, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    carry = fa.flash_attention_step(tq, tk[:, 32:64], tv[:, 32:64], None,
                                    q_base=32, k_base=32, window=window)
    ref_carry = ref_step(jq, jk[:, 32:64], jv[:, 32:64], None,
                         q_base=jnp.int32(32), k_base=jnp.int32(32),
                         window=window, blk_q=BLOCK, blk_k=BLOCK,
                         interpret=True)
    # causal: keys 64..95 lie after rows 32..63; with the window, keys
    # 0..15 lie before the window of every row
    future = (tk[:, 64:], tv[:, 64:], 64, jk[:, 64:], jv[:, 64:])
    past = (tk[:, :16], tv[:, :16], 0, jk[:, :16], jv[:, :16])
    for tks, tvs, base, jks, jvs in (future, past) if window else (future,):
        again = fa.flash_attention_step(tq, tks, tvs, carry, q_base=32,
                                        k_base=base, window=window)
        assert all(torch.equal(a, b) for a, b in zip(again, carry))
        ref_again = ref_step(jq, jks, jvs, ref_carry, q_base=jnp.int32(32),
                             k_base=jnp.int32(base), window=window,
                             blk_q=BLOCK, blk_k=BLOCK, interpret=True)
        for a, b in zip(ref_again, ref_carry):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # from a fresh carry, a fully masked shard leaves the fresh state
    fresh = fa.flash_attention_step(tq, tk[:, 64:], tv[:, 64:], None,
                                    q_base=32, k_base=64, window=window)
    assert all(torch.equal(a, b) for a, b in zip(
        fresh, fa.init_carry(2, 32, 4, 16, "cpu")))


def test_finalize_lse_matches_reference_ring():
    """(out, lse) of a chained carry against the reference ring body's on
    a one-device mesh (one step, the whole K/V)."""
    q, k, v = _qkv(11, 2, 64, 64, 4, 2, 16)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])
    want_out, want_lse = _ring_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 24, BLOCK, True,
        mesh, ("model",), ())
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    carry = None
    for lo, n in ((0, 40), (40, 24)):
        carry = fa.flash_attention_step(tq, tk[:, lo:lo + n],
                                        tv[:, lo:lo + n], carry, q_base=0,
                                        k_base=lo, window=24)
    out, lse = fa.finalize(carry, torch.float32)
    _close(out.numpy(), np.asarray(want_out))
    _close(lse.numpy(), np.asarray(want_lse))


def test_step_op_and_launcher_contract():
    """The op resolves to the plain version on CPU tensors; the CUDA
    launcher refuses CPU tensors and a carry of the wrong shape raises."""
    assert registry.resolve("flash_attention_step", torch.device("cpu")) \
        is fa.flash_attention_step_plain
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_step_cuda(q, k, v, None, q_base=0, k_base=0)
    bad = fa.init_carry(1, 8, 2, 4, "cpu")
    with pytest.raises(ValueError, match="carry acc"):
        ops.flash_attention_step(q, k, v, bad, q_base=0, k_base=0)
    fa.reset_launches()
    m, l, acc = ops.flash_attention_step(q, k, v, None, q_base=0, k_base=0)
    assert (m.shape, l.shape, acc.shape) == ((1, 8, 2, 1), (1, 8, 2, 1),
                                            (1, 8, 2, 8))
    assert fa.LAUNCHES == {"flash_attention_fwd": 0,
                           "flash_attention_step": 0}


# ---------------------------------------------------------------------------
# routing predicate, transport choice, the ring of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_k,n,threshold", [
    (REF_RING_MIN_SK, 1, None), (REF_RING_MIN_SK, 4, None),
    (REF_RING_MIN_SK - 4, 4, None), (REF_RING_MIN_SK + 2, 4, None),
    (128, 4, 128), (127, 4, 128), (256, 3, 128)])
def test_use_ring_predicate(s_k, n, threshold):
    """The reference's cases (tests/test_ring_attention.py
    test_use_ring_predicate) and a few more, answer for answer."""
    assert fa.RING_MIN_SK == REF_RING_MIN_SK
    assert fa.use_ring(s_k, n, threshold=threshold) == \
        ref_use_ring(s_k, n, threshold=threshold)


def test_transport_is_the_group_backends():
    assert collectives.transport("gloo", "cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL group moves CUDA"):
        collectives.transport("nccl", "cpu")
    with pytest.raises(ValueError, match="no transport"):
        collectives.transport("mpi", "cpu")
    with pytest.raises(ValueError, match="gloo group moves host"):
        collectives.transport("gloo", "meta")
    if torch.cuda.is_available():
        assert collectives.transport("gloo", "cuda") == "gloo+host"
        assert collectives.transport("nccl", "cuda") == "nccl"
    else:
        # a CUDA tensor where no card is present: a clear error, no
        # fallback to another transport
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collectives.transport("gloo", torch.device("cuda"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collectives.transport("nccl", torch.device("cuda", 0))


def test_ring_of_one_matches_naive():
    """A one-rank mesh (no process group): one step, no rotation
    (the reference's test_ring_of_one)."""
    mesh = t_mesh.make_mesh(1, 1)
    q, k, v = _qkv(9, 1, 96, 96, 6, 3, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    calls = []
    plain = fa.flash_attention_step_plain
    table = registry.IMPLS["flash_attention_step"]
    table["reference"] = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    try:
        out = fa.ring_flash_attention(tq, tk, tv, window=0, mesh=mesh)
    finally:
        table["reference"] = plain
    assert len(calls) == 1
    _close(out.numpy(), _naive(q, k, v, 0), 2e-5)


# ---------------------------------------------------------------------------
# the schedules in gloo ranks
# ---------------------------------------------------------------------------

# (b, sq, sk, h, g, d, window): the reference's test_fwd_matches_allgather_
# and_unsharded (h = 10, g = 5 do not divide a 4-wide ring) and
# test_fwd_sq_ne_sk cases
RING_CASES = [(2, 128, 128, 8, 2, 16, 0), (2, 128, 128, 10, 5, 16, 64),
              (2, 128, 128, 4, 4, 16, 32), (1, 64, 128, 4, 2, 16, 0),
              (1, 128, 64, 4, 2, 16, 96), (1, 64, 128, 4, 2, 16, 48)]
SCHEDULES = ("reference", "flash", "flash_allgather", "flash_ring")
WORLDS = (2, 4)
LAYER_CFG = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=128, vocab=128, attn_impl="flash", attn_chunk=32,
                 dtype="float32")


def _local(a, rank, world, axis=1):
    n = a.shape[axis] // world
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


def _counting(calls, key, fn):
    return lambda *a, **kw: calls.__setitem__(key, calls[key] + 1) or \
        fn(*a, **kw)


def _rank_main(rank, world, init, outdir, layer_params):
    """One rank: every case on its sequence shards, outputs to an npz."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = t_mesh.make_mesh(1, world)
        res = {}
        for i, (b, sq, sk, h, g, d, w) in enumerate(RING_CASES):
            q, k, v = (torch.from_numpy(_local(a, rank, world))
                       for a in _qkv(i, b, sq, sk, h, g, d))
            res[f"ring{i}"] = fa.ring_flash_attention(q, k, v, window=w,
                                                      mesh=mesh).numpy()
            res[f"ag{i}"] = fa.sharded_flash_attention(
                q, k, v, window=w, mesh=mesh).numpy()
        q, k, v = (torch.from_numpy(_local(a, rank, world))
                   for a in _qkv(20, 1, 128, 128, 8, 2, 16))
        for name in SCHEDULES + (None,):
            res[f"seq_{name}"] = ops.seq_attention(
                q, k, v, window=0, impl=name, mesh=mesh).numpy()

        # the attention layer, ring route at attn_ring_min_sk = 128 and
        # all-gather route below the default threshold
        calls = {"step": 0, "fwd": 0}
        table = registry.IMPLS
        table["flash_attention_step"]["reference"] = _counting(
            calls, "step", fa.flash_attention_step_plain)
        table["flash_attention"]["reference"] = _counting(
            calls, "fwd", fa.flash_attention_fwd_plain)
        params = {k_: torch.from_numpy(a) for k_, a in layer_params.items()}
        x = torch.from_numpy(_local(_layer_x(), rank, world))
        pos = torch.arange(rank * x.shape[1], (rank + 1) * x.shape[1])[None]
        rules = make_rules(mesh)
        for thr in (128, 0):
            cfg = ModelConfig(**LAYER_CFG, attn_ring_min_sk=thr)
            calls.update(step=0, fwd=0)
            with use_rules(rules):
                out, _ = t_attn.attention(params, x, cfg, kind="global",
                                          positions=pos)
            res[f"layer{thr}"] = out.numpy()
            res[f"layer{thr}_calls"] = np.array([calls["step"],
                                                 calls["fwd"]])

        # the transport helpers on CPU tensors: a ring shift and a gather
        mine = torch.full((2, 3), float(rank))
        got = collectives.ring_shift((mine, mine + 0.5), mesh,
                                     "model").wait()
        res["shift"] = torch.stack(got).numpy()
        res["gather"] = collectives.all_gather_dim(mine[:, :1], mesh,
                                                   "model", dim=0).numpy()
        res["host_bytes"] = np.array(collectives.HOST_COPIES["bytes"])
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _layer_x():
    return np.random.default_rng(1).standard_normal((2, 128, 64)).astype(
        np.float32)


def _layer_params():
    cfg = RefModelConfig(**LAYER_CFG, attn_ring_min_sk=128)
    return {k: np.asarray(a, np.float32) for k, a in
            ref_attn.init_attention(jax.random.PRNGKey(0), cfg).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank0 results, ...]}: one gloo group per world size."""
    layer_params = _layer_params()
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"ring{world}")
        mp.spawn(_rank_main, args=(world, f"file://{d}/rendezvous", str(d),
                                   layer_params), nprocs=world, join=True)
        out[world] = [dict(np.load(d / f"rank{r}.npz"))
                      for r in range(world)]
    return out


def _joined(results, key):
    return np.concatenate([r[key] for r in results], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("i", range(len(RING_CASES)))
def test_ring_and_allgather_match_unsharded(ranks, world, i):
    """Ring and all-gather outputs, gathered over the ranks, against the
    reference's unsharded kernel (interpret mode) and its naive oracle."""
    b, sq, sk, h, g, d, w = RING_CASES[i]
    q, k, v = _qkv(i, b, sq, sk, h, g, d)
    unsharded = np.asarray(ref_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                   window=w, blk_q=BLOCK, blk_k=BLOCK,
                                   interpret=True))
    naive = _naive(q, k, v, w)
    _close(unsharded, naive, 2e-5)
    for key in (f"ring{i}", f"ag{i}"):
        got = _joined(ranks[world], key)
        _close(got, unsharded)
        _close(got, naive, 2e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", SCHEDULES + (None,))
def test_seq_attention_schedules_agree(ranks, world, name):
    """``seq_attention`` by each of the reference's names (and the
    routing default) against the reference's naive oracle (the reference's
    test_registry_impls_agree)."""
    q, k, v = _qkv(20, 1, 128, 128, 8, 2, 16)
    _close(_joined(ranks[world], f"seq_{name}"), _naive(q, k, v, 0), 2e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("thr,route", [(128, "ring"), (0, "allgather")])
def test_attention_layer_routes_over_ranks(ranks, world, thr, route):
    """The layer under rules takes the ring at attn_ring_min_sk = 128 (N
    steps, no one-shot kernel) and the all-gather below the default
    threshold (one one-shot call), and matches the reference's unsharded
    layer (the reference's test_attention_layer_routes_ring)."""
    cfg = RefModelConfig(**LAYER_CFG, attn_ring_min_sk=thr)
    params = {k: jnp.asarray(a) for k, a in _layer_params().items()}
    want, _ = ref_attn.attention(params, jnp.asarray(_layer_x()), cfg,
                                 kind="global",
                                 positions=jnp.arange(128)[None])
    _close(_joined(ranks[world], f"layer{thr}"), np.asarray(want))
    for r in ranks[world]:
        steps, fwd = r[f"layer{thr}_calls"]
        assert (steps, fwd) == ((world, 0) if route == "ring" else (0, 1))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_shift_and_gather_move_host_tensors(ranks, world):
    """gloo moves CPU tensors as they are: each rank receives its
    upstream neighbour's pair, the gather stacks the ranks in order, and
    no bytes go through host copies."""
    for rank, r in enumerate(ranks[world]):
        prev = (rank - 1) % world
        np.testing.assert_array_equal(r["shift"][0], np.full((2, 3), prev))
        np.testing.assert_array_equal(r["shift"][1],
                                      np.full((2, 3), prev + 0.5))
        np.testing.assert_array_equal(
            r["gather"], np.repeat(np.arange(world, dtype=np.float32), 2)[
                :, None])
        assert int(r["host_bytes"]) == 0


def test_layer_config_is_the_references():
    """The layer cases build the same config in both packages."""
    ref = dataclasses.asdict(RefModelConfig(**LAYER_CFG))
    assert ref == dataclasses.asdict(ModelConfig(**LAYER_CFG))
