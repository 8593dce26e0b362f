"""Port parity: the backward passes of the sequence-sharded attention
routes, against the JAX package, on the CPU.

* The all-gather route's backward: ``ops.flash_attention(q_rows, k, v,
  q_base=...)`` (``FlashAttention``, recomputing through the plain chunked
  core at the rows' global offsets) for every rank's rows of a sequence
  in one process; its dq rows, and dk / dv summed over the ranks, against
  the reference's ``_fa_bwd`` over the whole sequence, at 2, 3 (rows not
  on the chunk's grid) and 4 ranks, windows 0 and 32.
* The schedules over gloo ranks (``torch_sharded_attn_ranks``: each world
  one ``torch.multiprocessing`` spawn over a ``file://`` rendezvous, all
  at once, the oracles meanwhile in this process): the ring
  (``RingFlashAttention``'s reverse ring: dk / dv come home after N hops)
  and the all-gather schedule (dK / dV reduce-scattered to their shards)
  at 2 and 4 ranks, dq on each rank's rows and dk / dv on their home
  shards against ``_fa_bwd`` over the whole sequence, the reference's
  ``_ring_bwd_impl`` semantics (its shard_map needs as many JAX devices
  as ranks, which one CPU process does not have).
* The sequence-parallel LM forward differentiated: a gemma3-shaped smoke
  model (2 layers, one local with window 32, one global) under
  ``use_rules`` at 1, 3 and 4 ranks of ``model``, each rank its shard of
  2 x 192 tokens, the nll's sum over the global token count, gradients
  summed over the ranks; under naive, chunked, flash (all-gather) and
  flash around the ring (``attn_ring_min_sk`` = 192), against the port's
  and the reference's unsharded loss and gradients.

Tolerances.  fp32 throughout; the backward passes sum in other orders
(the reverse ring folds a shard at a time, the recompute walks 32-key
blocks from the rows' offsets, the reference walks its own), a few 1e-7
relative on O(1) values: gradients of the schedules within ``TOL`` = 1e-5
of the largest magnitude of the reference's (``tests/
test_torch_lm_sharded_train.py``'s ``TIGHT_GRAD``), outputs within
``TOL`` of the reference's naive oracle.  The LM's gradients within
``TIGHT_GRAD`` = 1e-5 of the largest magnitude of the port's unsharded
ones and ``REF_GRAD`` = 1e-4 of the reference's, the loss within 2e-6 and
1e-5 relative (``tests/test_torch_lm_sharded_train.py``'s).
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_attn_ranks as R  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.kernels.flash_attention import _fa_bwd  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5
TIGHT_RTOL, TIGHT_GRAD = 2e-6, 1e-5
FP32_RTOL, REF_GRAD = 1e-5, 1e-4
CHUNK = 32


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, frac=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _ref_bwd(window, seed=7, shape=R.SHAPE):
    """The reference's output (naive oracle) and ``_fa_bwd`` gradients
    over the whole sequence, as numpy."""
    q, k, v, g = R.qkv(seed, window, shape)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    b, s, h, d = q.shape
    out = ref_attn._naive_grouped(jq.reshape(b, s, k.shape[2],
                                             h // k.shape[2], d),
                                  jk, jv, window=window).reshape(b, s, h, d)
    grads = _fa_bwd(window, CHUNK, True, (jq, jk, jv), jg)
    return (np.asarray(out),) + tuple(np.asarray(t) for t in grads)


# (ranks, (b, S, H, G, D)): 120 rows over 3 ranks put q_base at 40 and 80,
# off the 32-key blocks' grid
ROWS = {2: (2, 128, 4, 2, 16), 3: (1, 120, 6, 3, 16), 4: (2, 128, 4, 1, 16)}


@pytest.mark.parametrize("window", R.WINDOWS)
@pytest.mark.parametrize("n", sorted(ROWS))
def test_rows_backward_matches_fa_bwd(n, window):
    """Every rank's rows through ``ops.flash_attention(q_rows, k, v,
    q_base=...)`` under autograd, in one process: dq rows side by side and
    dk / dv summed over the rows equal the reference's ``_fa_bwd`` over
    the whole sequence."""
    shape = ROWS[n]
    q, k, v, g = (torch.from_numpy(a) for a in R.qkv(3, window, shape))
    sl = q.shape[1] // n
    outs, dqs = [], []
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(n):
        qr = q[:, r * sl:(r + 1) * sl].clone().requires_grad_(True)
        kr, vr = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
        out = ops.flash_attention(qr, kr, vr, window=window, q_base=r * sl,
                                  chunk=CHUNK)
        assert out.grad_fn is not None
        a, b_, c = torch.autograd.grad(out, (qr, kr, vr),
                                       g[:, r * sl:(r + 1) * sl])
        outs.append(out.detach())
        dqs.append(a)
        dk += b_
        dv += c
    want = _ref_bwd(window, 3, shape)
    _close(torch.cat(outs, 1), want[0])
    _close(torch.cat(dqs, 1), want[1])
    _close(dk, want[2])
    _close(dv, want[3])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = R.start_worlds(_ref_weights(),
                             str(tmp_path_factory.mktemp("attn_bwd")))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(_ref_bwd, w) for w in R.WINDOWS]
        futs += [pool.submit(_lm_oracles, impl) for impl in R.IMPLS]
        for fut in futs:
            fut.result()
    return R.join_worlds(started)


@pytest.mark.parametrize("window", R.WINDOWS)
@pytest.mark.parametrize("world", [w for w, jobs in R.WORLDS.items()
                                   if "schedules" in jobs])
@pytest.mark.parametrize("name", R.SCHEDULES)
def test_schedule_backward_matches_fa_bwd(ranks, name, world, window):
    """The ring's reverse ring and the all-gather schedule's reduce-
    scatter: each rank's output and dq rows, and dk / dv on their home
    shards, put back together, equal the reference's naive output and
    ``_fa_bwd`` gradients over the whole sequence."""
    got = ranks[("schedule", name, window, world)]
    want = _ref_bwd(window)
    for a, b in zip(got, want):
        _close(a, b)


@functools.lru_cache(maxsize=None)
def _ref_weights():
    cfg = _ref_cfg("chunked")
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  ref_model.init_model(jax.random.PRNGKey(0),
                                                       cfg))


def _ref_cfg(impl):
    return dataclasses.replace(ref_configs.get_config("gemma3_12b", "smoke"),
                               **R.LM_OVER, **R.IMPLS[impl])


_LM = {}


def _lm_oracles(impl):
    """(the port's unsharded loss and gradients, the reference's)."""
    if impl not in _LM:
        port = R.lm_grads(R.lm_cfg(impl), _ref_weights())
        rc = _ref_cfg(impl)
        tokens, labels = (jnp.asarray(t.numpy()) for t in R.lm_batch(rc.vocab))
        params = jax.tree_util.tree_map(jnp.asarray, _ref_weights())
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: ref_model.train_loss(p, tokens, labels, rc),
            has_aux=True))(params)
        ref = (float(loss), [np.asarray(g, np.float32)
                             for g in jax.tree_util.tree_leaves(grads)])
        _LM[impl] = (port, ref)
    return _LM[impl]


@pytest.mark.parametrize("world", [w for w, jobs in R.WORLDS.items()
                                   if "lm" in jobs])
@pytest.mark.parametrize("impl", list(R.IMPLS))
def test_sequence_parallel_forward_trains(ranks, impl, world):
    """The sequence-parallel forward's loss and every leaf's gradient,
    summed over the ranks, against both packages' unsharded ones."""
    loss, grads = ranks[("lm", impl, world)]
    (p_loss, p_grads), (r_loss, r_grads) = _lm_oracles(impl)
    np.testing.assert_allclose(loss, p_loss, rtol=TIGHT_RTOL)
    np.testing.assert_allclose(loss, r_loss, rtol=FP32_RTOL)
    assert len(grads) == len(p_grads) == len(r_grads)
    for g, p, r in zip(grads, p_grads, r_grads):
        assert float(g.abs().max()) > 0
        _close(g, p, TIGHT_GRAD)
        _close(g, r, REF_GRAD)
