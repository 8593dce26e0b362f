"""Port parity: attention heads that do not divide over ``model`` (the
reference's sequence-sharded route), trained and served under the sharded
layout over gloo ranks, against the unsharded steps of both packages, on
the CPU.

``attention_tp`` sends heads that do not divide over ``tp`` to
``attention._attention_rows``: q's columns resharded to a rank's rows with
every head, attention over those rows at ``q_base = index * S / tp``
(row 8's plain version at ``q_base`` under autograd, row 9's ring and its
reverse-ring backward, or the grouped cores), the output resharded back
for ``wo``.  Configs (``torch_grouped_heads_ranks.CONFIGS``):
starcoder2's smoke config (6 / 2 heads) and smoke configs carrying the
full configs' head counts at head dim 16, 10 / 1 (recurrentgemma), 36 / 4
(starcoder2) and 40 / 8 (llama4, qk-norm), each under ``attn_impl``
flash (the all-gather route), flash with ``attn_ring_min_sk`` at the
sequence (the ring) and chunked, at meshes (1, 3) and (1, 4): each world
one ``torch.multiprocessing`` spawn over a ``file://`` rendezvous, the two
at once, the oracles meanwhile in this process.  Where the heads divide
(6 and 36 over 3, 36 and 40 over 4) the heads route runs, which computes
the same function.  Each case starts from the reference's initial state,
takes 3 steps of TokenBatchLoader(seed=0)'s 2 x 96 tokens, then serves
the reference's weights: a 96-token prompt into 108 cache slots (sliced
over ``kv_seq``) and 8 greedy steps.  The reference's mesh paths fail
under jax 0.9.0 (ROADMAP C): its oracles are unsharded.

Tolerances, as ``tests/test_torch_lm_sharded_train.py`` and
``tests/test_torch_lm_sharded_serve.py`` state them.  Against the port's
unsharded step (the same operations, sums over ranks in other orders):
losses within ``TIGHT_RTOL`` = 2e-6 relative, every gradient leaf within
``TIGHT_GRAD`` = 1e-5 of its largest magnitude, parameters within
``PARAM_ATOL`` = 2e-5.  Against the reference: losses within 1e-5
relative, gradients within ``REF_GRAD`` = 1e-4 of the largest magnitude
(recovered from its first moment after step 1; fp32 moments only),
parameters within ``PARAM_ATOL``; llama4's bf16 masters round
stochastically: its losses within 1e-4 of the reference's, parameters
within two bf16 ulps plus the learning rate a step.  Every served step's
logits within ``MODEL_TOL`` = 1e-4 of the largest of the reference's, and
the same greedy ids.
"""
import concurrent.futures
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_grouped_heads_ranks as R  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

TIGHT_RTOL, TIGHT_GRAD, PARAM_ATOL = 2e-6, 1e-5, 2e-5
FP32_RTOL, LOOSE_RTOL, REF_GRAD, MODEL_TOL = 1e-5, 1e-4, 1e-4, 1e-4
BF16_ULP = 2.0 ** -7
CASES = [(name, impl, mesh) for world, meshes in R.MESHES.items()
         for mesh in meshes for name in R.CONFIGS for impl in R.IMPLS]
IDS = [f"{n}-{i}@{m[0]}x{m[1]}" for n, i, m in CASES]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: PyTorch's default count spins badly when
    several test processes (and XLA's threads) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ref_cfg(name, impl="chunked"):
    arch, over = R.CONFIGS[name]
    return dataclasses.replace(ref_configs.get_config(arch, "smoke"),
                               **over, attn_impl=R.IMPLS[impl]["attn_impl"])


def _ref_hp():
    return ref_trainer.TrainHparams(lr=R.LR, warmup=2, total_steps=30)


_PAYLOAD = {}


def _payload():
    """The reference's initial states (as the port's ``TrainState`` of
    numpy arrays) and weights (numpy trees), one per config."""
    if not _PAYLOAD:
        states, weights = {}, {}
        for name in R.CONFIGS:
            rc = _ref_cfg(name)
            st = ref_trainer.init_train_state(jax.random.PRNGKey(0), rc,
                                              _ref_hp())
            states[name] = t_trainer.TrainState(
                *jax.tree_util.tree_map(np.asarray, st))
            weights[name] = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32),
                ref_model.init_model(jax.random.PRNGKey(0), rc))
        _PAYLOAD.update(states=states, weights=weights)
    return _PAYLOAD


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = R.start_worlds(_payload(),
                             str(tmp_path_factory.mktemp("grouped")))
    jobs = [(name, impl) for name in R.CONFIGS for impl in R.IMPLS]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(_oracles, *job) for job in jobs]:
            fut.result()
    return R.join_worlds(started)


_ORACLES = {}


def _oracles(name, impl):
    """The port's unsharded run (losses, step 1's gradients, final
    parameters, served logits and ids) and the reference's (its unsharded
    ``make_train_step`` and ``make_serve_steps``; the ring threshold does
    not reach its one-device route, so "ring" shares "flash"'s)."""
    key = (name, impl)
    if key in _ORACLES:
        return _ORACLES[key]
    payload = _payload()
    cfg = R.port_cfg(name, impl)
    state = interop.lm_train_state(payload["states"][name], cfg,
                                   device="cpu")
    losses, g0, state = R.run_train(cfg, state)
    logits, ids = R.serve(cfg, interop.lm_params(payload["weights"][name],
                                                 cfg, device="cpu"))
    port = (losses, tree_leaves(g0), tree_leaves(state.params), logits, ids)
    _ORACLES[key] = (port, _reference(name, "flash" if impl == "ring"
                                      else impl))
    return _ORACLES[key]


_REF = {}
_REF_LOCKS = {(name, impl): threading.Lock() for name in R.CONFIGS
              for impl in R.IMPLS}


def _reference(name, impl):
    with _REF_LOCKS[(name, impl)]:
        if (name, impl) not in _REF:
            _REF[(name, impl)] = _reference_run(name, impl)
    return _REF[(name, impl)]


def _reference_run(name, impl):
    rc, hr = _ref_cfg(name, impl), _ref_hp()
    step = jax.jit(ref_trainer.make_train_step(rc, hr, None))
    rs = ref_trainer.TrainState(*jax.tree_util.tree_map(
        jnp.asarray, _payload()["states"][name]))
    losses, mu1 = [], None
    for x, y in R.batches(rc.vocab):
        rs, m = step(rs, {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)})
        losses.append(float(m["loss"]))
        if mu1 is None:
            clip = min(1.0, hr.clip_norm / (float(m["grad_norm"]) + 1e-9))
            mu1 = [np.asarray(g, np.float32) / ((1 - hr.b1) * clip)
                   for g in jax.tree_util.tree_leaves(rs.mu)]
    params = [np.asarray(p, np.float32)
              for p in jax.tree_util.tree_leaves(rs.params)]
    weights = jax.tree_util.tree_map(jnp.asarray, _payload()["weights"][name])
    pre, dec = ref_trainer.make_serve_steps(rc, None)
    pre, dec = jax.jit(pre), jax.jit(dec)
    caches = ref_model.init_caches(rc, R.SV_BATCH, R.SLOTS)
    logits, caches = pre(weights, jnp.asarray(R.prompts(rc)), caches)
    outs, ids = [logits], []
    for t in range(R.GEN):
        tok = jnp.argmax(logits[:, :rc.vocab], -1)[:, None]
        ids.append(np.asarray(tok))
        logits, caches = dec(weights, tok, jnp.int32(R.PROMPT + t), caches)
        outs.append(logits)
    return (losses, mu1, params,
            np.stack([np.asarray(o, np.float32) for o in outs], 1),
            np.concatenate(ids, 1))


def _grads_close(got, want, frac):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= frac * scale, (i, err, scale)


@pytest.mark.parametrize("name,impl,mesh", CASES, ids=IDS)
def test_train_step_tracks_both_packages(ranks, name, impl, mesh):
    got = ranks[(name, impl, mesh)]
    (losses, g0, params, _, _), (r_losses, r_g0, r_params, _, _) = \
        _oracles(name, impl)
    cfg = R.port_cfg(name, impl)
    bf16 = cfg.param_dtype == "bfloat16"
    np.testing.assert_allclose(got["losses"], losses, rtol=TIGHT_RTOL)
    np.testing.assert_allclose(got["losses"], r_losses,
                               rtol=LOOSE_RTOL if bf16 else FP32_RTOL)
    _grads_close(got["grads"], [g.numpy() for g in g0], TIGHT_GRAD)
    if cfg.moment_dtype != "bfloat16":
        _grads_close(got["grads"], r_g0, REF_GRAD)
    p_atol = R.LR * R.STEPS if bf16 else PARAM_ATOL
    p_rtol = 2 * BF16_ULP if bf16 else 0.0
    for a, b, r in zip(got["params"], params, r_params):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=p_rtol, atol=p_atol)
        np.testing.assert_allclose(a.float().numpy(), r, rtol=p_rtol,
                                   atol=p_atol)


@pytest.mark.parametrize("name,impl,mesh", CASES, ids=IDS)
def test_serving_tracks_both_packages(ranks, name, impl, mesh):
    got = ranks[(name, impl, mesh)]
    (_, _, _, logits, ids), (_, _, _, r_logits, r_ids) = _oracles(name, impl)
    scale = float(np.abs(r_logits).max())
    np.testing.assert_allclose(got["logits"].numpy(), r_logits, rtol=0,
                               atol=MODEL_TOL * scale)
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                               rtol=0, atol=MODEL_TOL * scale)
    np.testing.assert_array_equal(got["ids"].numpy(), r_ids)
    assert torch.equal(got["ids"], ids)


def test_the_heads_route_where_they_divide(ranks):
    """Which route each case took, read from ``wq``'s local shape: a
    rank's columns are whole heads where the heads divide over model (the
    heads route) and cut through a head where they do not (llama4's 40
    heads of 16 over 4 is 10 whole heads a rank; over 3, 640 columns do
    not divide and ``wq`` stays whole)."""
    for (name, impl, mesh), got in ranks.items():
        cfg = R.port_cfg(name, impl)
        q_flat = cfg.n_heads * cfg.head_dim_
        want = q_flat // mesh[1] if q_flat % mesh[1] == 0 else q_flat
        assert got["wq_local"][-1] == want, (name, mesh, got["wq_local"])
    sc = R.port_cfg("starcoder2", "flash")
    assert sc.n_heads % 4 and (sc.n_heads * sc.head_dim_) % 4 == 0
