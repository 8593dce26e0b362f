"""Port parity: the LM serving path (configs, layers, attention routes,
caches, prefill + decode) against the JAX package on the CPU.

The reference's weights are carried across with ``interop.lm_params``;
inputs are made with numpy and handed to both packages.  The reference's
flash route runs its Pallas kernel in interpret mode.

Tolerances.  In fp32 both packages do the same operations; the sums run
in other orders and ``sin``/``cos``/``exp``/``tanh`` differ by an ulp or
so, which stays at a few 1e-7 of the values through one layer
(``LAYER_TOL = 1e-5``, relative and absolute) and, through a 6-layer smoke
model and its 512-way logits, at about 1e-6 of the largest logit
(``MODEL_TOL = 1e-4`` of ``max |logit|``).  In bf16 every elementwise step
rounds to 8 significant bits, and where the two frameworks round at other
places (XLA fuses ``x * inv * (1 + scale)`` and GELU's polynomial in fp32,
PyTorch rounds after each operation) activations differ by an ulp,
2^-8 relative, which the 6 layers carry to the logits: ``BF16_TOL =
5e-2`` of ``max |logit|``, and greedy tokens are compared, not required
equal, in bf16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 5e-2
BATCH, PROMPT, STEPS = 2, 96, 4


def _cfgs(arch, **over):
    """The same config from both packages, with the same overrides."""
    return (dataclasses.replace(ref_configs.get_config(arch, "smoke"), **over),
            dataclasses.replace(t_configs.get_config(arch, "smoke"), **over))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(
        jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_configs_are_copies(arch, variant):
    ref = ref_configs.get_config(arch, variant)
    port = t_configs.get_config(arch, variant)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert ref.param_count() == port.param_count()
    assert port.compute_dtype == getattr(torch, port.dtype)
    assert t_configs.SHAPES == ref_configs.SHAPES


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_full_width_init_builds_no_host_copy(arch):
    """init_model at full width on the meta device, nothing allocated: the
    reference's tree exactly (its ``init_model`` traced by
    ``jax.eval_shape``, which allocates nothing either), every key, shape
    and dtype (the masters', fp32 for the router and the SSM's and
    RG-LRU's decay leaves); and the reference's parameter count, which
    leaves out the norm scales (and, for the SSM, its conv, decay and
    norm leaves)."""
    cfg = t_configs.get_config(arch, "full")
    params = t_model.init_model(cfg, device="meta")
    want = jax.eval_shape(lambda k: ref_model.init_model(
        k, ref_configs.get_config(arch, "full")), jax.random.PRNGKey(0))
    got = {"/".join(map(str, p)): t for p, t in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    ref = {"/".join(map(str, p)): a for p, a in
           jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == ref[name].shape, name
        assert str(t.dtype) == f"torch.{ref[name].dtype}", name
    total = sum(t.numel() for t in got.values())
    assert total == sum(a.size for a in ref.values())
    norms = (sum(k != "ssm" for k in cfg.block_pattern) * cfg.n_units +
             cfg.n_layers + 1) * cfg.d_model
    if not {"ssm", "rglru"} & set(cfg.block_pattern):
        assert total == cfg.param_count() + norms


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x).astype(jdt), 1e-6)
    got = t_layers.rmsnorm({"scale": _t(scale)}, _t(x, tdt), 1e-6)
    assert got.dtype == tdt
    _close(got, want, LAYER_TOL if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    for pos in (np.arange(7)[None], np.arange(2040, 2047)[None]):
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = t_layers.apply_rope(_t(x), torch.from_numpy(pos), theta)
        _close(got, want)


@pytest.mark.parametrize("activation", ["gelu", "geglu", "swiglu",
                                        "sq_relu"])
def test_mlp(activation):
    ref_cfg, cfg = _cfgs("gemma3_12b", activation=activation)
    params = _np_tree(ref_layers.init_mlp(jax.random.PRNGKey(2), ref_cfg))
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = ref_layers.mlp(params, jnp.asarray(x), ref_cfg)
    got = t_layers.mlp({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# attention, route by route
# ---------------------------------------------------------------------------

ROUTES = {
    # name: (attn_impl, sequence length, with a cache)
    "flash": ("flash", 96, False),
    "flash_cached": ("flash", 96, True),
    "naive_flat": ("chunked", 40, False),
    "chunked_flat": ("chunked", 96, False),
    "naive_grouped": ("chunked", 40, True),
    "chunked_grouped": ("chunked", 96, True),
}


def _layer_setup(impl, kind):
    ref_cfg, cfg = _cfgs("gemma3_12b", attn_impl=impl)
    params = _np_tree(ref_attn.init_attention(jax.random.PRNGKey(4),
                                              ref_cfg))
    m = 100 if kind == "attn" else min(cfg.window, 100)
    shape = (BATCH, m, cfg.n_kv_heads, cfg.head_dim_)
    ref_cache = ref_attn.KVCache(jnp.zeros(shape), jnp.zeros(shape),
                                 jnp.int32(0))
    t_cache = t_attn.KVCache(torch.zeros(shape), torch.zeros(shape),
                             torch.zeros((), dtype=torch.int32))
    return ref_cfg, cfg, params, {k: _t(v) for k, v in params.items()}, \
        ref_cache, t_cache


def _attend(ref_cfg, cfg, params, tparams, x, pos, ref_cache, t_cache,
            kind):
    theta = 1e6 if kind == "attn" else 1e4
    want, ref_cache = ref_attn.attention(
        params, jnp.asarray(x), ref_cfg, kind=kind,
        positions=jnp.asarray(pos), cache=ref_cache,
        update_cache=ref_cache is not None, rope_theta=theta)
    got, t_cache = t_attn.attention(
        tparams, _t(x), cfg, kind=kind, positions=torch.from_numpy(pos),
        cache=t_cache, update_cache=t_cache is not None, rope_theta=theta)
    _close(got, want)
    if ref_cache is not None:
        _close(t_cache.k, ref_cache.k)
        _close(t_cache.v, ref_cache.v)
        assert int(t_cache.length) == int(ref_cache.length)
    return ref_cache, t_cache


@pytest.mark.parametrize("kind", ["attn", "local"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_attention_route(route, kind, monkeypatch):
    """Each one-device route of ``attention`` against the reference's, the
    cache it writes included; only the flash routes call the flash op."""
    impl, s, cached = ROUTES[route]
    ref_cfg, cfg, params, tparams, ref_cache, t_cache = _layer_setup(impl,
                                                                     kind)
    if not cached:
        ref_cache = t_cache = None
    calls = []
    plain = fa.flash_attention_fwd_plain
    monkeypatch.setitem(registry.IMPLS["flash_attention"], "reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    x = np.random.default_rng(5).standard_normal(
        (BATCH, s, cfg.d_model)).astype(np.float32)
    _attend(ref_cfg, cfg, params, tparams, x, np.arange(s)[None], ref_cache,
            t_cache, kind)
    assert len(calls) == (1 if impl == "flash" else 0)


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_attention_decode_route_and_rolling_slots(kind):
    """Prefill 40 tokens, then decode three: the local layer's rolling
    cache (32 slots) takes token t at slot t % 32, and the decode reads
    the cache through ``_decode_grouped``."""
    ref_cfg, cfg, params, tparams, ref_cache, t_cache = _layer_setup(
        "chunked", kind)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, 43, cfg.d_model)).astype(np.float32)
    ref_cache, t_cache = _attend(ref_cfg, cfg, params, tparams, x[:, :40],
                                 np.arange(40)[None], ref_cache, t_cache,
                                 kind)
    for t in range(40, 43):
        ref_cache, t_cache = _attend(ref_cfg, cfg, params, tparams,
                                     x[:, t:t + 1], np.array([[t]]),
                                     ref_cache, t_cache, kind)
    if kind == "local":
        # token 42's k sits at slot 42 % 32 = 10
        assert not torch.equal(t_cache.k[:, 10], torch.zeros_like(
            t_cache.k[:, 10]))


def test_init_caches_match_reference_shapes():
    ref_cfg, cfg = _cfgs("gemma3_12b")
    want = ref_model.init_caches(ref_cfg, 3, 50)
    got = t_model.init_caches(cfg, 3, 50, device="cpu")
    assert len(got) == len(want) == len(cfg.block_pattern)
    for g, w in zip(got, want):
        assert tuple(g.k.shape) == w.k.shape and tuple(g.v.shape) == \
            w.v.shape and tuple(g.length.shape) == w.length.shape
        assert g.k.dtype == cfg.compute_dtype


# ---------------------------------------------------------------------------
# the model: prefill, then decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_run(arch, impl, dtype, steps):
    """The reference's greedy prefill + decode; logits of each step and
    the final caches, as numpy."""
    ref_cfg, _ = _cfgs(arch, attn_impl=impl, dtype=dtype)
    params = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    prompts = np.random.default_rng(9).integers(0, ref_cfg.vocab,
                                                (BATCH, PROMPT))
    caches = ref_model.init_caches(ref_cfg, BATCH, PROMPT + steps + 1)
    pre = jax.jit(functools.partial(ref_model.prefill, cfg=ref_cfg))
    dec = jax.jit(functools.partial(ref_model.decode_step, cfg=ref_cfg))
    logits, caches = pre(params, jnp.asarray(prompts, jnp.int32),
                         caches=caches)
    outs, tokens = [logits], []
    for t in range(steps):
        tok = jnp.argmax(logits[:, :ref_cfg.vocab], -1)[:, None]
        tokens.append(np.asarray(tok))
        logits, caches = dec(params, tok, jnp.int32(PROMPT + t),
                             caches=caches)
        outs.append(logits)
    return (_np_tree(params), prompts, [np.asarray(o, np.float32)
                                        for o in outs],
            np.concatenate(tokens, 1), _np_tree(caches))


def _port_run(arch, impl, dtype, steps):
    params, prompts, _, _, _ = _reference_run(arch, impl, dtype, steps)
    _, cfg = _cfgs(arch, attn_impl=impl, dtype=dtype)
    tparams = interop.lm_params(params, cfg, device="cpu")
    caches = t_model.init_caches(cfg, BATCH, PROMPT + steps + 1,
                                 device="cpu")
    fa.reset_launches()
    logits, caches = t_model.prefill(tparams, torch.from_numpy(prompts), cfg,
                                     caches)
    outs, tokens = [logits], []
    for t in range(steps):
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        tokens.append(tok.numpy())
        logits, caches = t_model.decode_step(tparams, tok, PROMPT + t, cfg,
                                             caches)
        outs.append(logits)
    return cfg, [o.float().numpy() for o in outs], np.concatenate(tokens, 1), \
        caches


@pytest.mark.parametrize("impl", ["flash", "chunked"])
@pytest.mark.parametrize("arch", ["gemma3_12b", "starcoder2_7b"])
def test_prefill_then_decode_matches_reference(arch, impl):
    """96-token prompts (above the smoke configs' attn_chunk of 64 and
    gemma3_smoke's window of 32), then 4 greedy decode steps."""
    _, _, want, want_tok, want_caches = _reference_run(arch, impl, "float32",
                                                       STEPS)
    cfg, got, got_tok, caches = _port_run(arch, impl, "float32", STEPS)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=MODEL_TOL * scale)
    np.testing.assert_array_equal(got_tok, want_tok)
    for c, w in zip(caches, want_caches):
        np.testing.assert_allclose(c.k.numpy(), w[0], atol=LAYER_TOL * 10)
        np.testing.assert_allclose(c.v.numpy(), w[1], atol=LAYER_TOL * 10)
        np.testing.assert_array_equal(c.length.numpy(), w[2])


def test_prefill_then_decode_bf16():
    _, _, want, want_tok, _ = _reference_run("gemma3_12b", "flash",
                                             "bfloat16", 2)
    cfg, got, got_tok, _ = _port_run("gemma3_12b", "flash", "bfloat16", 2)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL * scale)
    assert got_tok.shape == want_tok.shape


def test_prefill_then_decode_matches_forward():
    """The port's own consistency: prefill + decode logits equal one
    cached forward over the whole sequence (the reference's
    test_prefill_then_decode_matches_forward)."""
    _, cfg = _cfgs("gemma3_12b", attn_impl="flash")
    params = t_model.init_model(cfg, torch.Generator().manual_seed(3),
                                "cpu")
    seq = PROMPT + 3
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, seq)))
    caches = t_model.init_caches(cfg, BATCH, seq, device="cpu")
    logits, caches = t_model.prefill(params, x[:, :PROMPT], cfg, caches)
    outs = [logits]
    for t in range(PROMPT, seq):
        logits, caches = t_model.decode_step(params, x[:, t:t + 1], t, cfg,
                                             caches)
        outs.append(logits)
    hidden, _, _ = t_model.forward(
        params, x, cfg, caches=t_model.init_caches(cfg, BATCH, seq,
                                                   device="cpu"),
        update_cache=True)
    want = t_layers.lm_logits(params["embed"], hidden[:, PROMPT - 1:seq - 1],
                              cfg)
    got = torch.stack(outs, 1)[:, :-1]
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=MODEL_TOL * scale)


def test_lm_params_refuses_a_wrong_layout():
    ref_cfg, cfg = _cfgs("starcoder2_7b")
    params = _np_tree(ref_model.init_model(jax.random.PRNGKey(0), ref_cfg))
    params["units"]["block0"]["mixer"]["wq"] = \
        params["units"]["block0"]["mixer"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        interop.lm_params(params, cfg, device="cpu")
    del params["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        interop.lm_params(params, cfg, device="cpu")


def test_serve_lm_generates_the_reference_greedy_ids():
    """The slice as a whole: ``serve_lm`` on the CPU with the reference's
    weights (flash prefill of 96 tokens, greedy decode) generates the ids
    the reference's own greedy loop generates from the same prompts."""
    ref_cfg, cfg = _cfgs("gemma3_12b", attn_impl="flash")
    args = t_serve.parser().parse_args([
        "--arch", "gemma3_12b", "--variant", "smoke", "--attn-impl",
        "flash", "--batch", "2", "--prompt-len", str(PROMPT), "--gen", "4",
        "--device", "cpu", "--seed", "5"])
    ref_params = ref_model.init_model(jax.random.PRNGKey(1), ref_cfg)
    tparams = interop.lm_params(_np_tree(ref_params), cfg, device="cpu")
    out = t_serve.serve_lm(args, params=tparams)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, PROMPT))
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)

    caches = ref_model.init_caches(ref_cfg, 2, PROMPT + 4)
    logits, caches = ref_model.prefill(ref_params, jnp.asarray(prompts),
                                       ref_cfg, caches)
    ids = [jnp.argmax(logits[:, :cfg.vocab], -1)[:, None]]
    for t in range(3):
        logits, caches = ref_model.decode_step(ref_params, ids[-1],
                                               jnp.int32(PROMPT + t),
                                               ref_cfg, caches)
        ids.append(jnp.argmax(logits[:, :cfg.vocab], -1)[:, None])
    np.testing.assert_array_equal(out["generated"],
                                  np.asarray(jnp.concatenate(ids, 1)))
    assert out["prefill_ms"] > 0 and out["decode_tok_s"] > 0
