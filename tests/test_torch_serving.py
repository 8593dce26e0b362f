"""Port parity and behaviour: served-model bundles and the serving stack.

  * bundles cross frameworks: one exported by ``repro`` loads in the port
    with its fingerprint verified, and one saved by the port loads in
    ``repro``; both sides then score the same rows with features equal
    exactly and logits allclose (rtol 1e-5 / atol 1e-6: float32 sums of
    k gathered rows in another order);
  * the port's gateway keeps the reference's behaviour: coalescing,
    oversized-request splits, empty requests, ``QueueFull``, deadlines and
    the serve chaos faults (hang, kill, raise), on the port's own copies
    of the chaos and watchdog code;
  * ``snapshot()`` has the reference's key set.
Everything runs on the CPU (``device="cpu"``), i.e. the plain kernels.
"""
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_model as jlm
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro.serving import ServingService as JService
from repro.serving import load_bundle as jload
from repro.serving import save_bundle as jsave
from repro_torch.core.linear_model import (LinearParams, bag_logits,
                                           bag_logits_packed)
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.runtime import (ChaosPlan, serve_hang_at, serve_kill_at,
                                 serve_raise_at)
from repro_torch.serving import (DeadlineExceeded, QueueFull, RunnerCrashed,
                                 ServeError, ServeTimeout, ServingService,
                                 load_bundle, save_bundle)

DIM, C, K = 24, 3, 16
MODES = [("regen", False), ("stored", False), ("regen", True),
         ("stored", True)]


def make_rows(n, seed=1):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, DIM))).astype(np.float32)
    return x * (rng.random((n, DIM)) < 0.4)


def jax_problem(mode, packed, seed=0):
    spec = JSpec(num_hashes=K, b_i=4, packed=packed)
    make = JPipe.create if mode == "stored" else JPipe.create_regen
    pipe = make(jax.random.PRNGKey(seed), DIM, spec)
    rng = np.random.default_rng(seed + 100)
    params = jlm.LinearParams(
        jnp.asarray(rng.standard_normal((pipe.num_features, C)), jnp.float32),
        jnp.asarray(rng.standard_normal((C,)), jnp.float32))
    return params, pipe


def port_problem(packed=False, seed=0):
    spec = FeatureSpec(num_hashes=K, b_i=4, packed=packed)
    pipe = FeaturePipeline.create_regen(np.array([seed, 7], np.uint32), DIM,
                                        spec, device="cpu")
    rng = np.random.default_rng(seed + 100)
    params = LinearParams(
        torch.from_numpy(rng.standard_normal((pipe.num_features, C))
                         .astype(np.float32)),
        torch.from_numpy(rng.standard_normal(C).astype(np.float32)))
    return params, pipe


def jax_offline(params, pipe, x):
    feats = pipe.features(jnp.asarray(x))
    if pipe.spec.packed:
        out = jlm.bag_logits_packed(params, feats,
                                    num_hashes=pipe.spec.num_hashes,
                                    b=pipe.spec.bits)
    else:
        out = jlm.bag_logits(params, feats)
    return np.asarray(feats), np.asarray(out)


def port_offline(params, pipe, x):
    feats = pipe.features(x)
    if pipe.spec.packed:
        out = bag_logits_packed(params, feats,
                                num_hashes=pipe.spec.num_hashes,
                                b=pipe.spec.bits)
    else:
        out = bag_logits(params, feats)
    return feats.numpy(), out.numpy()


def assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# bundles across frameworks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,packed", MODES)
def test_repro_bundle_loads_and_serves_in_port(mode, packed, tmp_path):
    jparams, jpipe = jax_problem(mode, packed)
    jsave(tmp_path / "model", jparams, jpipe)
    params, pipe = load_bundle(tmp_path / "model", device="cpu")
    assert pipe.fingerprint() == jpipe.fingerprint()
    x = make_rows(13)
    jf, jl = jax_offline(jparams, jpipe, x)
    tf, tl = port_offline(params, pipe, x)
    np.testing.assert_array_equal(tf, jf)
    assert_logits_close(tl, jl)
    with ServingService(params, pipe, buckets=(4, 8)) as svc:
        assert_logits_close(svc.score(x), jl)


@pytest.mark.parametrize("mode,packed", MODES)
def test_port_bundle_loads_in_repro(mode, packed, tmp_path):
    jparams, jpipe = jax_problem(mode, packed, seed=3)
    jsave(tmp_path / "src", jparams, jpipe)
    params, pipe = load_bundle(tmp_path / "src", device="cpu")
    save_bundle(tmp_path / "model", params, pipe)
    jp2, jpipe2 = jload(tmp_path / "model")     # verifies the fingerprint
    assert jpipe2.fingerprint() == pipe.fingerprint()
    x = make_rows(9, seed=4)
    jf, jl = jax_offline(jp2, jpipe2, x)
    tf, tl = port_offline(params, pipe, x)
    np.testing.assert_array_equal(tf, jf)
    assert_logits_close(tl, jl)


def test_bundle_tamper_and_format_guards(tmp_path):
    params, pipe = port_problem()
    save_bundle(tmp_path / "model", params, pipe)
    save_bundle(tmp_path / "model", params, pipe)     # overwrite in place
    with np.load(tmp_path / "model" / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["key_words"] = arrays["key_words"] + np.uint32(1)
    np.savez(tmp_path / "model" / "arrays.npz", **arrays)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_bundle(tmp_path / "model", device="cpu")
    mpath = tmp_path / "model" / "bundle.json"
    manifest = json.loads(mpath.read_text())
    manifest["format"] = "something-else/v9"
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="not a served-model bundle"):
        load_bundle(tmp_path / "model", device="cpu")


# ---------------------------------------------------------------------------
# gateway behaviour on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_coalesced_async_submissions_match_offline(packed):
    params, pipe = port_problem(packed)
    xs = [make_rows(n, seed=n) for n in (1, 7, 3, 16, 2, 11, 5)]
    refs = [port_offline(params, pipe, x)[1] for x in xs]
    with ServingService(params, pipe, buckets=(4, 16)) as svc:
        futs = [svc.submit(x) for x in xs]
        for f, ref in zip(futs, refs):
            assert_logits_close(f.result(timeout=30), ref)
        s = svc.stats()
        assert s["completed"] == len(xs)
        assert sum(b["rows"] for b in s["buckets"].values()) == \
            sum(x.shape[0] for x in xs)
        assert s["compile_count"] == 2


def test_oversized_request_splits_and_empty_request():
    params, pipe = port_problem()
    x = make_rows(41)
    with ServingService(params, pipe, buckets=(4, 16)) as svc:
        assert_logits_close(svc.score(x), port_offline(params, pipe, x)[1])
        assert svc.stats()["batches"] == 3          # 16 + 16 + pad(9 -> 16)
        got = svc.score(make_rows(0))
        assert got.shape == (0, C) and got.dtype == np.float32
        assert svc.stats()["completed"] == 2
        with pytest.raises(ValueError, match="rows"):
            svc.submit(np.zeros((2, DIM + 1), np.float32))


def _wait_in_flight(svc):
    deadline = time.monotonic() + 5.0
    while svc.stats()["queue_rows"] > 0:
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_queue_full_and_queued_deadline():
    params, pipe = port_problem()
    plan = ChaosPlan(serve_hang_at(0, 0.8))
    svc = ServingService(params, pipe, buckets=(8,), max_queue_rows=8,
                         chaos=plan)
    try:
        f1 = svc.submit(make_rows(8))              # dispatches, then hangs
        _wait_in_flight(svc)
        f2 = svc.submit(make_rows(4), deadline_s=0.05)   # expires queued
        with pytest.raises(QueueFull):
            svc.submit(make_rows(5))
        with pytest.raises(DeadlineExceeded):
            f2.result(timeout=10.0)
        f1.result(timeout=10.0)
        s = svc.stats()
        assert s["rejected"] == 1 and s["timed_out"] == 1
    finally:
        svc.stop()


def test_hang_is_failed_by_the_watchdog_then_service_recovers():
    params, pipe = port_problem()
    x = make_rows(5)
    ref = port_offline(params, pipe, x)[1]
    plan = ChaosPlan(serve_hang_at(0, 1.5))
    svc = ServingService(params, pipe, buckets=(8,), chaos=plan,
                         hard_timeout_s=0.2)
    try:
        t0 = time.monotonic()
        with pytest.raises(ServeTimeout):
            svc.score(x, timeout=10.0)
        assert time.monotonic() - t0 < 1.2   # failed mid-hang
        time.sleep(1.6)                      # the hung dispatch limps home
        assert_logits_close(svc.score(x, timeout=10.0), ref)
        s = svc.stats()
        assert s["watchdog_fired"] >= 1 and s["hang_recovered"] == 1
        assert s["compile_count"] == 1
    finally:
        svc.stop()


def test_kill_and_raise_fail_only_inflight_requests():
    params, pipe = port_problem(packed=True)
    plan = ChaosPlan(serve_raise_at(1), serve_kill_at(3))
    svc = ServingService(params, pipe, buckets=(8,), chaos=plan,
                         hard_timeout_s=5.0)
    try:
        outcomes = []
        for n in (2, 5, 3, 7, 4):
            x = make_rows(n, seed=50 + n)
            try:
                assert_logits_close(svc.score(x, timeout=10.0),
                                    port_offline(params, pipe, x)[1])
                outcomes.append("ok")
            except RunnerCrashed:
                outcomes.append("killed")
            except ServeError as e:
                assert "FaultInjected" in str(e)
                outcomes.append("raised")
        assert outcomes == ["ok", "raised", "ok", "killed", "ok"]
        assert [e["action"] for e in plan.log("serve_step")] == \
            ["raise", "kill"]
        s = svc.stats()
        assert s["restarts"] == 1 and s["failed_batches"] == 1
    finally:
        svc.stop()


def test_stop_fails_queued_requests():
    params, pipe = port_problem()
    svc = ServingService(params, pipe, buckets=(8,),
                         chaos=ChaosPlan(serve_hang_at(0, 0.4)))
    f1 = svc.submit(make_rows(4))
    _wait_in_flight(svc)
    f2 = svc.submit(make_rows(4))
    svc.stop()
    f1.result(timeout=10.0)
    with pytest.raises(ServeError, match="gateway stopped"):
        f2.result(timeout=10.0)


# ---------------------------------------------------------------------------
# monitoring surface and the launch front end
# ---------------------------------------------------------------------------


def _keys(snap):
    return (set(snap), set(snap["latency_ms"]),
            {k for b in snap["buckets"].values() for k in b})


def test_snapshot_schema_matches_reference():
    sizes = (1, 7, 16, 3)
    jparams, jpipe = jax_problem("regen", False)
    with JService(jparams, jpipe, buckets=(4, 16)) as jsvc:
        for n in sizes:
            jsvc.score(make_rows(n, seed=n))
        want = jsvc.stats()
    params, pipe = port_problem()
    with ServingService(params, pipe, buckets=(4, 16)) as svc:
        for n in sizes:
            svc.score(make_rows(n, seed=n))
        got = svc.stats()
        srv = svc.start_stats_server()
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            served = json.loads(resp.read())
    assert _keys(got) == _keys(want)
    assert _keys(served) == _keys(want)
    for key in ("requests", "rows", "completed", "batches", "compile_count"):
        assert got[key] == want[key]


def test_serve_bundle_front_end_on_cpu(tmp_path, capsys):
    params, pipe = port_problem(packed=True)
    save_bundle(tmp_path / "model", params, pipe)
    out = tserve.serve_bundle(tserve.parser().parse_args(
        ["--bundle", str(tmp_path / "model"), "--device", "cpu",
         "--requests", "12", "--max-rows", "9", "--buckets", "4,16"]))
    assert out["stats"]["completed"] == 12 and out["req_per_s"] > 0
    assert "req/s" in capsys.readouterr().out
