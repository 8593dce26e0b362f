"""The ring-attention benchmark's twin against the reference.

``src/repro_torch/benchmarks/reference/BENCH_ring_attention.json`` is the
reference's own ``--fast`` record on four host devices (jax 0.9.0,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  The reference
is rerun the same way in a subprocess (its mesh takes every device of
its process) and must reproduce the record but for its wall times.  The
twin runs both schedules in 2 gloo ranks on the CPU (their plain
versions), and their gathered outputs are held against the reference's
flash kernel (interpret mode) on the same q, k and v within 1e-5 fp32
(both sum the same scores in another order); at 4 ranks the twin's
modelled bytes equal the record's.  Its q, k and v are the reference's
draws: ``normal`` differs from ``jax.random.normal`` in the last bits of
a few entries (ROADMAP C).  No test writes under ``benchmarks/results``
or ``src/repro_torch/benchmarks/results``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as ref_fwd
from repro_torch.benchmarks import bench_ring_attention as twin
from repro_torch.benchmarks import common

ROOT = common.HERE.parents[2]
TOL = 1e-5
TIMES = ("wall_us_ring", "wall_us_allgather")
# entries of (q, k, v) that differ from jax.random.normal's draws (of
# 65,536, 32,768 and 32,768), all within 3 ulp
INPUT_DIFFS = (3065, 1565, 1521)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_reference_reproduces_its_record(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run(
        [sys.executable, "-c",
         "import benchmarks.common as c, pathlib, sys; "
         "c.RESULTS = pathlib.Path(sys.argv[1]); "
         "from benchmarks import bench_ring_attention as b; "
         "b.main(['--fast'])", str(tmp_path)],
        check=True, env=env, cwd=ROOT, timeout=300, capture_output=True)
    got = json.loads((tmp_path / "BENCH_ring_attention.json").read_text())
    want = common.load_reference(twin.RECORDS[0])
    untimed = lambda r: {k: v for k, v in r.items() if k not in TIMES}
    assert untimed(got) == untimed(want)


def test_inputs_are_the_reference_draws():
    shape = twin.shape_for(True)
    key = jax.random.PRNGKey(0)
    b, s, h, g, d = (shape[c] for c in ("b", "s_q", "h", "g", "d"))
    want = (jax.random.normal(key, (b, s, h, d), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 1), (b, s, g, d)),
            jax.random.normal(jax.random.fold_in(key, 2), (b, s, g, d)))
    got = twin.inputs(shape)
    diffs = []
    for t, w in zip(got, want):
        t, w = t.numpy(), np.asarray(w)
        assert t.shape == w.shape and t.dtype == np.float32
        np.testing.assert_array_max_ulp(t, w, maxulp=3)
        diffs.append(int((t != w).sum()))
    assert tuple(diffs) == INPUT_DIFFS


def test_two_ranks_match_the_reference_kernel():
    shape = twin.shape_for(True)
    reports, ring, allg = twin.schedules(2, shape, torch.device("cpu"),
                                         repeats=1)
    q, k, v = (jnp.asarray(t.numpy()) for t in twin.inputs(shape))
    want = np.asarray(ref_fwd(q, k, v, window=0, blk_q=shape["block"],
                              blk_k=shape["block"], interpret=True))
    assert ring.shape == allg.shape == want.shape
    np.testing.assert_allclose(ring, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(allg, want, rtol=TOL, atol=TOL)
    assert [r["rank"] for r in reports] == [0, 1]
    # the plain versions count no kernel launch
    assert all(r["launches_ring"] == r["launches_allgather"] == {}
               for r in reports)


@pytest.mark.parametrize("world", (2, 4))
def test_twin_record_and_gates(world, tmp_path):
    before = {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS) for p in d.iterdir()}
    records = twin.run(fast=True, device="cpu", out=tmp_path, world=world)
    rec = records[twin.RECORDS[0]]
    ref = common.load_reference(twin.RECORDS[0])
    assert json.loads((tmp_path / "BENCH_ring_attention.json")
                      .read_text()) == common.as_json(rec)
    assert rec["shape"] == ref["shape"] and rec["ndev"] == world
    kv = ref["shape"]["s_k"] * ref["shape"]["g"] * ref["shape"]["d"] * 4
    assert rec["peak_kv_bytes_allgather"] == 2 * kv
    assert rec["peak_kv_bytes_ring"] == 4 * kv // world
    assert rec["parity_max_abs_diff"] < twin.PARITY_TOL
    assert "modeled_overlap" in rec["not_ported"]
    assert "modeled_overlap" not in rec
    assert rec["ranks_share_one_device"] is True
    claims = twin.check_claims(records)
    assert all(claims.values()) and len(claims) == (2 if world == 4 else 1)
    assert twin.launches(records) == {
        "flash_attention_step": world * world * (1 + twin.REPEATS),
        "flash_attention_fwd": world * (1 + twin.REPEATS)}
    after = {p: p.stat().st_mtime_ns for d in (
        ROOT / "benchmarks" / "results", common.RESULTS) for p in d.iterdir()}
    assert after == before
