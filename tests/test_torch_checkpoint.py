"""Port parity: checkpoints (``repro.checkpoint.checkpointer``).

The port's counterparts of ``tests/test_fault_tolerance.py``'s
``TestCheckpoint`` (but the mesh restore, ROADMAP A11) and
``TestCommitProtocol``, on the CPU; then the format across the packages,
on the linear trainer's tree in regen and in stored mode: each package
restores the other's checkpoint with every tensor equal, the leaf names
equal the reference's ``_tree_paths``, the manifests and indexes carry the
same keys and entries, a leaf written as two slices reassembles in both,
and bfloat16 leaves round-trip both ways.
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.core import linear_model as jlm
from repro.core.cws import make_cws_params as jmake_cws_params
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro_torch import interop
from repro_torch import optim as topt
from repro_torch.checkpoint import (Checkpointer, committed_steps,
                                    gc_incomplete, latest_step,
                                    restore_checkpoint, save_checkpoint,
                                    tree_paths)
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.core import linear_model as tlm
from repro_torch.core.cws import CWSParams

CPU = "cpu"


def leaves(tree):
    """A tree's leaves in the reference's order (names beside them)."""
    return tck._flatten(tree)


def tree_eq(a, b):
    la, lb = leaves(a), leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y), name


def specs(tree):
    """``tree`` with each leaf replaced by its (shape, dtype)."""
    return tck._rebuild(tree, iter(tck._leaf_spec(t)
                                   for _, t in leaves(tree)))


class TestCheckpoint:
    def _tree(self, seed):
        g = torch.Generator().manual_seed(seed)
        return {"params": {"w": torch.randn(16, 8, generator=g),
                           "b": torch.zeros(8, dtype=torch.bfloat16)},
                "step": torch.tensor(7, dtype=torch.int32)}

    def test_roundtrip(self, tmp_path):
        tree = self._tree(0)
        save_checkpoint(tmp_path, 7, tree)
        assert latest_step(tmp_path) == 7
        tree_eq(tree, restore_checkpoint(tmp_path, 7, specs(tree),
                                         device=CPU))

    def test_commit_atomicity(self, tmp_path):
        save_checkpoint(tmp_path, 5, self._tree(1))
        # a partly written (uncommitted) newer step must be invisible
        bad = tmp_path / "step_00000009"
        bad.mkdir()
        (bad / "manifest.json").write_text("{}")
        assert latest_step(tmp_path) == 5

    def test_retention(self, tmp_path):
        tree = self._tree(2)
        for s in [1, 2, 3, 4, 5]:
            save_checkpoint(tmp_path, s, tree, keep=2)
        steps = sorted(p.name for p in tmp_path.iterdir())
        assert steps == ["step_00000004", "step_00000005"]

    def test_async_and_extra(self, tmp_path):
        ck = Checkpointer(tmp_path)
        tree = self._tree(3)
        ck.save_async(11, tree, extra={"loader": {"step": 123, "seed": 0}})
        ck.wait()
        back, manifest = ck.restore_latest(tree, device=CPU)
        tree_eq(tree, back)
        assert manifest["extra"]["loader"]["step"] == 123
        assert ck.last_snapshot_s >= 0 and ck.last_write_s > 0

    def test_totals_add_up_every_save(self, tmp_path, monkeypatch):
        """``totals`` sums every save's snapshot and write, the writer
        thread's CPU time (which a sleeping writer does not spend) and the
        time ``wait`` blocked on it."""
        real = tck._write_shards

        def slow(*a, **kw):
            time.sleep(0.2)
            return real(*a, **kw)

        monkeypatch.setattr(tck, "_write_shards", slow)
        ck = Checkpointer(tmp_path)
        tree = self._tree(5)
        for step in (1, 2):
            ck.save_async(step, tree)
        ck.wait()
        t = ck.totals
        assert t["saves"] == 2 and latest_step(tmp_path) == 2
        assert t["snapshot_s"] >= ck.last_snapshot_s >= 0
        assert t["write_s"] >= 0.4 and t["write_s"] >= ck.last_write_s
        assert 0 < t["write_cpu_s"] < 0.2
        # the second save waited for the first write, the last wait for
        # the second
        assert t["blocked_s"] >= 0.3

    def test_async_snapshot_is_a_copy(self, tmp_path, monkeypatch):
        """The snapshot is taken before ``save_async`` returns, into memory
        of its own: writing the live tensors while the writer runs changes
        nothing on disk (on the CPU ``.cpu()`` and ``.numpy()`` would be
        views of them)."""
        tree = self._tree(4)
        want = {n: t.clone() for n, t in leaves(tree)}
        gate = threading.Event()
        real = tck._write_shards

        def held(*a, **kw):
            gate.wait(10.0)
            return real(*a, **kw)

        monkeypatch.setattr(tck, "_write_shards", held)
        ck = Checkpointer(tmp_path)
        ck.save_async(1, tree)
        for _, t in leaves(tree):
            t.fill_(3)
        gate.set()
        ck.wait()
        back = restore_checkpoint(tmp_path, 1, specs(tree), device=CPU)
        for name, t in leaves(back):
            assert torch.equal(t, want[name]), name

    def test_elastic_reshard(self, tmp_path):
        """A leaf saved as two processes' row slices (``shard_p0`` and
        ``shard_p1``, as a two-process save writes it) restores whole into
        one process."""
        w = torch.arange(48, dtype=torch.float32).reshape(12, 4)
        manifest, _ = tck._extract_shards(3, {"w": w}, None)
        d = tmp_path / "step_00000003"
        d.mkdir()
        for proc, (lo, hi) in enumerate(((0, 5), (5, 12))):
            np.savez(d / f"shard_p{proc}.npz", a0=w[lo:hi].numpy())
            (d / f"index_p{proc}.json").write_text(json.dumps(
                {f"['w']::{proc}": {"slot": "a0",
                                    "index": [[lo, hi], [0, 4]],
                                    "dtype": "float32"}}))
        (d / "manifest.json").write_text(json.dumps(manifest))
        (d / "COMMIT").write_text("1.0")
        back = restore_checkpoint(tmp_path, 3, {"w": ((12, 4),
                                                      torch.float32)},
                                  device=CPU)
        assert torch.equal(back["w"], w)

    def test_restore_casts_to_the_template_and_names_missing_leaves(
            self, tmp_path):
        save_checkpoint(tmp_path, 1, {"w": torch.arange(4.0)})
        back = restore_checkpoint(tmp_path, 1, {"w": ((4,), torch.float64)},
                                  device=CPU)
        assert back["w"].dtype == torch.float64
        with pytest.raises(KeyError, match="missing leaf"):
            restore_checkpoint(tmp_path, 1, {"v": ((4,), torch.float32)},
                               device=CPU)


class TestCommitProtocol:
    """Write into step_*.tmp, rename, then write COMMIT: every state a
    crash leaves is invisible or committed, and none wedges the dir."""

    W = {"w": torch.ones(4)}

    def test_commit_written_after_rename(self, tmp_path):
        save_checkpoint(tmp_path, 3, self.W)
        d = tmp_path / "step_00000003"
        assert (d / "COMMIT").exists()
        assert not list(tmp_path.glob("*.tmp"))

    def test_latest_step_ignores_tmp_dirs(self, tmp_path):
        save_checkpoint(tmp_path, 5, self.W)
        (tmp_path / "step_00000009.tmp").mkdir()
        (tmp_path / "step_00000009.tmp" / "COMMIT").write_text("1.0")
        (tmp_path / "notes.txt").write_text("unrelated file")
        assert latest_step(tmp_path) == 5
        assert committed_steps(tmp_path) == [5]

    def test_retention_survives_stray_tmp(self, tmp_path):
        (tmp_path / "step_00000099.tmp").mkdir()
        for step in [1, 2, 3, 4]:
            save_checkpoint(tmp_path, step, self.W, keep=2)
        assert committed_steps(tmp_path) == [3, 4]
        assert (tmp_path / "step_00000099.tmp").exists()  # GC's job

    def test_gc_incomplete(self, tmp_path):
        save_checkpoint(tmp_path, 5, self.W)
        (tmp_path / "step_00000007.tmp").mkdir()
        uncommitted = tmp_path / "step_00000009"
        uncommitted.mkdir()
        (uncommitted / "manifest.json").write_text("{}")
        removed = gc_incomplete(tmp_path)
        assert sorted(removed) == ["step_00000007.tmp", "step_00000009"]
        assert latest_step(tmp_path) == 5
        assert gc_incomplete(tmp_path) == []          # idempotent

    def test_checkpointer_init_sweeps_leftovers(self, tmp_path):
        save_checkpoint(tmp_path, 5, self.W)
        (tmp_path / "step_00000007.tmp").mkdir()
        Checkpointer(tmp_path)
        assert not (tmp_path / "step_00000007.tmp").exists()
        (tmp_path / "step_00000008.tmp").mkdir()
        Checkpointer(tmp_path, gc_on_init=False)
        assert (tmp_path / "step_00000008.tmp").exists()

    def test_async_write_failure_surfaces_and_stays_invisible(
            self, tmp_path, monkeypatch):
        ck = Checkpointer(tmp_path)
        ck.save_async(1, self.W)
        ck.wait()
        real = tck._write_shards

        def broken(*a, **kw):
            raise OSError("disk full")

        monkeypatch.setattr(tck, "_write_shards", broken)
        ck.save_async(2, self.W)
        with pytest.raises(OSError, match="disk full"):
            ck.wait()
        monkeypatch.setattr(tck, "_write_shards", real)
        assert latest_step(tmp_path) == 1     # step 2 never committed
        ck.save_async(3, self.W)              # the error was consumed
        ck.wait()
        assert latest_step(tmp_path) == 3


# ---------------------------------------------------------------------------
# the format across the packages
# ---------------------------------------------------------------------------

F_DIM, K, B_I, C = 16, 12, 3, 3
MODES = ("regen", "stored")


def ref_tree(mode):
    """The reference's linear checkpoint tree after a few steps of its
    streamed fit: (tree, pipeline)."""
    from repro.training import fit_linear_streamed as jfit
    spec = JSpec(num_hashes=K, b_i=B_I)
    key = jax.random.PRNGKey(5)
    pipe = (JPipe.create_regen(key, F_DIM, spec) if mode == "regen" else
            JPipe(jmake_cws_params(key, F_DIM, K + 4), spec))
    rng = np.random.default_rng(0)
    x = rng.random((24, F_DIM)).astype(np.float32)
    y = rng.integers(0, C, 24).astype(np.int32)
    cfg = jlm.TrainCfg(n_classes=C, steps=3, batch_size=8, lr=0.05)
    p0 = jlm.init_bag(jax.random.PRNGKey(1), pipe.num_features, C)
    params, state = jfit(p0, pipe, x, y, cfg=cfg, return_state=True)
    return {"params": params, "opt_state": state,
            "pipeline": pipe._state()}, pipe


def port_of(jtree, mode):
    """The reference's tree carried into the port by ``interop``."""
    p = jtree["params"]
    launch = jtree["pipeline"]
    launch = (np.asarray(launch, np.uint32) if mode == "regen" else
              interop.cws_params(launch.r, launch.log_c, launch.beta,
                                 device=CPU))
    return {"params": interop.linear_params(p.w, p.b, device=CPU),
            "opt_state": interop.linear_opt_state(
                jax.tree_util.tree_map(np.asarray, jtree["opt_state"]),
                device=CPU),
            "pipeline": launch}


def as_np(a) -> np.ndarray:
    """A leaf of either package as numpy (uint32 tensors through int32)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.uint32:
            return a.view(torch.int32).numpy().view(np.uint32)
        return a.numpy()
    return np.asarray(a)


def assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = as_np(a), as_np(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_leaf_names_equal_tree_paths(mode):
    jtree, _ = ref_tree(mode)
    assert tree_paths(port_of(jtree, mode)) == jck._tree_paths(jtree)


@pytest.mark.parametrize("mode", MODES)
def test_manifest_and_index_equal_the_references(mode, tmp_path):
    jtree, _ = ref_tree(mode)
    extra = {"stream": {"next_step": 3}}
    jck.save_checkpoint(tmp_path / "ref", 3, jtree, extra=extra)
    save_checkpoint(tmp_path / "port", 3, port_of(jtree, mode), extra=extra)
    read = lambda who, f: json.loads(
        (tmp_path / who / "step_00000003" / f).read_text())
    jm, tm = read("ref", "manifest.json"), read("port", "manifest.json")
    assert sorted(tm) == sorted(jm) == ["extra", "leaves", "n_processes",
                                        "step"]
    assert tm == jm
    assert read("port", "index_p0.json") == read("ref", "index_p0.json")
    with np.load(tmp_path / "ref" / "step_00000003" / "shard_p0.npz") as a, \
            np.load(tmp_path / "port" / "step_00000003" / "shard_p0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize("mode", MODES)
def test_port_restores_the_references_checkpoint(mode, tmp_path):
    jtree, _ = ref_tree(mode)
    jck.save_checkpoint(tmp_path, 3, jtree)
    carried = port_of(jtree, mode)
    back = restore_checkpoint(tmp_path, 3, specs(carried),
                              device=CPU)
    assert tree_paths(back) == jck._tree_paths(jtree)
    got = [t for _, t in leaves(back)]
    assert_leaves_equal(got, [t for _, t in leaves(carried)])
    assert_leaves_equal(got, jax.tree_util.tree_leaves(jtree))
    # the trainer's own template: (params, opt state) as meta tensors
    p0 = tlm.init_bag(jtree["params"].w.shape[0], C, device="meta")
    tx = tlm.make_linear_tx(tlm.TrainCfg(n_classes=C))
    part = restore_checkpoint(tmp_path, 3,
                              {"params": p0, "opt_state": tx.init(p0)},
                              device=CPU)
    tree_eq(part, {"params": carried["params"],
                   "opt_state": carried["opt_state"]})


@pytest.mark.parametrize("mode", MODES)
def test_reference_restores_the_ports_checkpoint(mode, tmp_path):
    jtree, _ = ref_tree(mode)
    carried = port_of(jtree, mode)
    save_checkpoint(tmp_path, 3, carried)
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jtree)
    back = jck.restore_checkpoint(tmp_path, 3, template)
    assert_leaves_equal(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jtree))


def two_slice_checkpoint(path, w):
    """``{"w": w}`` saved by the port with ``w`` split into two row
    slices in one shard file."""
    manifest, shards = tck._extract_shards(4, {"w": w}, None)
    (_, arr, dtype), = shards.values()
    cut = arr.shape[0] // 3
    shards = {"['w']::0": ([[0, cut], [0, arr.shape[1]]], arr[:cut], dtype),
              "['w']::1": ([[cut, arr.shape[0]], [0, arr.shape[1]]],
                           arr[cut:], dtype)}
    tck._write_shards(path, 4, manifest, shards, keep=3)


def test_two_slice_leaf_reassembles_in_both(tmp_path):
    w = torch.randn(10, 3, generator=torch.Generator().manual_seed(1))
    two_slice_checkpoint(tmp_path, w)
    index = json.loads((tmp_path / "step_00000004" /
                        "index_p0.json").read_text())
    assert len(index) == 2
    back = restore_checkpoint(tmp_path, 4, {"w": ((10, 3), torch.float32)},
                              device=CPU)
    assert torch.equal(back["w"], w)
    jback = jck.restore_checkpoint(
        tmp_path, 4, {"w": jax.ShapeDtypeStruct((10, 3), jnp.float32)})
    np.testing.assert_array_equal(np.asarray(jback["w"]), w.numpy())


def test_bfloat16_round_trips_both_ways(tmp_path):
    vals = np.array([[1.0, -2.5, 3.140625], [1e-3, 65280.0, -0.0]],
                    np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    save_checkpoint(tmp_path / "port", 1, {"h": t})
    meta = json.loads((tmp_path / "port" / "step_00000001" /
                       "index_p0.json").read_text())
    assert meta["['h']::0"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "port" / "step_00000001" / "shard_p0.npz") as z:
        assert z["a0"].dtype == np.uint16
    j = jck.restore_checkpoint(
        tmp_path / "port", 1, {"h": jax.ShapeDtypeStruct((2, 3),
                                                         jnp.bfloat16)})
    assert j["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(j["h"], np.float32),
                                  t.float().numpy())
    jck.save_checkpoint(tmp_path / "ref", 1,
                        {"h": jnp.asarray(vals, jnp.bfloat16)})
    back = restore_checkpoint(tmp_path / "ref", 1,
                              {"h": ((2, 3), torch.bfloat16)}, device=CPU)
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"], t)


def test_port_tree_types_name_like_the_references():
    """The port's own tree types: dict keys sorted, a NamedTuple's fields,
    tuple positions, and dataclass children by flat index."""
    z = torch.zeros(1)
    tree = {"b": (z, tlm.LinearParams(z, z)),
            "a": topt.AdamState(mu=z, nu=[z]),
            "c": CWSParams(z, z, z)}
    assert tree_paths(tree) == [
        "['a']/[<flat index 0>]", "['a']/[<flat index 1>]/[0]",
        "['b']/[0]", "['b']/[1]/.w", "['b']/[1]/.b",
        "['c']/[<flat index 0>]", "['c']/[<flat index 1>]",
        "['c']/[<flat index 2>]"]
