"""Port parity: the LM training driver (``repro_torch.launch.train``),
its resume, and LM checkpoints across the packages, on the CPU.

``build_trainer`` is the reference's (the reference's own fails in its
mesh under jax 0.9.0, ``tests/test_trainer_integration.py``), so its
resume is held in the port alone: 10 steps, a resume to 20, against 20
uninterrupted, bit for bit (the CPU step is deterministic: the
embedding's backward sums in a fixed order).  Across the packages a
``TrainState`` checkpointed by one at step 3 (with the loader's snapshot)
is resumed by the other to step 6 and held against the other package's
uninterrupted run, with int8 compression on so the error-feedback
residual crosses too: parameters within ``lr`` a step (an int8 code that
rounds the other way moves an element's Adam step by up to ``lr``,
``tests/test_torch_lm_train.py``), and the first moment and the residual
within fp32 sums but for such flipped codes, each off by at most one
quantization step (twice the leaf's largest residual; a tenth of that in
the moment), on at most 1% of a leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.data.loader import TokenBatchLoader
from repro.training import trainer as ref_trainer
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer, tree_paths
from repro_torch.launch import train as t_train
from repro_torch.optim import tree_leaves
from repro_torch.training import trainer as t_trainer

LR = 1e-3
FP32_TOL = 1e-5
FLIP_FRACTION = 0.01


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: PyTorch's default count spins badly when
    several test processes (and XLA's threads) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    return (dataclasses.replace(ref_configs.get_config(arch, "smoke"), **over),
            dataclasses.replace(t_configs.get_config(arch, "smoke"), **over))


def _hps(**over):
    kw = dict(lr=LR, warmup=2, total_steps=30, **over)
    return ref_trainer.TrainHparams(**kw), t_trainer.TrainHparams(**kw)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batches(vocab, n, batch, seq=128):
    ld = TokenBatchLoader(vocab=vocab, global_batch=batch, seq_len=seq)
    return [next(ld) for _ in range(n)]


def _close_tree(got, want, atol):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol)


def _close_but_flips(got, want):
    """Each leaf within fp32 sums of the other's, but for at most
    FLIP_FRACTION of its elements, each within twice the leaf's largest
    magnitude (one quantization step of a residual)."""
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = g.numpy(), np.asarray(w, np.float32)
        top = np.abs(w).max()
        off = np.abs(g - w) > FP32_TOL * (1.0 + top)
        assert off.mean() <= FLIP_FRACTION, off.mean()
        assert np.abs(g - w).max() <= 2.01 * top


def _run_steps(cfg, hp, n, ckpt_dir=None):
    """The reference test's ``_run_steps`` on the port's ``build_trainer``:
    checkpoints every 5 steps with the loader's snapshot."""
    build, ck, _ = t_train.build_trainer(cfg, hp, global_batch=4,
                                         seq_len=32, ckpt_dir=ckpt_dir,
                                         device="cpu")
    state, loader, step_fn, start = build()
    losses = []
    for step in range(start, n):
        state, metrics = step_fn(state, next(loader))
        losses.append(float(metrics["loss"]))
        if ck is not None and (step + 1) % 5 == 0:
            ck.save_async(step + 1, state,
                          extra={"loader": loader.snapshot()})
    if ck is not None:
        ck.wait()
    return state, losses


def test_build_trainer_resume_is_bit_identical(tmp_path):
    _, tc = _cfgs("starcoder2_7b")
    _, ht = _hps()
    full, losses = _run_steps(tc, ht, 20, tmp_path / "a")
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    _run_steps(tc, ht, 10, tmp_path / "b")
    resumed, rest = _run_steps(tc, ht, 20, tmp_path / "b")
    assert rest == losses[10:]
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_driver_main_logs_stops_and_resumes(tmp_path, capsys):
    argv = ["--arch", "gemma3_12b", "--steps", "6", "--global-batch", "2",
            "--seq-len", "32", "--log-every", "2", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    t_train.main(argv + ["--stop-at", "4"])
    log = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in log[:-1]] == [["step", "2"],
                                                      ["step", "4"]]
    assert log[-1] == "done" and "gnorm" in log[0] and "tok/s" in log[0]
    state = t_train.main(argv)
    assert int(state.step) == 6
    assert capsys.readouterr().out.splitlines()[0].split()[:2] == \
        ["step", "6"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_resume(writer, tmp_path):
    """A run of one package checkpointed at step 3 (loader snapshot in
    ``extra["loader"]``), resumed by the other to step 6: within the fp32
    tolerances of the other package's uninterrupted run."""
    rc, tc = _cfgs("gemma3_12b")
    hr, ht = _hps(compress_grads=True)
    rs0 = ref_trainer.init_train_state(jax.random.PRNGKey(0), rc, hr)
    step_r = jax.jit(ref_trainer.make_train_step(rc, hr, None))
    step_t = t_trainer.make_train_step(tc, ht)
    batches = _batches(rc.vocab, 6, batch=2)
    assert tree_paths(interop.lm_train_state(rs0, tc, device="cpu")) == \
        _ref_paths(rs0)
    jb = [{"inputs": jnp.asarray(x), "labels": jnp.asarray(y)}
          for x, y in batches]
    tb = [{"inputs": torch.from_numpy(x), "labels": torch.from_numpy(y)}
          for x, y in batches]
    extra = {"loader": {"step": 3, "seed": 0}}
    if writer == "reference":
        rs = rs0
        for b in jb[:3]:
            rs, _ = step_r(rs, b)
        ck = RefCheckpointer(tmp_path)
        ck.save_async(3, rs, extra=extra)
        ck.wait()
        template = t_trainer.init_train_state(tc, ht, device="meta")
        ts, manifest = Checkpointer(tmp_path).restore_latest(template,
                                                             device="cpu")
        assert manifest["step"] == 3 and manifest["extra"] == extra
        for b in tb[manifest["extra"]["loader"]["step"]:]:
            ts, _ = step_t(ts, b)
        want = rs0
        for b in jb:
            want, _ = step_r(want, b)
        got = ts
    else:
        ts = interop.lm_train_state(rs0, tc, device="cpu")
        for b in tb[:3]:
            ts, _ = step_t(ts, b)
        ck = Checkpointer(tmp_path)
        ck.save_async(3, ts, extra=extra)
        ck.wait()
        template = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), rs0)
        rs, manifest = RefCheckpointer(tmp_path).restore_latest(template)
        assert manifest["step"] == 3 and manifest["extra"] == extra
        for b in jb[3:]:
            rs, _ = step_r(rs, b)
        want = _np(rs)
        got = interop.lm_train_state(rs0, tc, device="cpu")
        for b in tb:
            got, _ = step_t(got, b)
    assert int(got.step) == int(want.step) == 6
    _close_tree(got.params, want.params, atol=LR * 6)
    _close_but_flips(got.mu, want.mu)
    _close_but_flips(got.ef_residual, want.ef_residual)


def _ref_paths(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return ["/".join(str(k) for k in path) for path, _ in flat]
