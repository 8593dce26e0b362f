"""Port parity: chaos tests of preemption-grade streamed training
(``tests/test_chaos.py``'s counterparts, the mesh reshards over gloo
ranks included: ``TestElasticReshard``).

Kill a streamed run at an exact point, resume it, and demand bit-identity
with the uninterrupted run: the port's gradient is deterministic and its
shuffle is the reference's, so a resumed run takes the same rows with the
same state at every step.  On the reference tests' problem at their
sizes: ``make_template_classification(3, ...)`` (160 train /
80 test rows, D = 32, 3 classes), ``make_cws_params_jax(prng_key(7), 32,
24)`` at b_i = 4, ``row_chunk=32`` (the evaluation walks 3 chunks), 40
steps of 32 rows.  Hang faults and hard timeouts keep the reference
tests' values, so no test waits past 60 s if the watchdog fails.

Across the packages, on the reference's own rows and CWS matrices (carried
over by ``interop``, so the pipeline fingerprints agree): the manifest's
``extra.stream`` equals the reference's for the same run, each package
resumes the other's step-20 checkpoint and lands within ``ACC_PP`` of the
other's uninterrupted accuracy, and the evaluation's table digest and
checkpoint agree.
"""
import dataclasses
import json
import time

import jax
import pytest
import torch

from repro.checkpoint import latest_step as jlatest_step
from repro.core import linear_model as jlm
from repro.data.synthetic import \
    make_template_classification as jmake_template_classification
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro.runtime import ChaosKill as JChaosKill
from repro.runtime import ChaosPlan as JChaosPlan
from repro.runtime import kill_at as jkill_at
from repro.training import fit_linear_streamed as jfit_streamed
from repro.training import linear_trainer as jtrainer
from repro.training import resume_linear_streamed as jresume
from repro.training import resume_streamed_accuracy as jresume_accuracy
from repro.training import streamed_accuracy as jstreamed_accuracy
from repro_torch import interop
from repro_torch.checkpoint import (Checkpointer, committed_steps,
                                    gc_incomplete, latest_step,
                                    save_checkpoint)
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.core.cws import make_cws_params_jax
from repro_torch.core.linear_model import TrainCfg, init_bag
from repro_torch.core.regen import prng_key
from repro_torch.data.synthetic import make_template_classification
from repro_torch.optim import tree_leaves
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.runtime import (ChaosKill, ChaosPlan, FaultInjected,
                                 RetryingTrainer, StepWatchdog,
                                 TrainingAborted, fail_async_write, hang_at,
                                 kill_at, kill_between_snapshot_and_commit,
                                 kill_eval_at, raise_at)
from repro_torch.training import (checkpoint_tree, fit_linear_streamed,
                                  fit_linear_streamed_resilient,
                                  resume_linear_streamed,
                                  resume_streamed_accuracy,
                                  streamed_accuracy)
from repro_torch.training import linear_trainer as ttrainer

ACC_PP = 3.75          # tests/test_torch_linear_train.py: 3 of 80 rows
DATA = dict(n_train=160, n_test=80, dim=32, n_classes=3, mult_noise=1.1,
            spike_prob=0.02, density=0.3)
CFG = dict(n_classes=3, steps=40, batch_size=32, lr=0.05)


def tree_eq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def make_pipe(packed=False, seed=7):
    return FeaturePipeline(make_cws_params_jax(prng_key(seed), 32, 24),
                           FeatureSpec(24, 4, packed=packed), row_chunk=32)


@pytest.fixture(scope="module")
def problem():
    ds = make_template_classification(3, **DATA)
    pipe = make_pipe()
    cfg = TrainCfg(**CFG)
    p0 = init_bag(pipe.num_features, 3, device="cpu")
    return ds, pipe, cfg, p0


@pytest.fixture(scope="module")
def clean_run(problem):
    """The uninterrupted run: (params, opt_state), no faults, no
    checkpoints."""
    ds, pipe, cfg, p0 = problem
    return fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                               return_state=True)


def killed_fit(problem, path, kill, every=5, **kw):
    ds, pipe, cfg, p0 = problem
    ck = Checkpointer(path)
    with pytest.raises(ChaosKill):
        fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                            ckpt=ck, ckpt_every=every,
                            chaos=ChaosPlan(kill_at(kill)), **kw)
    ck.join()


class TestKillResume:
    def test_kill_mid_epoch_resume_bit_identical(self, problem, clean_run,
                                                 tmp_path):
        """Killed at step 17 (mid-epoch: 5 steps an epoch), resumed from
        15: params and both Adam moments equal the uninterrupted run's."""
        ds, pipe, cfg, _ = problem
        killed_fit(problem, tmp_path, 17)
        assert latest_step(tmp_path) == 15
        params, state = resume_linear_streamed(
            tmp_path, pipe, ds.x_train, ds.y_train, cfg=cfg,
            return_state=True)
        tree_eq(clean_run[0], params)
        tree_eq(clean_run[1], state)

    def test_resume_mid_epoch_checkpoint(self, problem, clean_run,
                                         tmp_path):
        ds, pipe, cfg, _ = problem
        killed_fit(problem, tmp_path, 8, every=3)
        assert latest_step(tmp_path) == 6     # epoch 1, pos 1: mid-epoch
        params = resume_linear_streamed(tmp_path, pipe, ds.x_train,
                                        ds.y_train, cfg=cfg)
        tree_eq(clean_run[0], params)

    def test_resumed_run_keeps_checkpointing(self, problem, tmp_path):
        ds, pipe, cfg, _ = problem
        killed_fit(problem, tmp_path, 17)
        resume_linear_streamed(tmp_path, pipe, ds.x_train, ds.y_train,
                               cfg=cfg, ckpt_every=5)
        assert latest_step(tmp_path) == cfg.steps

    def test_checkpoint_tree_is_what_the_fit_writes(self, problem,
                                                    clean_run, tmp_path):
        """``checkpoint_tree`` (the tree a benchmark saves by hand) names
        and shapes its leaves as the streamed fit's checkpoints do."""
        ds, pipe, cfg, p0 = problem
        killed_fit(problem, tmp_path, 17)
        manifest = json.loads((tmp_path / "step_00000015" /
                               "manifest.json").read_text())
        tree = checkpoint_tree(*clean_run, pipe)
        assert [(l["name"], l["shape"], l["dtype"])
                for l in manifest["leaves"]] == [
            (name, list(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in tck._flatten(tree)]

    def test_kill_resume_single_chunk_shape(self, problem, tmp_path,
                                            monkeypatch):
        """Both legs launch the encode at the one (batch_size, D) shape:
        surviving a kill changes no launch (the port has no compile cache;
        the shapes stand for the reference's one compile)."""
        ds, _, cfg, _ = problem
        pipe = make_pipe(seed=11)
        shapes = []
        real = pipe._launch_with
        monkeypatch.setattr(pipe, "_launch_with", lambda x, s: (
            shapes.append(tuple(x.shape)), real(x, s))[1])
        p0 = init_bag(pipe.num_features, 3, device="cpu")
        ck = Checkpointer(tmp_path)
        with pytest.raises(ChaosKill):
            fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                ckpt=ck, ckpt_every=5,
                                chaos=ChaosPlan(kill_at(17)))
        ck.join()
        resume_linear_streamed(tmp_path, pipe, ds.x_train, ds.y_train,
                               cfg=cfg)
        assert set(shapes) == {(cfg.batch_size, 32)}
        assert len(shapes) == 17 + cfg.steps - 15

    def test_mismatch_guards(self, problem, tmp_path):
        ds, pipe, cfg, _ = problem
        killed_fit(problem, tmp_path, 17)
        other = make_pipe(seed=99)
        with pytest.raises(ValueError, match="fingerprint"):
            resume_linear_streamed(tmp_path, other, ds.x_train, ds.y_train,
                                   cfg=cfg)
        with pytest.raises(ValueError, match="TrainCfg"):
            resume_linear_streamed(tmp_path, pipe, ds.x_train, ds.y_train,
                                   cfg=dataclasses.replace(cfg, lr=0.1))
        with pytest.raises(ValueError, match="rows"):
            resume_linear_streamed(tmp_path, pipe, ds.x_train[:128],
                                   ds.y_train[:128], cfg=cfg)
        with pytest.raises(ValueError, match="n_microbatches"):
            resume_linear_streamed(tmp_path, pipe, ds.x_train, ds.y_train,
                                   cfg=cfg, n_microbatches=2)
        with pytest.raises(ValueError, match="shuffle_key"):
            resume_linear_streamed(tmp_path, pipe, ds.x_train, ds.y_train,
                                   cfg=cfg, shuffle_key=prng_key(5))

    def test_resume_empty_dir_raises(self, problem, tmp_path):
        ds, pipe, cfg, _ = problem
        with pytest.raises(FileNotFoundError, match="no committed"):
            resume_linear_streamed(tmp_path, pipe, ds.x_train, ds.y_train,
                                   cfg=cfg)

    def test_fresh_fit_refuses_used_dir(self, problem, tmp_path):
        ds, pipe, cfg, p0 = problem
        save_checkpoint(tmp_path, 5, {"w": torch.zeros(3)})
        with pytest.raises(ValueError, match="resume_linear_streamed"):
            fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                ckpt=tmp_path, ckpt_every=5)

    def test_packed_kill_resume_bit_identical(self, problem, tmp_path):
        """The packed pipeline (TPU row 4's path): killed at 17 and
        resumed, bit-identical to its own uninterrupted run."""
        ds, _, cfg, p0 = problem
        pipe = make_pipe(packed=True)
        clean = fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train,
                                    cfg=cfg, return_state=True)
        ck = Checkpointer(tmp_path)
        with pytest.raises(ChaosKill):
            fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                ckpt=ck, ckpt_every=5,
                                chaos=ChaosPlan(kill_at(17)))
        ck.join()
        got = resume_linear_streamed(tmp_path, pipe, ds.x_train,
                                     ds.y_train, cfg=cfg, return_state=True)
        tree_eq(clean[0], got[0])
        tree_eq(clean[1], got[1])


class TestCommitWindow:
    def _killed_fit(self, problem, tmp_path, phase):
        ds, pipe, cfg, p0 = problem
        plan = ChaosPlan(kill_between_snapshot_and_commit(10, phase=phase))
        ck = Checkpointer(tmp_path, chaos=plan)
        # the writer dies inside step 10's commit window; the main loop
        # raises it at the next save's wait()
        with pytest.raises(ChaosKill):
            fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                ckpt=ck, ckpt_every=5)
        ck.join()

    def test_kill_pre_commit_invisible_and_resumable(self, problem,
                                                     clean_run, tmp_path):
        self._killed_fit(problem, tmp_path, "pre_commit")
        assert (tmp_path / "step_00000010").exists()
        assert not (tmp_path / "step_00000010" / "COMMIT").exists()
        assert latest_step(tmp_path) == 5
        ds, pipe, cfg, _ = problem
        params = resume_linear_streamed(tmp_path, pipe, ds.x_train,
                                        ds.y_train, cfg=cfg)
        tree_eq(clean_run[0], params)

    def test_kill_pre_rename_leaves_tmp_not_a_crash(self, problem,
                                                    clean_run, tmp_path):
        self._killed_fit(problem, tmp_path, "pre_rename")
        assert (tmp_path / "step_00000010.tmp").exists()
        assert latest_step(tmp_path) == 5
        Checkpointer(tmp_path)            # a restart sweeps the leftover
        assert not (tmp_path / "step_00000010.tmp").exists()
        ds, pipe, cfg, _ = problem
        params = resume_linear_streamed(tmp_path, pipe, ds.x_train,
                                        ds.y_train, cfg=cfg)
        tree_eq(clean_run[0], params)

    def test_legacy_tmp_with_commit_regression(self, tmp_path):
        save_checkpoint(tmp_path, 5, {"w": torch.ones(4)})
        bad = tmp_path / "step_00000007.tmp"
        bad.mkdir()
        (bad / "COMMIT").write_text("1.0")
        assert latest_step(tmp_path) == 5
        assert committed_steps(tmp_path) == [5]
        assert gc_incomplete(tmp_path) == ["step_00000007.tmp"]
        assert latest_step(tmp_path) == 5


class TestAsyncWriteFailure:
    def test_error_surfaces_on_next_call_and_step_stays_invisible(
            self, tmp_path):
        plan = ChaosPlan(fail_async_write(5))
        ck = Checkpointer(tmp_path, chaos=plan)
        tree = {"w": torch.arange(8, dtype=torch.float32)}
        ck.save_async(3, tree)
        ck.wait()
        ck.save_async(5, tree)           # the writer raises OSError
        with pytest.raises(OSError, match="injected write failure"):
            ck.save_async(7, tree)       # raised here, not swallowed
        assert latest_step(tmp_path) == 3
        ck.save_async(7, tree)           # cleared once raised
        ck.wait()
        assert latest_step(tmp_path) == 7

    def test_resilient_survives_failed_write(self, problem, clean_run,
                                             tmp_path):
        ds, pipe, cfg, p0 = problem
        tr = RetryingTrainer(backoff_s=0.0)
        params = fit_linear_streamed_resilient(
            p0, pipe, ds.x_train, ds.y_train, cfg=cfg, ckpt=tmp_path,
            ckpt_every=5, trainer=tr, chaos=ChaosPlan(fail_async_write(10)))
        tree_eq(clean_run[0], params)
        assert [e["error"] for e in tr.restart_log] == ["OSError"]


class TestWatchdogMidStep:
    def test_fires_without_end_step(self):
        fired = []
        wd = StepWatchdog(hard_timeout_s=0.15, on_timeout=fired.append)
        with wd:
            wd.start_step()
            time.sleep(0.6)              # the hang: no end_step yet
            assert fired and fired[0] >= 0.15
            assert wd.fired["kind"] == "hard_timeout"
            assert wd.fired["step"] == 0
            with pytest.raises(TrainingAborted):
                wd.end_step()            # limping home still aborts

    def test_sigint_interrupts_hung_main_thread(self):
        wd = StepWatchdog(hard_timeout_s=0.2)
        t0 = time.monotonic()
        with wd, pytest.raises(TrainingAborted):
            wd.start_step()
            try:
                time.sleep(30.0)         # a hung step
                pytest.fail("watchdog never interrupted the hang")
            except KeyboardInterrupt as e:
                wd.reraise_if_fired(e)
                raise
        assert time.monotonic() - t0 < 10.0

    def test_real_ctrl_c_not_swallowed(self):
        wd = StepWatchdog(hard_timeout_s=30.0)
        with wd:
            wd.start_step()
            wd.reraise_if_fired(KeyboardInterrupt())   # no fire: returns
            wd.end_step()

    def test_hung_training_step_detected_and_resumed(self, problem,
                                                     clean_run, tmp_path):
        """Step 7 hangs for 60 s; the watchdog aborts it within seconds
        and the resumed run is bit-identical."""
        ds, pipe, cfg, p0 = problem
        wd = StepWatchdog(hard_timeout_s=3.0)
        t0 = time.monotonic()
        with pytest.raises(TrainingAborted):
            fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                                ckpt=tmp_path, ckpt_every=5, watchdog=wd,
                                chaos=ChaosPlan(hang_at(7, 60.0)))
        assert time.monotonic() - t0 < 30.0   # not the 60 s hang
        assert wd.fired is not None and wd.fired["step"] == 7
        assert latest_step(tmp_path) == 5
        params = resume_linear_streamed(tmp_path, pipe, ds.x_train,
                                        ds.y_train, cfg=cfg)
        tree_eq(clean_run[0], params)


class TestRetryingTrainer:
    def test_exponential_backoff_and_structured_log(self):
        sleeps = []
        tr = RetryingTrainer(max_restarts=5, backoff_s=0.5,
                             backoff_factor=2.0, sleep_fn=sleeps.append)
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= 3:
                raise RuntimeError(f"boom {calls[0]}")
            return "done"

        assert tr.call(fn) == "done"
        assert sleeps == [0.5, 1.0, 2.0]
        assert [e["restart"] for e in tr.restart_log] == [1, 2, 3]
        assert all(e["error"] == "RuntimeError" and not e["gave_up"]
                   and "boom" in e["message"] for e in tr.restart_log)

    def test_backoff_is_capped(self):
        sleeps = []
        tr = RetryingTrainer(max_restarts=6, backoff_s=1.0,
                             max_backoff_s=4.0, sleep_fn=sleeps.append)
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= 5:
                raise RuntimeError("x")
            return 1

        tr.call(fn)
        assert sleeps == [1.0, 2.0, 4.0, 4.0, 4.0]

    def test_gives_up_after_max_restarts(self):
        events = []
        tr = RetryingTrainer(max_restarts=2, backoff_s=0.0,
                             on_restart=events.append,
                             sleep_fn=lambda s: None)
        with pytest.raises(RuntimeError, match="always"):
            tr.call(lambda: (_ for _ in ()).throw(RuntimeError("always")))
        assert len(events) == 3 and events[-1]["gave_up"]

    def test_training_aborted_is_restartable(self):
        tr = RetryingTrainer(backoff_s=0.0, sleep_fn=lambda s: None)
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] == 1:
                raise TrainingAborted("hung step")
            return "recovered"

        assert tr.call(fn) == "recovered"
        assert tr.restart_log[0]["error"] == "TrainingAborted"

    def test_chaoskill_is_not_survivable(self):
        tr = RetryingTrainer(backoff_s=0.0, sleep_fn=lambda s: None)

        def fn():
            raise ChaosKill("preempted")

        with pytest.raises(ChaosKill):
            tr.call(fn)
        assert tr.restart_log == []

    def test_run_drives_build_fn_and_restarts(self):
        """The generic loop: a step that raises rebuilds from the build
        function (the latest checkpoint's step) and finishes."""
        saved = {"step": 0}
        calls = {"build": 0}

        def build():
            calls["build"] += 1
            state = torch.tensor(float(saved["step"]))
            return state, iter(range(100)), step_fn, saved["step"]

        def step_fn(state, batch):
            if int(state) == 3 and calls["build"] == 1:
                raise FaultInjected("step 3")
            return state + 1, {"loss": state}

        def hook(step, state, metrics, loader):
            saved["step"] = step

        tr = RetryingTrainer(build, backoff_s=0.0)
        assert int(tr.run(6, hooks=(hook,))) == 6
        assert [e["step"] for e in tr.restart_log] == [3]
        assert calls["build"] == 2


class TestResilient:
    def test_software_fault_bit_identical(self, problem, clean_run,
                                          tmp_path):
        ds, pipe, cfg, p0 = problem
        tr = RetryingTrainer(backoff_s=0.0)
        params, state = fit_linear_streamed_resilient(
            p0, pipe, ds.x_train, ds.y_train, cfg=cfg, ckpt=tmp_path,
            ckpt_every=5, trainer=tr, chaos=ChaosPlan(raise_at(23)),
            return_state=True)
        tree_eq(clean_run[0], params)
        tree_eq(clean_run[1], state)
        assert [e["error"] for e in tr.restart_log] == ["FaultInjected"]

    def test_process_death_then_fresh_call_resumes(self, problem,
                                                   clean_run, tmp_path):
        ds, pipe, cfg, p0 = problem
        plan = ChaosPlan(kill_at(17))
        ck = Checkpointer(tmp_path, chaos=plan)
        with pytest.raises(ChaosKill):
            fit_linear_streamed_resilient(
                p0, pipe, ds.x_train, ds.y_train, cfg=cfg, ckpt=ck,
                ckpt_every=5, chaos=plan)
        ck.join()
        tr = RetryingTrainer(backoff_s=0.0)
        params = fit_linear_streamed_resilient(
            p0, pipe, ds.x_train, ds.y_train, cfg=cfg, ckpt=tmp_path,
            ckpt_every=5, trainer=tr, chaos=plan)
        tree_eq(clean_run[0], params)
        assert tr.restart_log == []
        assert [e["site"] for e in plan.log()] == ["step"]   # fired once


class TestEvalResume:
    def test_killed_eval_resumes_exactly(self, problem, clean_run,
                                         tmp_path):
        ds, pipe, _, _ = problem
        params = clean_run[0]
        acc_clean = streamed_accuracy(params, pipe, ds.x_test, ds.y_test)
        ck = Checkpointer(tmp_path)
        with pytest.raises(ChaosKill):
            streamed_accuracy(params, pipe, ds.x_test, ds.y_test,
                              ckpt=ck, ckpt_every=1,
                              chaos=ChaosPlan(kill_eval_at(2)))
        ck.join()
        acc = resume_streamed_accuracy(tmp_path, params, pipe, ds.x_test,
                                       ds.y_test)
        assert acc == acc_clean

    def test_eval_guards_table_digest(self, problem, clean_run, tmp_path):
        ds, pipe, _, p0 = problem
        params = clean_run[0]
        ck = Checkpointer(tmp_path)
        with pytest.raises(ChaosKill):
            streamed_accuracy(params, pipe, ds.x_test, ds.y_test,
                              ckpt=ck, ckpt_every=1,
                              chaos=ChaosPlan(kill_eval_at(2)))
        ck.join()
        with pytest.raises(ValueError, match="table digest"):
            resume_streamed_accuracy(tmp_path, p0, pipe, ds.x_test,
                                     ds.y_test)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xproblem():
    """The reference's rows, pipeline and config, and the port's pipeline
    on the same CWS matrices: (ds, jpipe, pipe, jcfg, cfg)."""
    ds = jmake_template_classification(3, **DATA)
    spec = JSpec(num_hashes=24, b_i=4)
    jpipe = JPipe.create(jax.random.PRNGKey(7), 32, spec, row_chunk=32)
    s = jpipe._state()
    pipe = FeaturePipeline(interop.cws_params(s.r, s.log_c, s.beta,
                                              device="cpu"),
                           FeatureSpec(24, 4), row_chunk=32)
    assert pipe.fingerprint() == jpipe.fingerprint()
    return ds, jpipe, pipe, jlm.TrainCfg(**CFG), TrainCfg(**CFG)


def manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "manifest.json")
                      .read_text())


def test_stream_extra_equals_the_references(xproblem, tmp_path):
    ds, jpipe, pipe, jcfg, cfg = xproblem
    jcfg10 = dataclasses.replace(jcfg, steps=10)
    cfg10 = dataclasses.replace(cfg, steps=10)
    jfit_streamed(jlm.init_bag(jax.random.PRNGKey(1), jpipe.num_features, 3),
                  jpipe, ds.x_train, ds.y_train, cfg=jcfg10,
                  ckpt=tmp_path / "ref", ckpt_every=5)
    fit_linear_streamed(init_bag(pipe.num_features, 3, device="cpu"), pipe,
                        ds.x_train, ds.y_train, cfg=cfg10,
                        ckpt=tmp_path / "port", ckpt_every=5)
    for step in (5, 10):
        jm, tm = manifest(tmp_path / "ref", step), manifest(tmp_path /
                                                            "port", step)
        assert tm["extra"] == jm["extra"]
        assert list(tm["extra"]["stream"]) == list(jm["extra"]["stream"])
        assert tm["leaves"] == jm["leaves"]


def test_each_package_resumes_the_others_checkpoint(xproblem, tmp_path):
    """Each package killed at 25 with a checkpoint at 20; the other one
    resumes it (its guards pass) and finishes within ``ACC_PP`` of the
    writer's uninterrupted accuracy."""
    ds, jpipe, pipe, jcfg, cfg = xproblem
    jp0 = jlm.init_bag(jax.random.PRNGKey(1), jpipe.num_features, 3)
    p0 = init_bag(pipe.num_features, 3, device="cpu")
    jacc = jstreamed_accuracy(
        jfit_streamed(jp0, jpipe, ds.x_train, ds.y_train, cfg=jcfg), jpipe,
        ds.x_test, ds.y_test)
    acc = streamed_accuracy(
        fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg),
        pipe, ds.x_test, ds.y_test)

    ck = Checkpointer(tmp_path / "port")
    with pytest.raises(ChaosKill):
        fit_linear_streamed(p0, pipe, ds.x_train, ds.y_train, cfg=cfg,
                            ckpt=ck, ckpt_every=20,
                            chaos=ChaosPlan(kill_at(25)))
    ck.join()
    assert jlatest_step(tmp_path / "port") == 20
    jp = jresume(tmp_path / "port", jpipe, ds.x_train, ds.y_train, cfg=jcfg,
                 shuffle_key=jax.random.PRNGKey(0))
    got = jstreamed_accuracy(jp, jpipe, ds.x_test, ds.y_test)
    assert abs(got - acc) * 100 <= ACC_PP, (got, acc)

    with pytest.raises(JChaosKill):
        jfit_streamed(jp0, jpipe, ds.x_train, ds.y_train, cfg=jcfg,
                      ckpt=tmp_path / "ref", ckpt_every=20,
                      chaos=JChaosPlan(jkill_at(25)))
    deadline = time.monotonic() + 30.0   # the reference's writer thread
    while (latest_step(tmp_path / "ref") != 20
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert latest_step(tmp_path / "ref") == 20
    p = resume_linear_streamed(tmp_path / "ref", pipe, ds.x_train,
                               ds.y_train, cfg=cfg, shuffle_key=prng_key(0))
    got = streamed_accuracy(p, pipe, ds.x_test, ds.y_test)
    assert abs(got - jacc) * 100 <= ACC_PP, (got, jacc)


def test_eval_digest_and_checkpoint_across_packages(xproblem, tmp_path):
    """The table digest of one table is the reference's, and the
    reference finishes the port's killed evaluation to its own count."""
    ds, jpipe, pipe, jcfg, _ = xproblem
    jp = jfit_streamed(jlm.init_bag(jax.random.PRNGKey(1),
                                    jpipe.num_features, 3),
                       jpipe, ds.x_train, ds.y_train,
                       cfg=dataclasses.replace(jcfg, steps=10))
    params = interop.linear_params(jp.w, jp.b, device="cpu")
    assert ttrainer._params_digest(params) == jtrainer._params_digest(jp)
    want = jstreamed_accuracy(jp, jpipe, ds.x_test, ds.y_test)
    assert streamed_accuracy(params, pipe, ds.x_test, ds.y_test) == want
    ck = Checkpointer(tmp_path)
    with pytest.raises(ChaosKill):
        streamed_accuracy(params, pipe, ds.x_test, ds.y_test, ckpt=ck,
                          ckpt_every=1, chaos=ChaosPlan(kill_eval_at(2)))
    ck.join()
    ev = manifest(tmp_path, 2)["extra"]["eval"]
    assert ev["table_digest"] == jtrainer._params_digest(jp)
    assert ev["fingerprint"] == jpipe.fingerprint()
    assert jresume_accuracy(tmp_path, jp, jpipe, ds.x_test,
                            ds.y_test) == want
    assert resume_streamed_accuracy(tmp_path, params, pipe, ds.x_test,
                                    ds.y_test) == want


# ---------------------------------------------------------------------------
# TestElasticReshard: the data axis over gloo ranks
# ---------------------------------------------------------------------------
# The reference's 8 -> 4 / 1 / 8 (a world of 8 gloo ranks fits this
# file's time: about 10 s a world): fit A's problem checkpointed every 5
# steps on 8 ranks (4 rows a rank) and killed before step 17, resumed on
# 8, 4 and 1 ranks and with no mesh.  Across the packages, on xproblem's
# rows and matrices: the port killed at 25 on 4 ranks (latest 20) and the
# reference resuming that checkpoint unsharded; the reference killed at 25
# and the port resuming its checkpoint at 4, 2 and 1 ranks.

ELASTIC_WORLDS = (8, 4, 2)


def _elastic_rank(rank, world, init, spec):
    import datetime

    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_data_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_data_mesh(world)
        ds = make_template_classification(3, **DATA)
        pipe, cfg = make_pipe(), TrainCfg(**CFG)
        p0 = init_bag(pipe.num_features, 3, device="cpu")
        res = {}

        def fit(pipe, x, y, **kw):
            return fit_linear_streamed(p0, pipe, x, y, cfg=cfg, mesh=mesh,
                                       **kw)

        if world == 8:
            clean = fit(pipe, ds.x_train, ds.y_train)
            res["clean"] = torch.cat([clean.w.reshape(-1), clean.b]).numpy()
            res["acc"] = streamed_accuracy(clean, pipe, ds.x_test, ds.y_test,
                                           mesh=mesh)
            ck = Checkpointer(spec["elastic"], mesh=mesh)
            try:
                fit(pipe, ds.x_train, ds.y_train, ckpt=ck, ckpt_every=5,
                    chaos=ChaosPlan(kill_at(17)))
            except ChaosKill:
                res["killed"] = True
            ck.join()
            res["latest"] = latest_step(spec["elastic"])
            again = resume_linear_streamed(spec["elastic"], pipe, ds.x_train,
                                           ds.y_train, cfg=cfg, mesh=mesh)
            res["resumed"] = torch.cat([again.w.reshape(-1),
                                        again.b]).numpy()
        else:
            if world == 4:
                p = resume_linear_streamed(spec["elastic"], pipe, ds.x_train,
                                           ds.y_train, cfg=cfg, mesh=mesh)
                res["acc"] = streamed_accuracy(p, pipe, ds.x_test, ds.y_test,
                                               mesh=mesh)
            x = spec["xdata"]
            xpipe = FeaturePipeline(interop.cws_params(*spec["xparams"],
                                                       device="cpu"),
                                    FeatureSpec(24, 4), row_chunk=32)
            if world == 4:
                ck = Checkpointer(spec["port4"], mesh=mesh)
                try:
                    fit(xpipe, x[0], x[1], ckpt=ck, ckpt_every=20,
                        chaos=ChaosPlan(kill_at(25)))
                except ChaosKill:
                    res["killed"] = True
                ck.join()
            p = resume_linear_streamed(spec["ref"], xpipe, x[0], x[1],
                                       cfg=cfg, mesh=mesh,
                                       shuffle_key=prng_key(0))
            res["xacc"] = streamed_accuracy(p, xpipe, x[2], x[3], mesh=mesh)
        np.save(f"{spec['out']}/{world}_{rank}.npy", res, allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def elastic(xproblem, tmp_path_factory):
    """Every rank's results of the three worlds, the reference's killed
    checkpoint, and the port's 4-rank one."""
    import numpy as np
    import torch.multiprocessing as mp
    ds, jpipe, _, jcfg, _ = xproblem
    d = tmp_path_factory.mktemp("elastic")
    jp0 = jlm.init_bag(jax.random.PRNGKey(1), jpipe.num_features, 3)
    with pytest.raises(JChaosKill):
        jfit_streamed(jp0, jpipe, ds.x_train, ds.y_train, cfg=jcfg,
                      ckpt=d / "ref", ckpt_every=20,
                      chaos=JChaosPlan(jkill_at(25)))
    deadline = time.monotonic() + 30.0   # the reference's writer thread
    while latest_step(d / "ref") != 20 and time.monotonic() < deadline:
        time.sleep(0.05)
    s = jpipe._state()
    spec = {"elastic": str(d / "elastic"), "port4": str(d / "port4"),
            "ref": str(d / "ref"), "out": str(d),
            "xdata": (ds.x_train, ds.y_train, ds.x_test, ds.y_test),
            "xparams": tuple(np.asarray(m) for m in (s.r, s.log_c, s.beta))}
    for world in ELASTIC_WORLDS:
        mp.spawn(_elastic_rank, args=(world, f"file://{d}/rdv{world}", spec),
                 nprocs=world, join=True)
    ranks = {w: [np.load(d / f"{w}_{r}.npy", allow_pickle=True).item()
                 for r in range(w)] for w in ELASTIC_WORLDS}
    return ranks, d


class TestElasticReshard:
    """Checkpointed at 8 ranks, resumed at 4 / 1 / 8: the checkpoint holds
    each leaf once, written as 8 processes' row slices, and restore
    reads it onto whatever mesh exists now.  The same rank count resumes
    bit-identically; across rank counts only the gradient's order of
    summation differs, and the final accuracy must not."""

    def test_checkpoint_written_by_every_rank(self, elastic):
        ranks, d = elastic
        assert all(r["killed"] and r["latest"] == 15 for r in ranks[8])
        step = d / "elastic" / "step_00000015"
        names = sorted(p.name for p in step.iterdir())
        assert names == sorted(["COMMIT", "manifest.json"]
                               + [f"shard_p{i}.npz" for i in range(8)]
                               + [f"index_p{i}.json" for i in range(8)])
        assert json.loads((step / "manifest.json").read_text())[
            "n_processes"] == 8

    def test_resume_same_mesh_bit_identical(self, elastic):
        ranks, _ = elastic
        import numpy as np
        for r in ranks[8]:
            np.testing.assert_array_equal(r["resumed"], r["clean"])
            np.testing.assert_array_equal(r["clean"], ranks[8][0]["clean"])

    @pytest.mark.parametrize("ndev", [4, 1])
    def test_resume_fewer_devices_equal_accuracy(self, elastic, problem,
                                                 ndev):
        """8 -> 4 (gloo ranks) and 8 -> 1 (a one-rank mesh, no process
        group) finish the run at the 8-rank accuracy exactly."""
        from repro_torch.launch.mesh import make_data_mesh
        ranks, d = elastic
        acc8 = ranks[8][0]["acc"]
        if ndev == 4:
            assert [r["acc"] for r in ranks[4]] == [acc8] * 4
            return
        ds, pipe, cfg, _ = problem
        mesh = make_data_mesh(1)
        p = resume_linear_streamed(d / "elastic", pipe, ds.x_train,
                                   ds.y_train, cfg=cfg, mesh=mesh)
        assert streamed_accuracy(p, pipe, ds.x_test, ds.y_test,
                                 mesh=mesh) == acc8

    def test_resume_on_unsharded_path(self, elastic, problem):
        ranks, d = elastic
        ds, pipe, cfg, _ = problem
        p = resume_linear_streamed(d / "elastic", pipe, ds.x_train,
                                   ds.y_train, cfg=cfg)
        assert streamed_accuracy(p, pipe, ds.x_test,
                                 ds.y_test) == ranks[8][0]["acc"]

    def test_reference_resumes_the_ports_4_rank_checkpoint(self, elastic,
                                                           xproblem):
        """The port killed at 25 on 4 ranks (latest 20, four processes'
        files); the reference, unsharded, resumes it within ``ACC_PP`` of
        its own uninterrupted run."""
        ranks, d = elastic
        ds, jpipe, _, jcfg, _ = xproblem
        assert all(r["killed"] for r in ranks[4])
        assert jlatest_step(d / "port4") == 20
        assert sorted(p.name for p in (d / "port4" / "step_00000020")
                      .glob("index_p*.json")) == [f"index_p{i}.json"
                                                  for i in range(4)]
        jp0 = jlm.init_bag(jax.random.PRNGKey(1), jpipe.num_features, 3)
        jacc = jstreamed_accuracy(
            jfit_streamed(jp0, jpipe, ds.x_train, ds.y_train, cfg=jcfg),
            jpipe, ds.x_test, ds.y_test)
        jp = jresume(d / "port4", jpipe, ds.x_train, ds.y_train, cfg=jcfg,
                     shuffle_key=jax.random.PRNGKey(0))
        got = jstreamed_accuracy(jp, jpipe, ds.x_test, ds.y_test)
        assert abs(got - jacc) * 100 <= ACC_PP, (got, jacc)

    @pytest.mark.parametrize("ndev", [4, 2, 1])
    def test_port_resumes_the_references_checkpoint(self, elastic, xproblem,
                                                    ndev):
        """The reference killed at 25 (latest 20); the port resumes its
        checkpoint on 4, 2 and 1 ranks within ``ACC_PP`` of the
        reference's uninterrupted run, the same count on every rank."""
        from repro_torch.launch.mesh import make_data_mesh
        ranks, d = elastic
        ds, jpipe, pipe, jcfg, cfg = xproblem
        jp0 = jlm.init_bag(jax.random.PRNGKey(1), jpipe.num_features, 3)
        jacc = jstreamed_accuracy(
            jfit_streamed(jp0, jpipe, ds.x_train, ds.y_train, cfg=jcfg),
            jpipe, ds.x_test, ds.y_test)
        if ndev == 1:
            mesh = make_data_mesh(1)
            p = resume_linear_streamed(d / "ref", pipe, ds.x_train,
                                       ds.y_train, cfg=cfg, mesh=mesh,
                                       shuffle_key=prng_key(0))
            accs = [streamed_accuracy(p, pipe, ds.x_test, ds.y_test,
                                      mesh=mesh)]
        else:
            accs = [r["xacc"] for r in ranks[ndev]]
        assert len(set(accs)) == 1
        assert abs(accs[0] - jacc) * 100 <= ACC_PP, (accs, jacc)
