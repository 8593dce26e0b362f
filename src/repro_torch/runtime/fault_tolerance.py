"""Step watchdog and restart loop (the port's copy of ``TrainingAborted``,
``StepWatchdog`` and ``RetryingTrainer`` from
``repro.runtime.fault_tolerance``).

Two detection tiers.  Statistical: a completed step slower than
``timeout_factor`` x the trailing median is a straggler; ``max_strays``
in a row abort.  Hard: a background thread watches the step in flight and
fires the moment ``hard_timeout_s`` passes without ``end_step()``, the
only tier that sees a step that never ends.  Firing records an event and
calls ``on_timeout(elapsed)``, or else interrupts the main thread
(SIGINT), which ``reraise_if_fired`` turns into ``TrainingAborted``.

``statistical=False`` turns the straggler tier off: the serving gateway
dispatches to buckets of different sizes, so a slow big-bucket step after
fast small ones is not a straggler.

``RetryingTrainer`` restarts a failed attempt from durable state, with
exponential backoff and a structured restart log.
"""
from __future__ import annotations

import os
import signal
import statistics
import threading
import time
from typing import Callable, Optional

import torch


class TrainingAborted(RuntimeError):
    pass


def _interrupt_main_thread():
    """SIGINT to the process (KeyboardInterrupt in the main thread)."""
    try:
        os.kill(os.getpid(), signal.SIGINT)
    except (AttributeError, OSError):        # non-POSIX fallback
        import _thread
        _thread.interrupt_main()


class StepWatchdog:
    """Detects stuck or straggling steps by wall-time statistics and by a
    background hard-timeout monitor that fires mid-step."""

    def __init__(self, *, timeout_factor: float = 5.0,
                 min_history: int = 5, max_strays: int = 3,
                 hard_timeout_s: float = 0.0,
                 poll_s: Optional[float] = None,
                 statistical: bool = True,
                 on_straggler: Optional[Callable[[float, float], None]] = None,
                 on_timeout: Optional[Callable[[float], None]] = None):
        self.statistical = statistical
        self.timeout_factor = timeout_factor
        self.min_history = min_history
        self.max_strays = max_strays
        self.hard_timeout_s = hard_timeout_s
        self.poll_s = poll_s or max(min(hard_timeout_s / 20.0, 0.25), 0.005)
        self.on_straggler = on_straggler
        self.on_timeout = on_timeout
        self.history: list[float] = []
        self.stray_count = 0
        self.events: list[dict] = []
        self.step_index = -1
        self.fired: Optional[dict] = None     # last hard-timeout event
        self._t0: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._fired_step: Optional[int] = None

    # -- background arm ------------------------------------------------

    def _monitor_loop(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                t0, step = self._t0, self.step_index
                already = self._fired_step == step
            if t0 is None or already:
                continue
            elapsed = time.monotonic() - t0
            if elapsed <= self.hard_timeout_s:
                continue
            event = {"t": time.time(), "kind": "hard_timeout",
                     "step": step, "elapsed_s": elapsed,
                     "hard_timeout_s": self.hard_timeout_s}
            with self._lock:
                if self._fired_step == step:   # raced with another poll
                    continue
                self._fired_step = step
                self.fired = event
                self.events.append(event)
            if self.on_timeout is not None:
                self.on_timeout(elapsed)
            else:
                _interrupt_main_thread()

    def start(self):
        """Arm the background monitor (no-op without ``hard_timeout_s``)."""
        if self.hard_timeout_s <= 0 or self._monitor is not None:
            return
        self._stop.clear()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True)
        self._monitor.start()

    def stop(self):
        """Disarm the monitor (idempotent; always call from a finally)."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join()
            self._monitor = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def reraise_if_fired(self, exc: BaseException) -> None:
        """Raise ``TrainingAborted`` (chaining ``exc``) if the hard timeout
        fired for the step in flight; else return so the caller re-raises
        ``exc`` (a real Ctrl-C stays a KeyboardInterrupt)."""
        if self.fired is not None and self._fired_step == self.step_index:
            raise TrainingAborted(
                f"hung step {self.fired['step']}: no end_step after "
                f"{self.fired['elapsed_s']:.2f}s "
                f"(hard_timeout_s={self.hard_timeout_s})") from exc

    def clear_step(self):
        """Abandon the step in flight without judging it: its owner has
        already handled its failure, so the monitor stops watching it."""
        with self._lock:
            self._t0 = None

    # -- per-step accounting -------------------------------------------

    def start_step(self, index: Optional[int] = None):
        """``index`` (optional) pins the step number recorded in events."""
        self.start()
        with self._lock:
            self.step_index = self.step_index + 1 if index is None else index
            self._t0 = time.monotonic()

    def end_step(self):
        if self._t0 is None:
            raise RuntimeError("end_step without a step in flight")
        with self._lock:
            dt = time.monotonic() - self._t0
            self._t0 = None
            hard_fired = self._fired_step == self.step_index
        median = (statistics.median(self.history)
                  if self.statistical and
                  len(self.history) >= self.min_history else None)
        is_stray = median is not None and dt > self.timeout_factor * median
        if self.hard_timeout_s and dt > self.hard_timeout_s:
            is_stray = True
        if hard_fired:
            # flagged mid-flight by the monitor: a step that limps home
            # past the hard timeout still aborts
            raise TrainingAborted(
                f"step {self.step_index} exceeded hard timeout "
                f"({dt:.2f}s > {self.hard_timeout_s}s; detected mid-step "
                f"by the watchdog monitor)")
        if is_stray:
            self.stray_count += 1
            self.events.append({"t": time.time(), "kind": "straggler",
                                "step": self.step_index, "step_s": dt,
                                "median_s": median})
            if self.on_straggler:
                self.on_straggler(dt, median or 0.0)
            if self.statistical and self.stray_count >= self.max_strays:
                raise TrainingAborted(
                    f"{self.stray_count} consecutive straggler steps "
                    f"(last {dt:.2f}s vs median {median:.2f}s)")
        else:
            self.stray_count = 0
            self.history.append(dt)
            if len(self.history) > 100:
                self.history.pop(0)
        return dt


class RetryingTrainer:
    """Restart-from-checkpoint loop.

    Any ``Exception``, ``TrainingAborted`` included, restarts the attempt
    after a backoff of ``backoff_s * backoff_factor ** (restarts - 1)``,
    capped at ``max_backoff_s``, until ``max_restarts`` are used up; then
    the failure re-raises.  Every restart appends an event to
    ``restart_log`` (and calls ``on_restart``).  ``ChaosKill`` (simulated
    SIGKILL) is a ``BaseException`` and passes straight through.

      * ``run(n_steps)``: ``build_fn() -> (state, loader, step_fn,
        start_step)`` must restore from the latest checkpoint itself;
      * ``call(fn)``: call ``fn()`` until it returns; ``fn`` must resume
        from durable state when called again
        (``fit_linear_streamed_resilient``).
    """

    def __init__(self, build_fn=None, *, max_restarts: int = 3,
                 backoff_s: float = 0.5, backoff_factor: float = 2.0,
                 max_backoff_s: float = 30.0,
                 on_restart: Optional[Callable[[dict], None]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 watchdog_factory: Optional[Callable[[], StepWatchdog]] = None):
        self.build_fn = build_fn
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.max_backoff_s = max_backoff_s
        self.on_restart = on_restart
        self.sleep_fn = sleep_fn
        self.watchdog_factory = watchdog_factory or StepWatchdog
        self.restarts = 0
        self.restart_log: list[dict] = []

    def _backoff(self) -> float:
        return min(self.backoff_s * self.backoff_factor ** (self.restarts - 1),
                   self.max_backoff_s)

    def _note_failure(self, exc: Exception, step: Optional[int]) -> None:
        """Log the failure, then sleep the backoff, or re-raise when the
        restarts are used up.  Returning means: retry."""
        self.restarts += 1
        out_of_restarts = self.restarts > self.max_restarts
        backoff = 0.0 if out_of_restarts else self._backoff()
        event = {"restart": self.restarts, "step": step,
                 "error": type(exc).__name__, "message": str(exc),
                 "t": time.time(), "backoff_s": backoff,
                 "gave_up": out_of_restarts}
        self.restart_log.append(event)
        if self.on_restart:
            self.on_restart(event)
        if out_of_restarts:
            raise exc
        if backoff > 0:
            self.sleep_fn(backoff)

    def call(self, fn: Callable[[], object]):
        """Call ``fn`` until it returns, restarting on an ``Exception``."""
        while True:
            try:
                return fn()
            except Exception as e:      # ChaosKill is a BaseException:
                self._note_failure(e, step=None)   # it falls through

    def run(self, n_steps: int, *, hooks=()):
        """Drive ``build_fn``'s step function to ``n_steps``, rebuilding
        from the latest checkpoint after a failure.  Each step is waited
        for (``metrics["loss"]`` on the card) inside the watchdog."""
        while True:
            step = None
            watchdog = self.watchdog_factory()
            try:
                state, loader, step_fn, start_step = self.build_fn()
                step = start_step
                while step < n_steps:
                    batch = next(loader)
                    watchdog.start_step()
                    try:
                        state, metrics = step_fn(state, batch)
                        loss = metrics["loss"]
                        if isinstance(loss, torch.Tensor) and loss.is_cuda:
                            torch.cuda.synchronize(loss.device)
                    except KeyboardInterrupt as e:
                        watchdog.reraise_if_fired(e)
                        raise
                    watchdog.end_step()
                    step += 1
                    for h in hooks:
                        h(step, state, metrics, loader)
                return state
            except Exception as e:
                self._note_failure(e, step=step)
            finally:
                watchdog.stop()
