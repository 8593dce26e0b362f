"""Deterministic fault injection for preemption-grade training and for
serving (the port's copy of ``repro.runtime.chaos``).

Injection sites (where the code calls ``plan.fire(site, i)``):

    "step"             fit_linear_streamed, before update step i
    "eval_chunk"       streamed_accuracy, before chunk i
    "ckpt_io"          Checkpointer write, before any file IO
    "ckpt_pre_rename"  write dir fully written, before tmp -> step rename
    "ckpt_pre_commit"  renamed, before the COMMIT marker is written
    "serve_step"       serving.BucketRunner.run, before dispatch i

Fault actions:

  * ``raise``    — raises ``FaultInjected`` (an ``Exception``), which a
    ``RetryingTrainer`` restarts from;
  * ``kill``     — raises ``ChaosKill``, a ``BaseException`` so no retry
    loop can catch it, exactly like SIGKILL: surviving it means a new
    call resuming from the last committed checkpoint;
  * ``hang``     — blocks for ``seconds`` (a stuck step or card), what the
    watchdog's background monitor must cut;
  * ``io_error`` — the checkpoint write raises ``OSError``, surfaced by
    the ``Checkpointer`` on its next ``save_async`` or ``wait``.

Every firing is recorded in ``plan.fired``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


class ChaosKill(BaseException):
    """Simulated process death (preemption / SIGKILL); deliberately not an
    ``Exception``."""


class FaultInjected(RuntimeError):
    """The in-process software fault raised by ``raise`` faults."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """Fire ``action`` when the counter of ``site`` reaches ``index``;
    ``once=True`` disarms after the first firing."""
    site: str
    index: int
    action: str                 # "raise" | "kill" | "hang" | "io_error"
    seconds: float = 0.0        # hang duration
    once: bool = True


def raise_at(step: int) -> Fault:
    """Software fault in update step ``step`` (restartable in process)."""
    return Fault("step", step, "raise")


def kill_at(step: int) -> Fault:
    """Preemption right before update step ``step`` runs."""
    return Fault("step", step, "kill")


def hang_at(step: int, seconds: float) -> Fault:
    """Step ``step`` hangs for ``seconds``."""
    return Fault("step", step, "hang", seconds=seconds)


def kill_eval_at(chunk: int) -> Fault:
    """Preemption before evaluation chunk ``chunk`` of
    ``streamed_accuracy``."""
    return Fault("eval_chunk", chunk, "kill")


def fail_async_write(step: int) -> Fault:
    """The async checkpoint write of ``step`` raises ``OSError``."""
    return Fault("ckpt_io", step, "io_error")


def kill_between_snapshot_and_commit(step: int,
                                     phase: str = "pre_commit") -> Fault:
    """Kill the writer inside the commit window of checkpoint ``step``:
    ``phase="pre_rename"`` leaves a fully written ``step_*.tmp`` dir,
    ``phase="pre_commit"`` a renamed dir without COMMIT.  Either way the
    checkpoint must stay invisible to ``latest_step``."""
    if phase not in ("pre_rename", "pre_commit"):
        raise ValueError(f"phase must be pre_rename|pre_commit; got {phase}")
    return Fault(f"ckpt_{phase}", step, "kill")


def serve_raise_at(dispatch: int) -> Fault:
    """Software fault in serving dispatch ``dispatch``."""
    return Fault("serve_step", dispatch, "raise")


def serve_kill_at(dispatch: int) -> Fault:
    """Runner death before serving dispatch ``dispatch``."""
    return Fault("serve_step", dispatch, "kill")


def serve_hang_at(dispatch: int, seconds: float) -> Fault:
    """Serving dispatch ``dispatch`` hangs for ``seconds``."""
    return Fault("serve_step", dispatch, "hang", seconds=seconds)


class ChaosPlan:
    """A set of deterministic faults and the structured log of firings.
    The trainer and the Checkpointer's writer thread share one plan; each
    once-fault is disarmed before its action runs, so it can never fire
    twice, not even across a kill and its resume."""

    def __init__(self, *faults: Fault):
        self.faults = list(faults)
        self.fired: list[dict] = []
        self._spent: set[int] = set()   # ids into self.faults

    def fire(self, site: str, index: int) -> None:
        """A no-op unless a fault matches (site, index)."""
        for fid, f in enumerate(self.faults):
            if f.site != site or f.index != index or fid in self._spent:
                continue
            if f.once:
                self._spent.add(fid)
            self.fired.append({"site": site, "index": index,
                               "action": f.action, "t": time.time(),
                               "seconds": f.seconds})
            if f.action == "hang":
                time.sleep(f.seconds)
            elif f.action == "raise":
                raise FaultInjected(f"chaos: injected fault at "
                                    f"{site}:{index}")
            elif f.action == "kill":
                raise ChaosKill(f"chaos: simulated preemption at "
                                f"{site}:{index}")
            elif f.action == "io_error":
                raise OSError(f"chaos: injected write failure at "
                              f"{site}:{index}")
            else:
                raise ValueError(f"unknown chaos action {f.action!r}")

    def log(self, site: Optional[str] = None) -> list[dict]:
        """The firing timeline, optionally filtered to one site."""
        if site is None:
            return list(self.fired)
        return [e for e in self.fired if e["site"] == site]
