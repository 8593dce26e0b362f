"""Deterministic fault injection for the serving path (the port's copy of
the ``Fault``/``ChaosPlan`` machinery and the serve faults of
``repro.runtime.chaos``).

Injection site: ``"serve_step"``, fired by ``serving.BucketRunner.run``
before dispatch i.  A hang there models a stuck card under a live gateway,
a kill models replica death mid-request, a raise a software fault.

  * ``raise`` — raises ``FaultInjected`` (an ``Exception``);
  * ``kill``  — raises ``ChaosKill``, a ``BaseException`` so no retry loop
    can catch it, exactly like SIGKILL;
  * ``hang``  — blocks for ``seconds``.

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
    Each once-fault is disarmed before its action runs, so it can never
    fire twice."""

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
