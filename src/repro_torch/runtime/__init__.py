from repro_torch.runtime.chaos import (ChaosKill, ChaosPlan, Fault,
                                      FaultInjected, serve_hang_at,
                                      serve_kill_at, serve_raise_at)
from repro_torch.runtime.fault_tolerance import StepWatchdog, TrainingAborted

__all__ = ["StepWatchdog", "TrainingAborted", "ChaosKill", "ChaosPlan",
           "Fault", "FaultInjected", "serve_hang_at", "serve_kill_at",
           "serve_raise_at"]
