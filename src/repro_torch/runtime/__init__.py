from repro_torch.runtime.chaos import (
    ChaosKill, ChaosPlan, Fault, FaultInjected, fail_async_write, hang_at,
    kill_at, kill_between_snapshot_and_commit, kill_eval_at, raise_at,
    serve_hang_at, serve_kill_at, serve_raise_at,
)
from repro_torch.runtime.fault_tolerance import (RetryingTrainer,
                                                 StepWatchdog,
                                                 TrainingAborted)

__all__ = [
    "StepWatchdog", "RetryingTrainer", "TrainingAborted",
    "ChaosKill", "ChaosPlan", "Fault", "FaultInjected",
    "fail_async_write", "hang_at", "kill_at",
    "kill_between_snapshot_and_commit", "kill_eval_at", "raise_at",
    "serve_hang_at", "serve_kill_at", "serve_raise_at",
]
