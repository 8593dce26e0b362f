"""Online serving for the featurize→score path: bucketed runner,
micro-batching gateway, monitor, bundles, and the assembled service."""
from repro_torch.serving.bundle import FORMAT, load_bundle, save_bundle
from repro_torch.serving.gateway import (DeadlineExceeded, Gateway,
                                         QueueFull, RunnerCrashed,
                                         ServeError, ServeFuture,
                                         ServeTimeout)
from repro_torch.serving.monitor import (ServeMonitor, StatsServer,
                                         start_stats_server)
from repro_torch.serving.runner import BucketRunner
from repro_torch.serving.service import ServingService

__all__ = [
    "BucketRunner", "Gateway", "ServeMonitor", "ServingService",
    "StatsServer", "start_stats_server", "save_bundle", "load_bundle",
    "FORMAT", "ServeFuture", "ServeError", "ServeTimeout",
    "DeadlineExceeded", "QueueFull", "RunnerCrashed",
]
