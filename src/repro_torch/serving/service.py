"""The assembled serving stack: monitor + runner + gateway in one handle.

    with ServingService.from_bundle(path, device="cuda") as svc:
        logits = svc.score(x)           # sync
        fut = svc.submit(x)             # async micro-batched
        svc.stats()                     # the JSON stats schema
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.serving.bundle import load_bundle
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.monitor import ServeMonitor, start_stats_server
from repro_torch.serving.runner import BucketRunner

__all__ = ["ServingService"]


class ServingService:
    def __init__(self, params, pipe, *,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue_rows: int = 4096,
                 default_deadline_s: float = 30.0,
                 hard_timeout_s: float = 0.0,
                 chaos=None, warmup: bool = True):
        self.monitor = ServeMonitor()
        self.runner = BucketRunner(params, pipe, buckets=buckets,
                                   chaos=chaos, monitor=self.monitor)
        self.warmup_s = self.runner.warmup() if warmup else 0.0
        self.gateway = Gateway(self.runner, self.monitor,
                               max_queue_rows=max_queue_rows,
                               default_deadline_s=default_deadline_s,
                               hard_timeout_s=hard_timeout_s)
        self._stats_server = None

    @classmethod
    def from_bundle(cls, path, *, device=None,
                    pipe_kw: Optional[dict] = None,
                    **kw) -> "ServingService":
        """Boot a replica from a bundle directory on ``device`` (the card
        unless ``device="cpu"``): fingerprint-verified load, then warmup."""
        params, pipe = load_bundle(path, device=device, **(pipe_kw or {}))
        return cls(params, pipe, **kw)

    # -- client surface ------------------------------------------------

    def submit(self, x, **kw):
        return self.gateway.submit(x, **kw)

    def score(self, x, **kw):
        return self.gateway.score(x, **kw)

    def stats(self) -> dict:
        return self.monitor.snapshot()

    def start_stats_server(self, *, host: str = "127.0.0.1",
                           port: int = 0):
        """Expose ``stats()`` as ``GET /stats``; returns the server."""
        if self._stats_server is None:
            self._stats_server = start_stats_server(self.monitor,
                                                    host=host, port=port)
        return self._stats_server

    def stop(self) -> None:
        self.gateway.stop()
        if self._stats_server is not None:
            self._stats_server.close()
            self._stats_server = None

    def __enter__(self) -> "ServingService":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
