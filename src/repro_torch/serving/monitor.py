"""Serving monitoring surface: counters, latency percentiles, stats HTTP
(the port's copy of ``repro.serving.monitor``, same snapshot schema).

One ``ServeMonitor`` instance is shared by the gateway (request/queue
accounting) and the runner (per-bucket dispatch accounting).  All
mutation happens under one lock — the gateway's dispatch thread, the
watchdog's monitor thread, and any number of submitting threads write
concurrently — and ``snapshot()`` returns a plain JSON-able dict, the one
schema the stats endpoint and the tests consume:

    requests / rows / rejected / timed_out / failed / completed
    queue_rows / queue_requests        current backlog gauges
    batches / pad_rows / restarts      dispatch totals
    buckets: {rows: {batches, rows, pad_rows}}   per-bucket traffic
    latency_ms: {count, p50, p99, max}           request wall time
    compile_count                      bucket shapes warmed so far

``start_stats_server`` exposes ``snapshot()`` as ``GET /stats`` on a
background ``ThreadingHTTPServer`` (port 0 picks a free port); stdlib
only.
"""
from __future__ import annotations

import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

__all__ = ["ServeMonitor", "StatsServer", "start_stats_server"]


class ServeMonitor:
    def __init__(self, *, latency_window: int = 8192):
        self._lock = threading.Lock()
        self._counts = collections.Counter()
        self._buckets: dict[int, collections.Counter] = {}
        self._latencies = collections.deque(maxlen=latency_window)
        self._gauges: dict[str, Callable[[], int]] = {}

    # -- writers (gateway / runner threads) ----------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def record_batch(self, bucket: int, real_rows: int,
                     wall_s: float) -> None:
        with self._lock:
            self._counts["batches"] += 1
            self._counts["pad_rows"] += bucket - real_rows
            b = self._buckets.setdefault(int(bucket), collections.Counter())
            b["batches"] += 1
            b["rows"] += real_rows
            b["pad_rows"] += bucket - real_rows
            b["wall_us"] += int(wall_s * 1e6)

    def record_latency(self, wall_s: float) -> None:
        with self._lock:
            self._latencies.append(wall_s)

    def gauge(self, name: str, fn: Callable[[], int]) -> None:
        """Register a live gauge (queue depth, compile count): sampled at
        snapshot time rather than pushed."""
        with self._lock:
            self._gauges[name] = fn

    # -- readers -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            lats = np.asarray(self._latencies, np.float64)
            out = dict(self._counts)
            out["buckets"] = {str(k): dict(v)
                              for k, v in sorted(self._buckets.items())}
            gauges = dict(self._gauges)
        out["latency_ms"] = {
            "count": int(lats.size),
            "p50": float(np.percentile(lats, 50) * 1e3) if lats.size else 0.0,
            "p99": float(np.percentile(lats, 99) * 1e3) if lats.size else 0.0,
            "max": float(lats.max() * 1e3) if lats.size else 0.0,
        }
        for name, fn in gauges.items():
            try:
                out[name] = int(fn())
            except Exception:           # a torn-down gauge must not kill /stats
                out[name] = -1
        return out

    def stats_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)


class _StatsHandler(BaseHTTPRequestHandler):
    def do_GET(self):                               # noqa: N802 (stdlib API)
        if self.path.rstrip("/") not in ("", "/stats"):
            self.send_error(404)
            return
        body = self.server.monitor.stats_json().encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):                   # stats scrapes are not news
        pass


class StatsServer:
    """The JSON stats endpoint: ``GET /stats`` -> ``monitor.snapshot()``."""

    def __init__(self, monitor: ServeMonitor, *, host: str = "127.0.0.1",
                 port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _StatsHandler)
        self._httpd.monitor = monitor
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/stats"

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()


def start_stats_server(monitor: ServeMonitor, *, host: str = "127.0.0.1",
                       port: int = 0) -> StatsServer:
    """Spin up the stats endpoint on a background thread; ``port=0``
    binds a free port (read it back from ``.port``/``.url``)."""
    return StatsServer(monitor, host=host, port=port)
