"""The serving gateway: request micro-batching over the bucket runner
(port of ``repro.serving.gateway``; the same queue, coalescing,
backpressure, deadlines, watchdog and chaos recovery).

Requests arrive row-batched and ragged (``submit(x)`` with any (m, D));
the card wants a handful of fixed shapes.  The gateway bridges them the
way every production inference front end does:

  * QUEUE    — submitted rows enqueue FIFO; ``max_queue_rows`` is the
    backpressure bound (a request that would push the BACKLOG past it
    raises ``QueueFull`` — the caller sheds load instead of the queue
    growing without bound).  The bound caps backlog, not request size:
    an idle queue admits a request of any size, which then streams
    through segment by segment.
  * COALESCE — the dispatch thread drains consecutive requests into one
    micro-batch while they fit the largest bucket, pads the batch up to
    the SMALLEST bucket that holds it, dispatches it, and slices each
    request's rows back out of the response.  Requests larger than the
    top bucket are split into max-bucket segments at submit time and
    reassembled on completion — any request size is servable.
  * DEADLINE — every request carries one; a request that expires while
    QUEUED fails with ``DeadlineExceeded``.  A request IN FLIGHT when
    the runner hangs is the watchdog's job: ``hard_timeout_s`` arms a
    ``StepWatchdog`` whose background monitor fails the in-flight batch
    with ``ServeTimeout`` mid-hang — the caller gets a clean error in
    bounded time, never a hang (chaos-tested).
  * RECOVER  — a dispatch that raises fails ONLY its in-flight requests
    (clean errors, counted), and the loop keeps serving: a simulated
    runner death (``ChaosKill``) is survived: the model state worth
    re-materializing is two uint32 words plus the linear table, both
    still in memory.

Pad rows are all-zero (featurize to sentinel -> bucket 0) and are sliced
off; the kernels are row-parallel, so each request's rows get the same
features however they were coalesced.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.runtime.chaos import ChaosKill
from repro_torch.runtime.fault_tolerance import StepWatchdog, TrainingAborted

__all__ = ["Gateway", "ServeFuture", "ServeError", "ServeTimeout",
           "DeadlineExceeded", "QueueFull", "RunnerCrashed"]


class ServeError(RuntimeError):
    """A request failed inside the service (dispatch raised)."""


class ServeTimeout(ServeError):
    """The request was in flight when the runner step hung past the
    watchdog's hard timeout."""


class DeadlineExceeded(ServeTimeout):
    """The request's deadline expired while it was still queued."""


class QueueFull(ServeError):
    """Backpressure: the queue is at ``max_queue_rows``; shed load."""


class RunnerCrashed(ServeError):
    """The runner died mid-dispatch (simulated preemption); the request
    must be retried against the recovered service."""


class ServeFuture:
    """Completion handle for one submitted request (thread-safe,
    first-writer-wins): ``result()`` blocks for the (n, C) float32
    logits or raises the request's failure."""

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._ev.is_set()

    def _set_result(self, value) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._result = value
            self._ev.set()
            return True

    def _set_exception(self, exc: BaseException) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._exc = exc
            self._ev.set()
            return True

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request not complete")
        if self._exc is not None:
            raise self._exc
        return self._result


class _PendingRequest:
    """One submitted request: the response buffer its (possibly split)
    segments fill, and the bookkeeping to complete it exactly once."""

    def __init__(self, n: int, n_classes: int, deadline: float,
                 t_submit: float):
        self.n = n
        self.deadline = deadline
        self.t_submit = t_submit
        self.future = ServeFuture()
        self.buf = np.empty((n, n_classes), np.float32)
        self.remaining_parts = 0
        self.lock = threading.Lock()

    def deliver(self, offset: int, rows: np.ndarray) -> bool:
        """Fill one segment; True when this completed the request."""
        with self.lock:
            self.buf[offset:offset + rows.shape[0]] = rows
            self.remaining_parts -= 1
            last = self.remaining_parts == 0
        if last:
            return self.future._set_result(self.buf)
        return False

    def fail(self, exc: BaseException) -> bool:
        return self.future._set_exception(exc)


class _Item:
    """One queued segment: ``rows`` of ``req`` starting at ``offset``."""

    __slots__ = ("req", "rows", "offset")

    def __init__(self, req: _PendingRequest, rows: np.ndarray, offset: int):
        self.req = req
        self.rows = rows
        self.offset = offset


class Gateway:
    def __init__(self, runner, monitor=None, *,
                 max_queue_rows: int = 4096,
                 default_deadline_s: float = 30.0,
                 hard_timeout_s: float = 0.0,
                 poll_s: float = 0.05):
        self.runner = runner
        self.monitor = monitor
        self.max_queue_rows = max_queue_rows
        self.default_deadline_s = default_deadline_s
        self._cv = threading.Condition()
        self._queue: collections.deque[_Item] = collections.deque()
        self._queued_rows = 0
        self._stop = False
        self._inflight: list[_Item] = []
        self._poisoned = False
        self._batches = 0
        self._watchdog = None
        if hard_timeout_s > 0:
            # statistical=False: dispatch wall time varies by bucket, so
            # the trailing-median straggler tier would abort legitimate
            # big-bucket steps after small-bucket traffic; only the hard
            # monitor (which fails in-flight requests itself) may fire.
            self._watchdog = StepWatchdog(hard_timeout_s=hard_timeout_s,
                                          statistical=False,
                                          on_timeout=self._on_hard_timeout)
        if monitor is not None:
            monitor.gauge("queue_rows", lambda: self._queued_rows)
            monitor.gauge("queue_requests", self._queued_requests)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-gateway")
        self._thread.start()

    # -- client surface ------------------------------------------------

    def submit(self, x, *, deadline_s: Optional[float] = None) -> ServeFuture:
        """Enqueue (m, D) nonneg rows; returns a ``ServeFuture`` for the
        (m, C) logits.  Raises ``QueueFull`` immediately when admitting
        would push a NON-empty queue past ``max_queue_rows``
        (backpressure is the caller's signal, not a silent stall; an
        idle queue admits any size)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.runner.pipe.dim:
            raise ValueError(
                f"requests are (m, {self.runner.pipe.dim}) rows; "
                f"got {x.shape}")
        now = time.monotonic()
        deadline = now + (deadline_s if deadline_s is not None
                          else self.default_deadline_s)
        req = _PendingRequest(x.shape[0], self.runner.n_classes, deadline,
                              now)
        if self.monitor is not None:
            self.monitor.count("requests")
            self.monitor.count("rows", x.shape[0])
        if x.shape[0] == 0:
            # nothing to launch; complete inline with the empty logits
            # the offline path produces for an empty batch
            req.remaining_parts = 0
            req.future._set_result(req.buf)
            if self.monitor is not None:
                self.monitor.count("completed")
            return req.future
        seg = self.runner.max_bucket
        parts = [(lo, x[lo:lo + seg]) for lo in range(0, x.shape[0], seg)]
        req.remaining_parts = len(parts)
        with self._cv:
            if self._stop:
                raise ServeError("gateway is stopped")
            # backpressure: reject a request that would push the queue
            # past the bound — UNLESS the queue is empty, so a single
            # request larger than max_queue_rows still streams through
            # an idle service segment by segment (any size is servable;
            # the bound caps BACKLOG, not request size)
            if (self._queue and
                    self._queued_rows + x.shape[0] > self.max_queue_rows):
                if self.monitor is not None:
                    self.monitor.count("rejected")
                raise QueueFull(
                    f"queue holds {self._queued_rows} rows; request of "
                    f"{x.shape[0]} exceeds max_queue_rows="
                    f"{self.max_queue_rows}")
            for lo, rows in parts:
                self._queue.append(_Item(req, rows, lo))
            self._queued_rows += x.shape[0]
            self._cv.notify()
        return req.future

    def score(self, x, *, deadline_s: Optional[float] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous ``submit().result()``."""
        return self.submit(x, deadline_s=deadline_s).result(timeout)

    def stop(self) -> None:
        """Stop dispatching: the in-flight batch (if any) finishes, but
        nothing still queued is dispatched — it fails with ``gateway
        stopped``.  With a watchdog armed the join is bounded: a runner
        hung past the hard timeout already had its requests failed, and
        the daemon dispatch thread must not hang ``stop()`` with it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        timeout = None
        if self._watchdog is not None:
            timeout = max(2.0 * self._watchdog.hard_timeout_s, 1.0)
        self._thread.join(timeout)
        if self._watchdog is not None:
            self._watchdog.stop()
        with self._cv:
            items = list(self._queue) + self._inflight
            self._queue.clear()
            self._inflight = []
            self._queued_rows = 0
        for it in items:
            it.req.fail(ServeError("gateway stopped"))

    # -- dispatch loop -------------------------------------------------

    def _queued_requests(self) -> int:
        """Distinct requests with at least one segment still queued."""
        with self._cv:
            return len({id(it.req) for it in self._queue})

    def _on_hard_timeout(self, elapsed: float) -> None:
        """Watchdog monitor thread: the in-flight dispatch hung.  Fail
        its requests NOW — the client gets a clean ``ServeTimeout`` in
        bounded time while the runner thread is still stuck — and poison
        the batch so a late result is discarded."""
        with self._cv:
            items, self._inflight = self._inflight, []
            self._poisoned = True
        failed = set()
        for it in items:
            if id(it.req) not in failed and it.req.fail(ServeTimeout(
                    f"runner step hung > {elapsed:.2f}s; request failed "
                    f"by the watchdog")):
                failed.add(id(it.req))
        if self.monitor is not None:
            self.monitor.count("watchdog_fired")
            self.monitor.count("timed_out", len(failed))

    def _sweep_expired_locked(self) -> None:
        now = time.monotonic()
        kept = collections.deque()
        for it in self._queue:
            if it.req.future.done():           # already failed elsewhere
                self._queued_rows -= it.rows.shape[0]
            elif it.req.deadline < now:
                self._queued_rows -= it.rows.shape[0]
                if it.req.fail(DeadlineExceeded(
                        f"request deadline expired after "
                        f"{now - it.req.t_submit:.2f}s in queue")):
                    if self.monitor is not None:
                        self.monitor.count("timed_out")
            else:
                kept.append(it)
        self._queue = kept

    def _take_batch(self):
        """Block until work or stop; returns (items, rows) with rows <=
        the top bucket (FIFO coalescing across requests).  A stop wins
        immediately — still-queued items are NOT drained; ``stop()``
        fails them with a clean error after the join."""
        with self._cv:
            while True:
                if self._stop:
                    return None, 0
                self._sweep_expired_locked()
                if self._queue:
                    break
                self._cv.wait(timeout=0.05)
            items, rows = [], 0
            cap = self.runner.max_bucket
            while self._queue and rows + self._queue[0].rows.shape[0] <= cap:
                it = self._queue.popleft()
                items.append(it)
                rows += it.rows.shape[0]
            self._queued_rows -= rows
            return items, rows

    def _loop(self) -> None:
        while True:
            items, rows = self._take_batch()
            if items is None:
                return
            wd = self._watchdog
            bucket = self.runner.bucket_for(rows)
            xb = np.zeros((bucket, self.runner.pipe.dim), np.float32)
            off = 0
            for it in items:
                xb[off:off + it.rows.shape[0]] = it.rows
                off += it.rows.shape[0]
            with self._cv:
                self._inflight = list(items)
                self._poisoned = False
            self._batches += 1
            if wd is not None:
                wd.start_step(self._batches)
            t0 = time.perf_counter()
            try:
                out = self.runner.run(xb)
                if wd is not None:
                    wd.end_step()
            except TrainingAborted as e:
                with self._cv:
                    poisoned = self._poisoned
                if poisoned:
                    # the hung dispatch finally limped home; its requests
                    # were already failed mid-hang by _on_hard_timeout
                    self._fail_inflight(None, "hang_recovered")
                else:
                    # the watchdog aborted WITHOUT the monitor callback
                    # having failed the futures (it shouldn't, with the
                    # statistical tier off — but an abort must never
                    # strand a synchronous caller waiting forever)
                    self._fail_inflight(ServeTimeout(
                        f"dispatch aborted by the watchdog: {e}"),
                        "failed_batches")
            except ChaosKill as e:
                # simulated runner death: fail in-flight cleanly and keep
                # serving — the regen-mode restart story (model state is
                # 2 key words + the table, both still here)
                if wd is not None:
                    wd.clear_step()
                self._fail_inflight(RunnerCrashed(
                    f"runner died mid-dispatch: {e}"), "restarts")
            except Exception as e:
                if wd is not None:
                    wd.clear_step()
                self._fail_inflight(ServeError(
                    f"dispatch failed: {type(e).__name__}: {e}"),
                    "failed_batches")
            else:
                wall = time.perf_counter() - t0
                with self._cv:
                    poisoned = self._poisoned
                    delivered, self._inflight = self._inflight, []
                if self.monitor is not None:
                    self.monitor.record_batch(bucket, rows, wall)
                if not poisoned:
                    arr = out.cpu().numpy()
                    off = 0
                    now = time.monotonic()
                    for it in delivered:
                        m = it.rows.shape[0]
                        if it.req.deliver(it.offset, arr[off:off + m]):
                            if self.monitor is not None:
                                self.monitor.record_latency(
                                    now - it.req.t_submit)
                                self.monitor.count("completed")
                        off += m

    def _fail_inflight(self, exc: Optional[ServeError],
                       counter: str) -> None:
        with self._cv:
            items, self._inflight = self._inflight, []
        if exc is not None:
            failed = set()
            for it in items:
                if id(it.req) not in failed and it.req.fail(exc):
                    failed.add(id(it.req))
            if self.monitor is not None and failed:
                self.monitor.count("failed", len(failed))
        if self.monitor is not None:
            self.monitor.count(counter)
