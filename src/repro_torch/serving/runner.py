"""The serving runner: one served model, a ladder of padded batch shapes.

One ``BucketRunner`` owns a ``FeaturePipeline`` (two uint32 key words in
regen mode, the (D, k) matrices in stored mode) and the linear (F, C) bag
table, and launches ``FeaturePipeline.scoring_chunk_fn`` (the encode
kernel feeding ``bag_logits`` / ``bag_logits_packed``) on batches padded
to one of its buckets.  PyTorch runs eagerly, so nothing is compiled per
bucket: ``compile_count()`` counts the bucket shapes warmed so far, and
after ``warmup()`` it equals ``len(buckets)`` for good.

The chaos plan hooks each dispatch (site ``"serve_step"``, indexed by the
dispatch count).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.linear_model import LinearParams, validate_bag_features
from repro_torch.kernels import registry
from repro_torch.pipeline import FeaturePipeline

__all__ = ["BucketRunner"]


class BucketRunner:
    def __init__(self, params: LinearParams, pipe: FeaturePipeline, *,
                 buckets: Optional[Sequence[int]] = None,
                 chaos=None, monitor=None):
        validate_bag_features(params, pipe.num_features, spec=pipe.spec)
        if params.w.device != pipe.device or params.b.device != pipe.device:
            raise ValueError(f"table on {params.w.device} but pipeline on "
                             f"{pipe.device}")
        self.pipe = pipe
        self.params = params
        self.family = registry.family(pipe._op_name())
        self.buckets: Tuple[int, ...] = tuple(
            sorted(set(int(b) for b in buckets))
            if buckets is not None else registry.serve_buckets(self.family))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"need positive buckets; got {self.buckets}")
        self.fingerprint = pipe.fingerprint()
        self.n_classes = int(params.b.shape[0])
        self.chaos = chaos
        self.monitor = monitor
        self._fn = pipe.scoring_chunk_fn()
        self._state = pipe._state()
        self._dispatches = 0
        self._shapes: set[int] = set()
        if monitor is not None:
            monitor.gauge("compile_count", self.compile_count)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket holding ``rows``; callers split anything
        larger than the top bucket into max-bucket segments first."""
        if rows <= 0 or rows > self.max_bucket:
            raise ValueError(
                f"{rows} rows do not fit the bucket ladder {self.buckets}")
        return next(b for b in self.buckets if rows <= b)

    def compile_count(self) -> int:
        """Bucket shapes launched so far (== len(buckets) after warmup)."""
        return len(self._shapes)

    def _launch(self, xb: torch.Tensor) -> torch.Tensor:
        out = self._fn(xb, self._state, self.params)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        self._shapes.add(xb.shape[0])
        return out

    def warmup(self) -> float:
        """Launch every bucket once on all-zero rows (the pad content live
        traffic uses); returns the wall seconds spent."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self._launch(torch.zeros((b, self.pipe.dim), dtype=torch.float32,
                                     device=self.pipe.device))
        return time.perf_counter() - t0

    def run(self, xb) -> torch.Tensor:
        """One dispatch: ``xb`` (bucket, D) padded rows -> (bucket, C)
        logits, completed on the device before it returns.  The chaos hook
        fires before the launch."""
        if xb.shape[0] not in self.buckets:
            raise ValueError(
                f"dispatch shape {xb.shape[0]} is not a bucket of "
                f"{self.buckets}; pad via bucket_for first")
        i = self._dispatches
        self._dispatches += 1
        if self.chaos is not None:
            self.chaos.fire("serve_step", i)
        return self._launch(self.pipe._as_rows(xb))

    def score(self, x) -> np.ndarray:
        """Runner-local scoring (no gateway): bucket, pad, dispatch, slice,
        splitting requests larger than the top bucket.  Pad rows are
        all-zero and the kernels are row-parallel, so the rows' features
        equal the offline ``pipe.features(x)``."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, self.n_classes), np.float32)
        outs = []
        for lo in range(0, n, self.max_bucket):
            seg = x[lo:lo + self.max_bucket]
            m = seg.shape[0]
            bucket = self.bucket_for(m)
            if bucket > m:
                seg = np.pad(seg, ((0, bucket - m), (0, 0)))
            t0 = time.perf_counter()
            out = self.run(seg)
            if self.monitor is not None:
                self.monitor.record_batch(bucket, m,
                                          time.perf_counter() - t0)
            outs.append(out.cpu().numpy()[:m])
        return np.concatenate(outs, axis=0)
