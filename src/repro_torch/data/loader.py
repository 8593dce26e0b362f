"""Sharded, restartable batch iterators (port of ``repro.data.loader``).

Deterministic given (seed, step): the iterator state is one integer, so
checkpoint / restore and re-sharding are trivial: after a restart at step
S every process regenerates exactly the batches it would have seen.  Each
process yields only its slice of the global batch; on one process, the
whole batch.  The draws are numpy's, as the reference's are, so the
batches are the reference's bit for bit, and they are numpy arrays: the
trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["LoaderState", "TokenBatchLoader", "FeatureBatchLoader"]


@dataclasses.dataclass
class LoaderState:
    step: int = 0


class TokenBatchLoader:
    """Synthetic LM batches: (tokens, labels) with labels = next token,
    Zipf(1.3) ranks folded into the vocabulary."""

    def __init__(self, *, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        assert global_batch % process_count == 0
        self.vocab = vocab
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.seq_len = seq_len
        self.seed = seed
        self.process_index = process_index
        self.state = LoaderState()

    def _batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.process_index]))
        ranks = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        toks = ((ranks - 1) % self.vocab).astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def snapshot(self) -> dict:
        return {"step": self.state.step, "seed": self.seed}

    def restore(self, snap: dict) -> None:
        assert snap["seed"] == self.seed, "loader seed changed across restore"
        self.state.step = int(snap["step"])


class FeatureBatchLoader:
    """Batches of (features, labels) drawn with replacement from in-memory
    arrays, restartable."""

    def __init__(self, x: np.ndarray, y: np.ndarray, *, batch_size: int,
                 seed: int = 0):
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.seed = seed
        self.state = LoaderState()

    def __next__(self):
        n = self.x.shape[0]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.state.step]))
        idx = rng.integers(0, n, size=self.batch_size)
        self.state.step += 1
        return self.x[idx], self.y[idx]

    def __iter__(self):
        return self

    def snapshot(self) -> dict:
        return {"step": self.state.step, "seed": self.seed}

    def restore(self, snap: dict) -> None:
        self.state.step = int(snap["step"])
