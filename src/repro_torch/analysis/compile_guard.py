"""compile_guard: the bound on distinct launch shapes as a context
manager (the counterpart of ``repro.analysis.compile_guard``).

The reference asserts that a streaming path compiles exactly one chunk
shape (a jitted function's cache size).  The port compiles nothing per
shape, but graph capture (ROADMAP A8) will record one graph per distinct
launch, so the contract becomes a count of distinct launch signatures
(op, shapes, dtypes, options, plan) seen inside the block:

    with compile_guard() as g:
        g.watch("cws_encode_rng", expect=2)   # full chunk + ragged tail
        pipe.features(x_with_ragged_tail)

The port does not pad a ragged last chunk (``pipeline/featurize.py``),
so each site states its own count: the serving runner ``len(buckets)``,
a streamed featurize 1 or 2 (full chunks, a ragged tail), a streamed
trainer step 1 a batch size.  ``watch`` takes an op name or one of the
registry's implementations (its op is looked up).  An exception inside
the block propagates unjudged, as in the reference.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import registry
from .launches import recording

__all__ = ["compile_guard", "CompileGuard"]


def _op_of(op_or_fn) -> str:
    if isinstance(op_or_fn, str):
        if op_or_fn not in registry.IMPLS:
            raise KeyError(f"compile_guard.watch: no op {op_or_fn!r} in "
                           f"the registry")
        return op_or_fn
    for op, table in registry.IMPLS.items():
        if any(fn is op_or_fn for fn in table.values()):
            return op
    raise TypeError(f"compile_guard.watch needs a registry op or one of its "
                    f"implementations; got {op_or_fn!r}")


class CompileGuard:
    def __init__(self, seen: list) -> None:
        self._seen = seen
        self._watched: List[Tuple[str, int, str]] = []

    def watch(self, op_or_fn, *, expect: int = 1,
              label: Optional[str] = None):
        """On exit, ``op_or_fn``'s launches inside the block must show
        exactly ``expect`` distinct signatures.  Returns ``op_or_fn``."""
        op = _op_of(op_or_fn)
        self._watched.append((op, expect, label or op))
        return op_or_fn

    def signatures(self) -> Dict[str, set]:
        out: Dict[str, set] = {}
        for launch in self._seen:
            out.setdefault(launch.op, set()).add(launch.signature)
        return out

    def verify(self) -> None:
        sigs = self.signatures()
        for op, expect, label in self._watched:
            got = len(sigs.get(op, ()))
            if got != expect:
                raise AssertionError(
                    f"compile_guard: {label} launched {got} distinct "
                    f"signature(s) (op, shapes, dtypes, options, plan), "
                    f"expected {expect}: a captured graph per signature "
                    f"would be recorded {got} times")


@contextlib.contextmanager
def compile_guard():
    with recording() as seen:
        guard = CompileGuard(seen)
        yield guard
    guard.verify()
