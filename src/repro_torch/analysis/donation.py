"""Aliasing audit: the reference's donation contract in the port's terms
(the counterpart of ``repro.analysis.donation``).

XLA donates buffers; torch does not, so the bug class becomes aliasing:
a result that shares memory with a buffer its callee reuses, or an
in-place write that reaches an argument the caller still owns.
``audit_donation(fn, args)`` runs the site twice on the same (CPU)
arguments under a dispatch mode that records every in-place write (an
op whose schema writes an argument: ``copy_``, ``add_``, ``out=``
variants, ...) by the memory it touches, and flags

  * a returned tensor (or array) that shares memory with a buffer the
    callee reuses: written, or returned again, by the second call;
  * a returned tensor that shares memory with an argument the site does
    not declare as mutated (``mutates``: the positions of the arguments
    the site updates in place and may hand back);
  * an in-place write to an argument not declared in ``mutates``.

Memory is compared by address ranges of the storages (a view aliases its
base), so ``meta`` tensors, which have none, are not audited here.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

import numpy as np
import torch

from ._dispatch import OpWatch, op_name
from .report import Finding

__all__ = ["audit_donation", "leaves", "memory_range"]


def leaves(obj, path: str = ""):
    """(path, tensor or array) of every leaf of a tree of tuples, lists,
    dicts, named tuples and dataclasses."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(obj, (tuple, list)):
        fields = getattr(obj, "_fields", None)
        for i, v in enumerate(obj):
            yield from leaves(v, f"{path}/{fields[i] if fields else i}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}/{f.name}")


def memory_range(x) -> Tuple[int, int]:
    """[lo, hi) of the memory behind ``x`` (its whole storage for a
    tensor); (0, 0) for a ``meta`` tensor or an empty one."""
    if isinstance(x, np.ndarray):
        base = x.__array_interface__["data"][0]
        return (base, base + x.nbytes) if x.nbytes else (0, 0)
    if x.device.type == "meta":
        return 0, 0
    st = x.untyped_storage()
    return (st.data_ptr(), st.data_ptr() + st.nbytes()) if st.nbytes() \
        else (0, 0)


def _overlap(a, b) -> bool:
    return a[0] < b[1] and b[0] < a[1] and a != (0, 0) and b != (0, 0)


def _written(func, args, kwargs):
    """The tensors an op writes in place (its schema's mutable args)."""
    schema = func._schema
    out = []
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        val = kwargs.get(arg.name) if arg.kwarg_only else (
            args[i] if i < len(args) else kwargs.get(arg.name))
        if isinstance(val, torch.Tensor):
            out.append(val)
        elif isinstance(val, (tuple, list)):
            out += [v for v in val if isinstance(v, torch.Tensor)]
    return out


def _run(fn, args):
    writes = []

    def before(func, a, kw):
        for t in _written(func, a, kw):
            writes.append((op_name(func), memory_range(t)))

    with OpWatch(before=before):
        out = fn(*args)
    return out, writes


def audit_donation(fn, args, *, mutates: Iterable[int] = (),
                   name: str = "donation-site") -> List[Finding]:
    """Run ``fn(*args)`` twice and apply the three rules above."""
    mutates = tuple(mutates)
    findings: List[Finding] = []
    seen = set()

    def emit(message, **details):
        if message not in seen:
            seen.add(message)
            findings.append(Finding(check="donation", target=name,
                                    message=message, details=details))

    arg_mem = [(i, p, memory_range(t)) for i, a in enumerate(args)
               for p, t in leaves(a, f"arg{i}")]
    out1, writes1 = _run(fn, args)
    res1 = [(p, memory_range(t)) for p, t in leaves(out1, "out")]
    out2, writes2 = _run(fn, args)
    res2 = [(p, memory_range(t)) for p, t in leaves(out2, "out")]

    for op, mem in writes1 + writes2:
        for i, p, am in arg_mem:
            if i not in mutates and _overlap(mem, am):
                emit(f"{op} writes {p} in place, which the site does not "
                     f"declare as mutated: the caller's tensor changes "
                     f"under it; copy it first or declare mutates=({i},)",
                     op=op, arg=p)
    for p, mem in res1:
        handed_back = False
        for i, ap, am in arg_mem:
            if _overlap(mem, am):
                handed_back |= i in mutates
                if i not in mutates:
                    emit(f"result {p} shares memory with argument {ap}: "
                         f"the caller holds one buffer under two names; "
                         f"return a copy", result=p, arg=ap)
        if handed_back:      # an in-place update handing its argument back
            continue
        hits = [op for op, w in writes2 if _overlap(mem, w)]
        hits += [q for q, m2 in res2 if _overlap(mem, m2)]
        if hits:
            emit(f"result {p} shares memory with a buffer the callee "
                 f"reuses (the next call's {hits[0]} writes or returns it): "
                 f"the first result changes after it was returned; return "
                 f"a fresh tensor", result=p, by=hits[0])
    return findings
