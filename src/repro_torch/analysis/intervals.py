"""Integer-range audit: the int_range contracts on concrete boundary
inputs (the counterpart of ``repro.analysis.intervals``).

The reference proves its contracts by interval abstract interpretation
over a jaxpr.  The port keeps the contracts and drops the interpreter:
``audit_intervals(fn, args)`` runs the site on concrete boundary inputs
(the extremes the site's callers can give) under a dispatch mode, and

  * shadows every int32 ``add``, ``sub``, ``mul`` and left shift in int64
    and flags a result that differs (a wrap), unless the site blesses
    wrap (``allow_wrap``, as ``regen.threefry_tile`` does);
  * flags a narrowing integer conversion (int64 to int32, ...) whose
    values do not fit, the eager form of the same wrap;
  * flags a shift amount outside [0, bits - 1] of its operand;
  * flags an int-to-float conversion that is not exact (a magnitude past
    2^24 into float32, 2^53 into float64);
  * checks ``index_select``, ``embedding``, ``gather`` and ``take``
    indices against the table's rows: negative or past the end is a
    finding.  On ``meta`` tensors (a table too large to hold: the packed
    bag head at k = 2^23, b = 8) values are unknown, so the check is the
    index type's reach: an int32 index into a table of more than 2^31
    rows cannot address its top.
"""
from __future__ import annotations

from typing import List

import torch

from ._dispatch import OpWatch, op_name
from .report import Finding

__all__ = ["audit_intervals", "SHADOWED", "SHIFTS", "GATHERS"]

SHADOWED = {"add": torch.add, "add_": torch.add, "sub": torch.sub,
            "sub_": torch.sub, "mul": torch.mul, "mul_": torch.mul,
            "__lshift__": torch.bitwise_left_shift,
            "bitwise_left_shift": torch.bitwise_left_shift,
            "__ilshift__": torch.bitwise_left_shift,
            "bitwise_left_shift_": torch.bitwise_left_shift}
SHIFTS = ("__lshift__", "__rshift__", "bitwise_left_shift",
          "bitwise_right_shift", "__ilshift__", "__irshift__",
          "bitwise_left_shift_", "bitwise_right_shift_")
GATHERS = ("index_select", "embedding", "gather", "take")
_EXACT = {torch.float32: 2 ** 24, torch.float64: 2 ** 53,
          torch.bfloat16: 2 ** 8, torch.float16: 2 ** 11}


def _concrete(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type != "meta"


def _bits(dt: torch.dtype) -> int:
    return torch.iinfo(dt).bits


def _is_int(t) -> bool:
    return isinstance(t, torch.Tensor) and not t.is_floating_point() \
        and not t.is_complex() and t.dtype != torch.bool


class _Ranges:
    def __init__(self, name, allow_wrap):
        self.name, self.allow_wrap = name, allow_wrap
        self.findings: List[Finding] = []
        self._seen = set()
        self._shadow = None

    def emit(self, message, **details):
        if message not in self._seen:
            self._seen.add(message)
            self.findings.append(Finding(check="int_range", target=self.name,
                                         message=message, details=details))

    def before(self, func, args, kwargs):
        name = op_name(func)
        self._shadow = None
        if name in SHIFTS and len(args) > 1:
            self.shift(name, args[0], args[1])
        if name in SHADOWED and _is_int(args[0]) and \
                args[0].dtype == torch.int32 and _concrete(args[0]) and \
                all(_concrete(a) or isinstance(a, (int, bool))
                    for a in args[1:2]):
            other = args[1]
            wide = other.to(torch.int64) if isinstance(other, torch.Tensor) \
                else other
            alpha = kwargs.get("alpha", 1)
            if alpha != 1:
                wide = wide * alpha
            self._shadow = SHADOWED[name](args[0].to(torch.int64), wide)
        if name in GATHERS:
            self.gather(name, args)

    def after(self, func, args, kwargs, out):
        name = op_name(func)
        if self._shadow is not None and _concrete(out) and \
                not self.allow_wrap:
            if not torch.equal(out.to(torch.int64), self._shadow):
                bad = (out.to(torch.int64) != self._shadow).nonzero()[0]
                self.emit(f"int32 {name} wraps: at {bad.tolist()} the int64 "
                          f"result {int(self._shadow[tuple(bad)])} does not "
                          f"fit; widen the arithmetic to int64, or bless "
                          f"wrap on the site where it is the design",
                          op=name)
        self._shadow = None
        if name == "_to_copy" and _is_int(args[0]) and _concrete(args[0]) \
                and isinstance(out, torch.Tensor):
            self.convert(args[0], out)

    def shift(self, name, x, amount):
        if not _is_int(x):
            return
        top = _bits(x.dtype) - 1
        if isinstance(amount, torch.Tensor):
            if not _concrete(amount) or amount.numel() == 0:
                return
            lo, hi = int(amount.min()), int(amount.max())
        else:
            lo = hi = int(amount)
        if lo < 0 or hi > top:
            self.emit(f"{name} of a {x.dtype} by [{lo}, {hi}]: a shift "
                      f"amount outside [0, {top}] is undefined in C and "
                      f"differs between backends", op=name, lo=lo, hi=hi)

    def convert(self, src, out):
        if src.numel() == 0:
            return
        if out.is_floating_point():
            limit = _EXACT.get(out.dtype)
            if limit is None:
                return
            big = src.to(torch.int64).abs() > limit
            if big.any() and not torch.equal(
                    out.to(torch.float64)[big],
                    src.to(torch.float64)[big]):
                self.emit(f"int to {out.dtype} conversion is inexact: "
                          f"values past 2^{limit.bit_length() - 1} round",
                          dtype=str(out.dtype))
        elif _is_int(out) and _bits(out.dtype) < _bits(src.dtype) \
                and not self.allow_wrap and out.dtype != torch.uint32:
            info = torch.iinfo(out.dtype)
            lo, hi = int(src.min()), int(src.max())
            if lo < info.min or hi > info.max:
                self.emit(f"{src.dtype} to {out.dtype} conversion wraps: "
                          f"values in [{lo}, {hi}] do not fit [{info.min}, "
                          f"{info.max}]", lo=lo, hi=hi)

    def gather(self, name, args):
        if name == "embedding":
            table, idx, dim = args[0], args[1], 0
        elif name == "take":
            table, idx, dim = args[0], args[1], None
        else:
            table, dim, idx = args[0], int(args[1]), args[2]
        if not isinstance(idx, torch.Tensor):
            return
        rows = table.numel() if dim is None else table.shape[dim]
        if not _concrete(idx):
            if idx.dtype == torch.int32 and rows > 2 ** 31:
                self.emit(f"{name}: an int32 index into {rows} rows cannot "
                          f"address rows past 2^31 - 1", op=name, rows=rows)
            return
        if idx.numel() == 0:
            return
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= rows:
            self.emit(f"{name}: indices in [{lo}, {hi}] against a table of "
                      f"{rows} rows; every index must lie in [0, {rows - 1}]",
                      op=name, lo=lo, hi=hi, rows=rows)


def audit_intervals(fn, args, *, name: str = "fn",
                    allow_wrap: bool = False) -> List[Finding]:
    """Run ``fn(*args)`` on its boundary inputs and return the int_range
    findings.  A gather out of range raises where the backend checks
    (the CPU does): the finding is kept and the error is not."""
    ranges = _Ranges(name, allow_wrap)
    try:
        with OpWatch(before=ranges.before, after=ranges.after):
            fn(*args)
    except (IndexError, RuntimeError) as e:
        if not ranges.findings:
            raise
        ranges.findings[-1].details["raised"] = f"{type(e).__name__}: {e}"
    return ranges.findings
