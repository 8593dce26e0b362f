"""Dtype-flow audit: the precision contracts over the ATen ops a site
dispatches (the counterpart of ``repro.analysis.dtype_flow``).

The reference walks a jaxpr's ``convert_element_type``, ``dot_general``
and loop carries.  The port runs eagerly, so ``audit_dtype_flow(fn,
args)`` runs the site under a ``TorchDispatchMode`` and flags

  * float narrowing the site has not blessed: a ``_to_copy`` or
    ``copy_`` that stores a float at fewer bits (``allow_narrow`` labels
    such as ``"float32->bfloat16"``: the bf16 copy of the fp32 masters,
    flash's bf16 emit);
  * a bf16 or fp16 ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` while
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    (or its fp16 twin) is True: cuBLAS may then reduce in bf16, where the
    reference pins an fp32 accumulator.  On the CPU the check reads the
    flag, so the contract holds before the step reaches a card;
  * a float loop carry narrower than fp32: a tensor accumulated in place
    (``add_``, ``mul_``, ``lerp_``, ``addcmul_``, ...) more than once in
    the site at fewer than 32 bits (``microbatch_grads``' accumulator,
    AdamW's ``mu`` and ``nu``).

The kernels' own accumulators are C++: each ``registry.SMEM_MODELS``
entry records its accumulator dtype, and ``accum_findings`` reads it.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

from repro_torch.kernels import registry
from ._dispatch import OpWatch, op_name, storage_key
from .report import Finding

__all__ = ["audit_dtype_flow", "accum_findings", "MATMULS", "CARRY_OPS"]

MATMULS = ("mm", "bmm", "addmm", "baddbmm")
CARRY_OPS = ("add_", "sub_", "mul_", "div_", "lerp_", "addcmul_",
             "addcdiv_")


def _width(dt: torch.dtype) -> int:
    return torch.finfo(dt).bits


def _name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def reduced_precision_flags() -> dict:
    m = torch.backends.cuda.matmul
    return {"bfloat16": bool(m.allow_bf16_reduced_precision_reduction),
            "float16": bool(m.allow_fp16_reduced_precision_reduction)}


class _Flow:
    def __init__(self, name, allow_narrow):
        self.name = name
        self.allow_narrow = tuple(allow_narrow)
        self.findings: List[Finding] = []
        self._seen = set()
        self._carries = {}

    def emit(self, message, **details):
        if message not in self._seen:
            self._seen.add(message)
            self.findings.append(Finding(check="dtype_flow", target=self.name,
                                         message=message, details=details))

    def narrowing(self, src, dst):
        if not (src.is_floating_point and dst.is_floating_point):
            return
        if _width(dst) >= _width(src):
            return
        label = f"{_name(src)}->{_name(dst)}"
        if label in self.allow_narrow:
            return
        self.emit(f"float narrowing {label}: a {_width(src)}-bit value is "
                  f"stored at {_width(dst)} bits; if this is the intended "
                  f"output precision, declare allow_narrow=({label!r},) on "
                  f"the site, else keep it at {_name(src)}",
                  src=_name(src), dst=_name(dst))

    def before(self, func, args, kwargs):
        name = op_name(func)
        if name == "_to_copy" and isinstance(args[0], torch.Tensor):
            dst = kwargs.get("dtype")
            if dst is not None:
                self.narrowing(args[0].dtype, dst)
        elif name == "copy_" and len(args) > 1 and \
                isinstance(args[1], torch.Tensor):
            self.narrowing(args[1].dtype, args[0].dtype)
        elif name in MATMULS:
            dts = {t.dtype for t in args[:3] if isinstance(t, torch.Tensor)}
            flags = reduced_precision_flags()
            for dt in dts & {torch.bfloat16, torch.float16}:
                if flags[_name(dt)]:
                    twin = "bf16" if dt == torch.bfloat16 else "fp16"
                    self.emit(
                        f"{name} on {_name(dt)} while torch.backends.cuda."
                        f"matmul.allow_{twin}_reduced_precision_reduction "
                        f"is True: cuBLAS may reduce the products in "
                        f"{_name(dt)}; set it False where the step takes "
                        f"the card (the reference pins an fp32 "
                        f"accumulator)", op=name, dtype=_name(dt))
        elif name in CARRY_OPS and isinstance(args[0], torch.Tensor):
            t = args[0]
            if t.is_floating_point() and _width(t.dtype) < 32:
                key = storage_key(t)
                self._carries[key] = self._carries.get(key, 0) + 1
                if self._carries[key] == 2:
                    self.emit(
                        f"a {_name(t.dtype)} tensor {tuple(t.shape)} is "
                        f"accumulated in place ({name}) step after step: "
                        f"a loop carry compounds a rounding every "
                        f"iteration; keep it float32 (the microbatch "
                        f"accumulator's and AdamW moments' contract)",
                        op=name, dtype=_name(t.dtype),
                        shape=list(t.shape))


def audit_dtype_flow(fn, args, *, name: str = "fn",
                     allow_narrow: Iterable[str] = ()) -> List[Finding]:
    """Run ``fn(*args)`` under the dispatch mode and return its dtype
    findings; ``allow_narrow`` blesses narrowings by label."""
    flow = _Flow(name, allow_narrow)
    with OpWatch(before=flow.before):
        fn(*args)
    return flow.findings


def accum_findings(fam: str, *, target: str = "") -> List[Finding]:
    """The fp32-accumulator contract of ``fam``'s C++ body, read from its
    ``SMEM_MODELS`` entry."""
    target = target or fam
    model = registry.SMEM_MODELS.get(fam)
    if model is None:
        return [Finding(check="dtype_flow", target=target, message=(
            f"family {fam!r} has no SMEM_MODELS entry, so no recorded "
            f"accumulator dtype"))]
    dt = model.accum
    if not dt.is_floating_point or _width(dt) < 32:
        return [Finding(check="dtype_flow", target=target, message=(
            f"{fam}'s body accumulates in {_name(dt)}: the kernels' "
            f"running minima, Gram sums and flash m / l / acc must be "
            f"float32 or wider"), details={"accum": _name(dt)})]
    return []
