"""Determinism audit and the impls' signature agreement (the counterpart
of ``repro.analysis.numerics``).

``audit_determinism(fn, args)`` runs the site under a dispatch mode and
flags, with ``check="determinism"``, what can break the port's
bit-identical guarantees (streamed == full batch, resume ==
uninterrupted, a rank count's bits fixed):

  * a float draw (``rand``, ``randn``, ``bernoulli``, ``randperm``,
    ``multinomial``, ``normal_``, ``uniform_``, ...) from the global
    generator instead of an explicit one (the reference flags
    backend-dependent RNG; the port's counter-based draws are
    ``core/regen.py``'s, and every other draw names its generator);
  * an order-sensitive float scatter (``index_add_``, ``scatter_add_``,
    ``scatter_reduce_``, ``index_put_(accumulate=True)``) unless the site
    blesses it with its reason (``allow={"index_add": "why"}``); integer
    scatters are exempt, integer addition being associative, and so are
    scatters where no two terms meet (one index a row, as a gather's
    backward; concrete indices without repeats);
  * a collective outside a registered collective site (those carry the
    ``collectives`` check's own contract).

``audit_trio_signatures()`` checks, for every op of ``registry.IMPLS``,
that its impls (``cuda``, ``reference``, ``meta``) take the same
parameters (a ``cuda`` launcher may add keyword-only launch options with
defaults, such as ``plan=`` and ``body=``, which the registry never
passes), and that ``reference`` on CPU tensors and ``meta`` on ``meta``
tensors return the same shapes and dtypes on the op's probe
(``launches.PROBES``).  The values of ``cuda`` against ``reference`` are
compared on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import inspect
from typing import Iterable, List, Mapping, Optional

import torch

from repro_torch.kernels import registry
from repro_torch.launch import collectives
from ._dispatch import OpWatch, op_name
from .report import Finding

__all__ = ["audit_determinism", "audit_trio_signatures", "DRAWS",
           "ORDER_SENSITIVE_SCATTERS", "signature_params"]

DRAWS = ("rand", "randn", "rand_like", "randn_like", "bernoulli",
         "bernoulli_", "randperm", "multinomial", "normal", "normal_",
         "uniform_", "exponential_", "randint", "randint_like", "random_",
         "poisson", "cauchy_", "log_normal_", "geometric_")
ORDER_SENSITIVE_SCATTERS = ("index_add", "index_add_", "scatter_add",
                            "scatter_add_", "scatter_reduce",
                            "scatter_reduce_", "index_put", "index_put_",
                            "_index_put_impl_")


def _accumulates(name: str, args, kwargs) -> bool:
    if not name.startswith(("index_put", "_index_put_impl")):
        return True
    acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
    return bool(acc)


def _one_term_each(name: str, args) -> bool:
    """True where no two terms can land on one element, so the order of
    the sums cannot matter: a ``scatter_add`` / ``scatter_reduce`` whose
    index holds one entry along the scattered dim (a gather's backward,
    one index a row), or concrete ``index_add`` / ``index_put`` indices
    without repeats."""
    if name.startswith("scatter"):
        index = args[2] if len(args) > 2 else None
        dim = args[1] if len(args) > 1 else None
        return isinstance(index, torch.Tensor) and isinstance(dim, int) \
            and index.shape[dim] == 1
    if name.startswith("index_add"):
        index = args[2] if len(args) > 2 else None
    else:
        idx = args[1] if len(args) > 1 else ()
        index = idx[0] if isinstance(idx, (tuple, list)) and len(idx) == 1 \
            else None
    if not isinstance(index, torch.Tensor) or index.device.type == "meta":
        return False
    return index.unique().numel() == index.numel()


def audit_determinism(fn, args, *, name: str = "fn",
                      allow: Mapping[str, str] | Iterable[str] = ()
                      ) -> List[Finding]:
    """Run ``fn(*args)`` and flag reproducibility hazards.  ``allow``
    blesses ops (``"index_add"`` covers ``index_add_``) or collective
    kinds by name, with the reason as the mapping's value."""
    allow = dict(allow) if isinstance(allow, Mapping) else \
        {a: "" for a in allow}
    findings: List[Finding] = []
    seen = set()

    def emit(message, **details):
        if message not in seen:
            seen.add(message)
            findings.append(Finding(check="determinism", target=name,
                                    message=message, details=details))

    def blessed(op: str) -> bool:
        return op in allow or op.rstrip("_") in allow

    def before(func, a, kw):
        op = op_name(func)
        if blessed(op):
            return
        if op in DRAWS and kw.get("generator") is None:
            emit(f"{op} draws from the global generator: its stream "
                 f"depends on every draw before it in the process; pass "
                 f"an explicit torch.Generator (or use core/regen.py's "
                 f"counter-based draws)", op=op)
        elif op in ORDER_SENSITIVE_SCATTERS and _accumulates(op, a, kw) \
                and not _one_term_each(op, a):
            target = a[0] if a and isinstance(a[0], torch.Tensor) else None
            if target is not None and target.is_floating_point():
                emit(f"{op} on {target.dtype}: a float scatter-accumulate "
                     f"sums in an order the backend chooses; if this site "
                     f"relies on a fixed order (a serial CPU loop, a "
                     f"stable sort) or on exact sums, bless it with "
                     f"allow={{{op.rstrip('_')!r}: reason}}",
                     op=op, dtype=str(target.dtype))

    def on_collective(call):
        if not blessed(call["kind"]):
            emit(f"{call['kind']} over {call['axes']} outside a registered "
                 f"collective site: register the caller as one (its axes "
                 f"and counts are then checked) or bless the kind on this "
                 f"site", kind=call["kind"], axes=list(call["axes"]))

    collectives.CALL_HOOKS.append(on_collective)
    try:
        with OpWatch(before=before):
            fn(*args)
    finally:
        collectives.CALL_HOOKS.remove(on_collective)
    return findings


def signature_params(fn):
    """(name, kind) of each parameter a registry call can pass: a
    keyword-only parameter with a default that the call does not pass
    (a launch option) is left out."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return tuple((p.name, p.kind) for p in sig.parameters.values())


def _agree(ref, other) -> bool:
    """``other`` takes ``ref``'s parameters, in order, plus optional
    keyword-only ones."""
    if other[:len(ref)] != ref:
        return False
    extra = other[len(ref):]
    return all(kind == inspect.Parameter.KEYWORD_ONLY for _, kind in extra)


def _sig_of(out) -> list:
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), str(out.dtype))]
    if isinstance(out, (tuple, list)):
        return [s for o in out for s in _sig_of(o)]
    return []


def _to_meta(obj):
    if isinstance(obj, torch.Tensor):
        return torch.empty(obj.shape, dtype=obj.dtype, device="meta")
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_meta(o) for o in obj) if not hasattr(
            obj, "_fields") else type(obj)(*(_to_meta(o) for o in obj))
    return obj


def audit_trio_signatures(families: Optional[Iterable[str]] = None, *,
                          impls=None) -> List[Finding]:
    """The signature half of the impls' agreement; an ``impls`` override
    lets a fixture show a drifted impl."""
    from .launches import PROBES as probes
    impls = registry.IMPLS if impls is None else impls
    fams = tuple(families) if families else None
    findings: List[Finding] = []
    for op, table in impls.items():
        if fams is not None and registry.family(op) not in fams \
                and op not in fams:
            continue
        ref = signature_params(table.get("reference"))
        for impl, fn in sorted(table.items()):
            params = signature_params(fn)
            if ref is None or params is None or _agree(ref, params):
                continue
            findings.append(Finding(
                check="determinism", target=op,
                message=(f"impl {impl!r} of {op!r} takes "
                         f"({', '.join(p for p, _ in params)}) but the "
                         f"reference takes ({', '.join(p for p, _ in ref)}): "
                         f"the registry passes one argument set to all of "
                         f"them"), details={"impl": impl}))
        if op not in probes:
            findings.append(Finding(
                check="determinism", target=op,
                message=(f"op {op!r} has no probe in launches.PROBES: the "
                         f"impls' output signatures cannot be compared")))
            continue
        if "meta" not in table:
            continue
        args, kwargs = probes[op]()
        try:
            want = _sig_of(table["reference"](*args, **kwargs))
            got = _sig_of(table["meta"](*_to_meta(args), **kwargs))
        except Exception as e:   # noqa: BLE001 - a failing impl is a finding
            findings.append(Finding(
                check="determinism", target=op,
                message=f"the probe of {op!r} failed: {type(e).__name__}: "
                        f"{e}"))
            continue
        if got != want:
            findings.append(Finding(
                check="determinism", target=op,
                message=(f"impl 'meta' of {op!r} returns {got} but "
                         f"'reference' returns {want} on the probe: the "
                         f"dry run would count other shapes than the card "
                         f"runs"), details={"meta": got, "reference": want}))
    return findings
