"""The launches a call would make on the card (the port's counterpart of
``repro.analysis.launches``).

The reference traces a jaxpr and reads each ``pallas_call``'s grid and
BlockSpecs.  The port's kernels are CUDA sources launched through ctypes,
and its graph runs eagerly, so ``record_launches(fn, *args)`` runs ``fn``
(on CPU or ``meta`` tensors: plain versions or shapes, no card) and
records every call that goes through ``kernels.registry.resolve``: its op,
the route it took, its tensors' shapes and dtypes, and the launch the
``cuda`` route would make for it on an H100 (``sms`` SMs): the
``SplitPlan``, ``GramPlan`` or ``FlashPlan`` from the launchers' own
``split_plan``, ``gram_plan`` and ``flash_plan`` (the plan table
included), and each kernel's block size and dynamic shared-memory bytes
from ``registry.SMEM_MODELS``.  This is what the ``smem``, ``coverage``
and ``dtype_flow`` checks and ``compile_guard`` read.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import cws_hash, flash_attention, minmax_gram
from repro_torch.kernels import registry

__all__ = ["Launch", "record_launches", "recording", "launch_of"]


@dataclasses.dataclass(frozen=True)
class Launch:
    op: str
    impl: str                    # the route taken: cuda / reference / meta
    family: str
    shapes: Tuple[tuple, ...]    # of the call's tensor arguments, in order
    dtypes: Tuple[str, ...]
    options: Tuple[tuple, ...]   # its keyword arguments (b_i, window, ...)
    plan: object                 # the cuda route's plan; None without one
    kernels: Tuple[registry.KernelLaunch, ...]

    @property
    def signature(self) -> tuple:
        """What a captured graph keys on: op, shapes, dtypes, options and
        the plan."""
        return (self.op, self.shapes, self.dtypes, self.options, self.plan)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            yield from _tensors(a)
        elif dataclasses.is_dataclass(a) and not isinstance(a, type):
            yield from _tensors([getattr(a, f.name)
                                 for f in dataclasses.fields(a)])


def _num_hashes(args) -> int:
    second = args[1]
    return second.num_hashes if hasattr(second, "num_hashes") else \
        int(args[2])


def launch_of(op: str, impl: str, args, kwargs) -> Launch:
    """The ``Launch`` record of one call of ``op`` (``resolve``'s route
    ``impl``) with ``args`` / ``kwargs``, on an H100's SMs."""
    sms = registry.H100_SMS
    fam = registry.family(op)
    tensors = list(_tensors(args))
    plan = None
    if fam in registry.CWS_FAMILIES:
        n, d = args[0].shape
        k = _num_hashes(args)
        if n and k:
            plan = cws_hash.split_plan(n, d, k, sms,
                                       stored=fam in registry.STORED_FAMILIES,
                                       op=op)
    elif fam == "min_sum":
        (m, d), n = args[0].shape, args[1].shape[0]
        if m and n and d:
            plan = minmax_gram.gram_plan(m, n, d, sms, op="min_sum")
    elif fam in registry.FLASH_FAMILIES:
        q, k = args[0], args[1]
        b, sq, h, d = q.shape
        plan = flash_attention.flash_plan(b, sq, h, k.shape[2], d, q.dtype)
    model = registry.SMEM_MODELS.get(fam)
    kernels = tuple(model.launches(plan)) if (model and plan) else ()
    return Launch(op=op, impl=impl, family=fam,
                  shapes=tuple(tuple(t.shape) for t in tensors),
                  dtypes=tuple(str(t.dtype).replace("torch.", "")
                               for t in tensors),
                  options=tuple(sorted((k, v) for k, v in kwargs.items()
                                       if isinstance(v, (int, float, str)))),
                  plan=plan, kernels=kernels)


@contextlib.contextmanager
def recording():
    """Yields a list that gains a ``Launch`` for every call through
    ``registry.resolve`` inside the block."""
    seen: list = []

    def hook(op, impl, args, kwargs):
        seen.append(launch_of(op, impl, args, kwargs))

    registry.RESOLVE_HOOKS.append(hook)
    try:
        yield seen
    finally:
        registry.RESOLVE_HOOKS.remove(hook)


def record_launches(fn, *args, **kwargs) -> Tuple[Launch, ...]:
    """Run ``fn(*args, **kwargs)`` and return every launch it made
    through the registry, in order."""
    with recording() as seen:
        fn(*args, **kwargs)
    return tuple(seen)


# ---------------------------------------------------------------------------
# probes: one ragged call of each op, on the CPU
# ---------------------------------------------------------------------------

def _rows(n: int, d: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, d), generator=g)
    return torch.where(x < 0.4, torch.zeros_like(x), x)


def _params(d: int, k: int):
    from repro_torch.core.cws import make_cws_params
    return make_cws_params(torch.Generator().manual_seed(1), d, k)


def _key():
    from repro_torch.core.regen import prng_key
    return prng_key(3)


def _qkv(b=1, sq=100, sk=100, h=4, g=2, d=40):
    gen = torch.Generator().manual_seed(2)
    return (torch.randn((b, sq, h, d), generator=gen),
            torch.randn((b, sk, g, d), generator=gen),
            torch.randn((b, sk, g, d), generator=gen))


# op -> () -> (args, kwargs): the launch probe ``record_launches`` runs and
# the impl-signature probe ``numerics.audit_trio_signatures`` compares, at
# a ragged shape (n, D, k) = (13, 150, 70), Sq = Sk = 100, D = 40
PROBES = {
    "cws_encode": lambda: ((_rows(13, 150), _params(150, 70)), {"b_i": 8}),
    "cws_encode_rng": lambda: ((_rows(13, 150), _key(), 70), {"b_i": 8}),
    "cws_encode_packed": lambda: ((_rows(13, 150), _params(150, 70)),
                                  {"b_i": 8}),
    "cws_encode_rng_packed": lambda: ((_rows(13, 150), _key(), 70),
                                      {"b_i": 8}),
    "cws_hash": lambda: ((_rows(13, 150), _params(150, 70)), {}),
    "cws_hash_rng": lambda: ((_rows(13, 150), _key(), 70), {}),
    "min_sum": lambda: ((_rows(13, 99), _rows(9, 99, 1)), {}),
    "minmax_gram": lambda: ((_rows(13, 99), _rows(9, 99, 1)), {}),
    "flash_attention": lambda: (_qkv(), {"window": 0, "q_base": 0}),
    "flash_attention_step": lambda: (_qkv() + (None,),
                                     {"q_base": 0, "k_base": 0}),
}
