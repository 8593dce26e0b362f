"""The dispatch mode the numeric audits run a site under: each ATen op
the site dispatches is shown to a visitor, with its inputs before it runs
and its outputs after, and then returned unchanged."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpWatch", "tensors_in", "storage_key", "op_name"]


def tensors_in(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from tensors_in(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from tensors_in(item)


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its StorageImpl), on any device."""
    return t.untyped_storage()._cdata


def op_name(func) -> str:
    """``aten.index_put_.default`` -> ``"index_put_"``."""
    return func.overloadpacket.__name__


class OpWatch(TorchDispatchMode):
    """``before(func, args, kwargs)`` and ``after(func, args, kwargs,
    out)`` around every op; results unchanged."""

    def __init__(self, before=None, after=None):
        super().__init__()
        self._before, self._after = before, after

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._before is not None:
            self._before(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._after is not None:
            self._after(func, args, kwargs, out)
        return out
