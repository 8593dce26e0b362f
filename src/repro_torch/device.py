"""Device choice for the port's entry points: CUDA unless told otherwise."""
from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count", "pin_fp32_reduction"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none rather than run
    quietly on the CPU.  An explicit device is taken as given, and a CUDA
    device without a card raises too.  A CUDA device comes back with its
    index, so that it compares equal to the device tensors report."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once (the kernels' plans)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def pin_fp32_reduction() -> None:
    """Have cuBLAS reduce bf16 and fp16 products in fp32: PyTorch lets it
    reduce them at the inputs' precision by default
    (``allow_bf16_reduced_precision_reduction`` and its fp16 twin),
    where the reference pins an fp32 accumulator on every sub-fp32 dot.
    The LM's entry points call this before their products run."""
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_fp16_reduced_precision_reduction = False
