"""PyTorch/CUDA port of the featurize→score serving path.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names so each counterpart is easy to find.  It imports torch,
numpy and the standard library only.  CWS encoding runs through
hand-written CUDA kernels (``csrc/cws_split.cu``) on CUDA tensors and
through their plain PyTorch versions on CPU tensors.

Entry points (pipeline construction, bundle loading, the serving service)
run on CUDA unless the caller passes ``device="cpu"``; with no device and
no card they raise instead of falling back to the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
