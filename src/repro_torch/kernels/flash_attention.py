"""Flash-attention forward: CUDA launcher beside its plain version.

Port of ``repro/kernels/flash_attention.py:flash_attention_fwd`` (TPU
kernel table row 8).  The function, for q (B, Sq, H, D) and k, v
(B, Sk, G, D) with H % G == 0 and r = H / G:

    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // r] / sqrt(D)) v[b, j, h // r]

over the keys visible from query row i: ``j <= i + q_base`` and, when
``window > 0``, ``j > i + q_base - window``.  Scores, the softmax and the
product with v are fp32 whatever the input dtype; the output is cast to
q's dtype after dividing by ``max(l, 1e-30)``.

``flash_attention_fwd_cuda`` runs the hand-written kernel
(``csrc/flash_attention.cu``) on CUDA tensors and counts its launches in
``LAUNCHES["flash_attention_fwd"]``; ``flash_attention_fwd_plain`` is the
same function in PyTorch tensor operations, chunked over query rows so
its (B, H, rows, Sk) score block stays bounded.  ``flash_attention_fwd``
chooses between them by the tensors' device, through the registry; a
launcher never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import flash_attention_library

LAUNCHES = {"flash_attention_fwd": 0}

NEG_INF = -1e30
# fp32 elements of one (B, H, rows, Sk) score block in the plain version
# (1 GiB)
_CHUNK_ELEMS = 1 << 28
_MAX_HEAD_DIM = 256
_GRID_YZ_MAX = 65535
_INT_MAX = 2 ** 31 - 1
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, G, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    g = k.shape[2]
    if g == 0 or h % g:
        raise ValueError(f"{h} query heads do not group over {g} kv heads")
    return b, sq, k.shape[1], h, g, d


def flash_attention_fwd(q, k, v, *, window: int = 0, q_base: int = 0):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    from repro_torch.kernels import registry
    return registry.resolve("flash_attention", q.device)(
        q, k, v, window=window, q_base=q_base)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, *, window: int = 0, q_base: int = 0):
    """The definition the kernel is held to, in PyTorch tensor operations
    (the CPU path; on the card, the yardstick of correctness only)."""
    b, sq, sk, h, g, d = _shapes(q, k, v)
    r = h // g
    scale = d ** -0.5
    qf = q.float().reshape(b, sq, g, r, d)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kj = torch.arange(sk, device=q.device)
    rows = max(1, _CHUNK_ELEMS // max(b * h * sk, 1))
    for i0 in range(0, sq, rows):
        qc = qf[:, i0:i0 + rows]
        n = qc.shape[1]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qc, kf) * scale
        pos = torch.arange(i0, i0 + n, device=q.device)[:, None] + q_base
        visible = kj[None, :] <= pos
        if window > 0:
            visible &= kj[None, :] > pos - window
        s.masked_fill_(~visible, NEG_INF)
        s.sub_(s.amax(-1, keepdim=True)).exp_()
        l = s.sum(-1)                                    # (b, g, r, n)
        o = torch.einsum("bgrqk,bkgd->bqgrd", s, vf)
        o /= l.permute(0, 3, 1, 2)[..., None].clamp_min(1e-30)
        out[:, i0:i0 + n] = o.reshape(b, n, h, d).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

def flash_attention_fwd_cuda(q, k, v, *, window: int = 0, q_base: int = 0):
    """Flash-attention kernel (replaces ``flash_attention_fwd``'s
    ``_flash_kernel``).  The kernel reads dense (B, S, heads, D) rows, so
    a strided q, k or v (a transposed or sliced view) is copied to a
    contiguous tensor here; the model's q, k and v already are."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"the CUDA flash-attention kernel takes CUDA "
                             f"tensors; {name} is not one")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} but q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16; got "
                         f"{q.dtype}")
    b, sq, sk, h, g, d = _shapes(q, k, v)
    if not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{_MAX_HEAD_DIM}")
    if h > _GRID_YZ_MAX or b > _GRID_YZ_MAX:
        raise ValueError(f"{b} batch rows or {h} heads exceed the grid")
    if max(sq, sk, int(window), int(q_base) + sq) > _INT_MAX or q_base < 0:
        raise ValueError(f"sequence lengths ({sq}, {sk}) or q_base "
                         f"{q_base} outside the kernel's int32 range")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = flash_attention_library().lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, g, d, int(window), int(q_base),
            ctypes.c_float(d ** -0.5), int(q.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out
