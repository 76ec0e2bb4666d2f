"""ctypes binding of the flash-attention CUDA kernel
(csrc/flash_attention.cu).

``flash_attention_call`` checks its tensors, allocates the output with
``torch.empty``, launches on PyTorch's current stream, raises if the C entry
reports a CUDA error, and counts its launches in the plain integer
``flash_attention_call.launches``.  Nothing here synchronises.

Replaces the JAX package's src/repro/kernels/flash_attention/kernel.py
_flash_kernel (via flash_attention_call).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import library

MAX_HEAD_DIM = 256


def _lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    if not getattr(lib, "_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                            i, st, st, st, st, i, i,
                                            ctypes.c_float, vp]
        lib.flash_attention_fwd.restype = i
        lib._bound = True
    return lib


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D), all f32 or all bf16, any
    strides with D contiguous.  Returns o (B, Sq, H, D) in q's dtype."""
    dev = C.check_device("flash_attention", q, k, v)
    if q.dtype not in C.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Skv, KVH, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH < 1 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, H % KVH == 0)")
    if D > MAX_HEAD_DIM or D % 4:
        raise ValueError(f"flash_attention takes head dims D <= "
                         f"{MAX_HEAD_DIM} with D % 4 == 0, got {D}")
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("flash_attention needs the head dim contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    dims = (0, 1, 2)
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        C.DTYPES[q.dtype], B, H, KVH, Sq, Skv, D, C.strides(q, dims),
        C.strides(k, dims), C.strides(v, dims), C.strides(o, dims),
        int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(D), C.stream(dev))
    C.check_cuda("flash_attention_fwd", err)
    flash_attention_call.launches += 1
    return o


flash_attention_call.launches = 0
