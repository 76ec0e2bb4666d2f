"""ctypes binding of the flash-attention CUDA kernels: the tensor-core
instance (csrc/flash_attention_tc.cu) and the SIMT instance
(csrc/flash_attention.cu).

Instance rule (:func:`uses_tensor_cores`, decided on the host before any
launch): bf16 q, k, v with head dim D in {64, 128, 256} go to the
tensor-core instance (wgmma + TMA), which also needs layouts TMA can read
(:func:`tma_compatible`) and raises on any other; everything else (f32, other
D) goes to the SIMT instance.  There is no fallback from one to the other.

``flash_attention_call`` checks its tensors, allocates the output with
``torch.empty``, launches on PyTorch's current stream, raises if the C entry
reports a CUDA error, and counts its launches in plain integers:
``flash_attention_call.launches`` (all), ``.launches_tc`` and
``.launches_simt`` (each instance).  Nothing here synchronises.

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
TC_HEAD_DIMS = (64, 128, 256)


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """The instance rule: bf16 with D in {64, 128, 256} runs on the
    tensor-core instance, every other dtype and D on the SIMT instance."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


def tma_compatible(strides, data_ptr: int) -> bool:
    """Whether TMA can read a bf16 tensor: last dim contiguous, every other
    stride a multiple of 16 bytes (8 elements), base address 16-byte
    aligned."""
    return (strides[-1] == 1 and data_ptr % 16 == 0
            and all(s % 8 == 0 for s in strides[:-1]))


def _bind(name: str, with_dtype: bool) -> ctypes.CDLL:
    """Library ``name`` with its entry's argument types set: q, k, v, o,
    [dtype,] B, H, KVH, Sq, Skv, D, four stride arrays, causal, window,
    scale, stream."""
    lib = library(name)
    if not getattr(lib, "_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        f = lib.flash_attention_fwd if with_dtype else \
            lib.flash_attention_fwd_tc
        f.argtypes = ([vp] * 4 + [i] * (7 if with_dtype else 6) + [st] * 4
                      + [i, i, ctypes.c_float, vp])
        f.restype = i
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
    tail = (C.strides(q, dims), C.strides(k, dims), C.strides(v, dims),
            C.strides(o, dims), int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            C.stream(dev))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if uses_tensor_cores(q.dtype, D):
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not tma_compatible(t.stride(), t.data_ptr()):
                raise ValueError(
                    f"flash_attention (bf16, D={D}, tensor cores): {name} "
                    f"has strides {t.stride()} at address {t.data_ptr():#x};"
                    f" TMA needs strides of 16-byte multiples and a 16-byte "
                    f"aligned base")
        lib = _bind("flash_attention_tc", with_dtype=False)
        err = lib.flash_attention_fwd_tc(*ptrs, B, H, KVH, Sq, Skv, D, *tail)
        C.check_cuda("flash_attention_fwd_tc", err)
        flash_attention_call.launches_tc += 1
    else:
        lib = _bind("flash_attention", with_dtype=True)
        err = lib.flash_attention_fwd(*ptrs, C.DTYPES[q.dtype], B, H, KVH,
                                      Sq, Skv, D, *tail)
        C.check_cuda("flash_attention_fwd", err)
        flash_attention_call.launches_simt += 1
    flash_attention_call.launches += 1
    return o


def reset_launch_counts() -> None:
    flash_attention_call.launches = 0
    flash_attention_call.launches_tc = 0
    flash_attention_call.launches_simt = 0


reset_launch_counts()
