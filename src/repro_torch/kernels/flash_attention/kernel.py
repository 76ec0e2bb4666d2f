"""ctypes binding of the flash-attention CUDA kernels: two instances of one
function on the tensor cores, csrc/flash_attention_tc.cu (``wgmma`` + TMA)
and csrc/flash_attention_mma.cu (``mma.sync`` in 3xTF32).

Instance rule (:func:`instance`, decided on the host before any launch),
from the head dim D of q and k and Dv of v: bf16 with (D, Dv) in
``TC_HEAD_DIMS`` -- (64, 64), (128, 128), (256, 256) and MLA's (192, 128)
-- goes to "tc", which also needs layouts TMA can read
(:func:`tma_compatible`) and raises on any other; every other D <= 256 and
Dv <= D, each a multiple of 4, f32 or bf16, goes to "mma"; any other shape
is refused.  There is no fallback from one instance to the other.  The
scale is 1/sqrt(D) whatever Dv is, as the reference's.

``flash_attention_call`` checks its tensors, allocates the output with
``torch.empty``, launches on PyTorch's current stream, raises if the C entry
reports a CUDA error, and counts its launches in plain integers:
``flash_attention_call.launches`` (all), ``.launches_tc`` and
``.launches_mma`` (each instance).  Nothing here synchronises.

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
TC_HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))


def instance(dtype: torch.dtype, head_dim: int,
             v_head_dim: int | None = None) -> str:
    """The instance rule for q/k head dim D = ``head_dim`` and v head dim
    Dv = ``v_head_dim`` (D when None): "tc" for bf16 with (D, Dv) in
    ``TC_HEAD_DIMS``; "mma" for every other D <= 256 and Dv <= D, each a
    multiple of 4 (f32 or bf16); ValueError for a shape neither takes."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if not 4 <= head_dim <= MAX_HEAD_DIM or head_dim % 4:
        raise ValueError(f"flash_attention takes head dims 4 <= D <= "
                         f"{MAX_HEAD_DIM} with D % 4 == 0, got {head_dim}")
    if not 4 <= dv <= head_dim or dv % 4:
        raise ValueError(f"flash_attention takes value head dims 4 <= Dv <= "
                         f"D = {head_dim} with Dv % 4 == 0, got {dv}")
    if dtype == torch.bfloat16 and (head_dim, dv) in TC_HEAD_DIMS:
        return "tc"
    return "mma"


def tma_compatible(strides, data_ptr: int) -> bool:
    """Whether TMA can read a bf16 tensor: last dim contiguous, every other
    stride a multiple of 16 bytes (8 elements), base address 16-byte
    aligned."""
    return (strides[-1] == 1 and data_ptr % 16 == 0
            and all(s % 8 == 0 for s in strides[:-1]))


def _bind(name: str, with_dtype: bool) -> ctypes.CDLL:
    """Library ``name`` with its entry's argument types set: q, k, v, o,
    [dtype,] B, H, KVH, Sq, Skv, D, Dv, four stride arrays, causal, window,
    scale, stream."""
    lib = library(name)
    if not getattr(lib, "_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        f = lib.flash_attention_fwd_mma if with_dtype else \
            lib.flash_attention_fwd_tc
        f.argtypes = ([vp] * 4 + [i] * (8 if with_dtype else 7) + [st] * 4
                      + [i, i, ctypes.c_float, vp])
        f.restype = i
        lib._bound = True
    return lib


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, KVH, D); v: (B, Skv, KVH, Dv) with
    Dv <= D; all f32 or all bf16, any strides with the head dim contiguous.
    Returns o (B, Sq, H, Dv) in q's dtype."""
    dev = C.check_device("flash_attention", q, k, v)
    if q.dtype not in C.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"expected q (B, Sq, H, D), k (B, Skv, KVH, D) and "
                         f"v (B, Skv, KVH, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KVH, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or KVH < 1 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, H % KVH == 0)")
    inst = instance(q.dtype, D, Dv)
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("flash_attention needs the head dim contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    dims = (0, 1, 2)
    tail = (C.strides(q, dims), C.strides(k, dims), C.strides(v, dims),
            C.strides(o, dims), int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            C.stream(dev))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if inst == "tc":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not tma_compatible(t.stride(), t.data_ptr()):
                raise ValueError(
                    f"flash_attention (bf16, D={D}, Dv={Dv}, tensor "
                    f"cores): {name} "
                    f"has strides {t.stride()} at address {t.data_ptr():#x};"
                    f" TMA needs strides of 16-byte multiples and a 16-byte "
                    f"aligned base")
        lib = _bind("flash_attention_tc", with_dtype=False)
        err = lib.flash_attention_fwd_tc(*ptrs, B, H, KVH, Sq, Skv, D, Dv,
                                         *tail)
        C.check_cuda("flash_attention_fwd_tc", err)
        flash_attention_call.launches_tc += 1
    else:
        lib = _bind("flash_attention_mma", with_dtype=True)
        err = lib.flash_attention_fwd_mma(*ptrs, C.DTYPES[q.dtype], B, H,
                                          KVH, Sq, Skv, D, Dv, *tail)
        C.check_cuda("flash_attention_fwd_mma", err)
        flash_attention_call.launches_mma += 1
    flash_attention_call.launches += 1
    return o


def reset_launch_counts() -> None:
    flash_attention_call.launches = 0
    flash_attention_call.launches_tc = 0
    flash_attention_call.launches_mma = 0


reset_launch_counts()
