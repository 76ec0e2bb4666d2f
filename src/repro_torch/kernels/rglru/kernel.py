"""ctypes binding of the RG-LRU scan CUDA kernel (csrc/rglru.cu).

``rglru_scan_call`` checks its tensors, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream, raises if the C entry
reports a CUDA error, and counts its launches in the plain integer
``rglru_scan_call.launches``.  Nothing here synchronises.

Replaces the JAX package's src/repro/kernels/rglru/kernel.py _rglru_kernel
(via rglru_scan_call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import library

_MAX_GRID_Y = 65535


def _lib() -> ctypes.CDLL:
    lib = library("rglru")
    if not getattr(lib, "_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan.argtypes = [vp, vp, i, vp, vp, vp, i, i, i, vp]
        lib.rglru_scan.restype = i
        lib._bound = True
    return lib


def rglru_scan_call(log_a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None = None):
    """h_t = exp(log_a_t) h_{t-1} + b_t.  log_a, b: (B, S, C) contiguous,
    both f32 or both bf16; h0: (B, C) f32 or None (zeros).  Returns
    (h (B, S, C) f32, h_last (B, C) f32)."""
    tensors = (log_a, b) if h0 is None else (log_a, b, h0)
    dev = C.check_device("rglru_scan", *tensors)
    if log_a.dtype not in C.DTYPES or b.dtype != log_a.dtype:
        raise TypeError(f"rglru_scan takes f32 or bf16 log_a, b of one "
                        f"dtype, got {log_a.dtype}, {b.dtype}")
    if log_a.ndim != 3 or log_a.shape != b.shape:
        raise ValueError(f"expected log_a, b of one (B, S, C) shape, got "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}")
    B, S, Cn = log_a.shape
    if not (log_a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan takes contiguous log_a and b")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (B, Cn)
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be a contiguous ({B}, {Cn}) f32 tensor, "
                         f"got {tuple(h0.shape)} {h0.dtype}")
    if B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the kernel's grid")
    h = torch.empty((B, S, Cn), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, Cn), dtype=torch.float32, device=dev)
    err = _lib().rglru_scan(
        log_a.data_ptr(), b.data_ptr(), C.DTYPES[log_a.dtype],
        None if h0 is None else h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), B, S, Cn, C.stream(dev))
    C.check_cuda("rglru_scan", err)
    rglru_scan_call.launches += 1
    return h, h_last


rglru_scan_call.launches = 0
