"""ctypes binding of the SSD chunked-forward CUDA kernels (csrc/ssd.cu).

``ssd_forward_call`` checks its tensors, allocates the outputs and the
scratch of the four chunk-parallel kernels with ``torch.empty`` (C B^T per
chunk, the chunk states, the chunk decays), launches them in order on
PyTorch's current stream, raises if the C entry reports a CUDA error, and
counts one launch of the SSD forward in the plain integer
``ssd_forward_call.launches``.  Nothing here synchronises.

Replaces the JAX package's src/repro/kernels/ssd/kernel.py _ssd_kernel (via
ssd_forward_call), extended with an initial state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _common as C
from repro_torch.kernels import library

MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 128
_MAX_GRID_Y = 65535


def _lib() -> ctypes.CDLL:
    lib = library("ssd")
    if not getattr(lib, "_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.ssd_fwd.argtypes = [vp] * 11 + [i] * 6 + [st] * 5 + [vp]
        lib.ssd_fwd.restype = i
        lib._bound = True
    return lib


def ssd_forward_call(x, dt, a, Bm, Cm, *, chunk: int, h0=None):
    """x: (B, NH, S, hd); dt: (B, NH, S); a: (NH,); Bm, Cm: (B, S, ds); h0:
    (B, NH, hd, ds) or None (zeros).  All f32, any strides with the last dim
    contiguous (h0 and a contiguous).  Returns (y (B, NH, S, hd) -- a
    (B, NH, S, hd) view of a contiguous (B, S, NH, hd) tensor, the model's
    layout -- and the final state (B, NH, hd, ds))."""
    tensors = (x, dt, a, Bm, Cm) + (() if h0 is None else (h0,))
    dev = C.check_device("ssd_forward", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_forward takes f32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    if x.ndim != 4:
        raise ValueError(f"expected x (B, NH, S, hd), got {tuple(x.shape)}")
    B, NH, S, hd = x.shape
    ds = Bm.shape[-1]
    if (tuple(dt.shape) != (B, NH, S) or tuple(a.shape) != (NH,)
            or tuple(Bm.shape) != (B, S, ds) or Cm.shape != Bm.shape
            or (h0 is not None and tuple(h0.shape) != (B, NH, hd, ds))):
        raise ValueError(
            f"shapes do not match x (B, NH, S, hd) = {tuple(x.shape)}: dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, B {tuple(Bm.shape)}, C "
            f"{tuple(Cm.shape)}"
            + ("" if h0 is None else f", h0 {tuple(h0.shape)}"))
    if (x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1
            or not a.is_contiguous()
            or (h0 is not None and not h0.is_contiguous())):
        raise ValueError("ssd_forward needs the last dims contiguous and a, "
                         "h0 contiguous")
    Q = min(chunk, S)
    if not (1 <= Q <= MAX_CHUNK and 1 <= ds <= MAX_STATE
            and 1 <= hd <= MAX_HEAD_DIM and NH <= _MAX_GRID_Y
            and B <= _MAX_GRID_Y):
        raise ValueError(f"ssd_forward takes chunk <= {MAX_CHUNK}, ds <= "
                         f"{MAX_STATE}, hd <= {MAX_HEAD_DIM}; got chunk "
                         f"{chunk}, ds {ds}, hd {hd}")
    nc = -(-S // Q)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((B, S, NH, hd), **f32).transpose(1, 2)
    state = torch.empty((B, NH, hd, ds), **f32)
    cb = torch.empty((B, nc, MAX_CHUNK, MAX_CHUNK), **f32)
    states = torch.empty((B, nc, NH, hd, ds), **f32)
    decay = torch.empty((B, nc, NH), **f32)
    d3 = (0, 1, 2)
    err = _lib().ssd_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        state.data_ptr(), cb.data_ptr(), states.data_ptr(), decay.data_ptr(),
        B, NH, S, hd, ds, Q, C.strides(x, d3),
        C.strides(dt, d3), C.strides(Bm, (0, 1)), C.strides(Cm, (0, 1)),
        C.strides(y, d3), C.stream(dev))
    C.check_cuda("ssd_fwd", err)
    ssd_forward_call.launches += 1
    return y, state


ssd_forward_call.launches = 0
