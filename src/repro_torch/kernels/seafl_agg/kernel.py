"""ctypes binding of the seafl_agg CUDA kernels (csrc/seafl_agg.cu).

Each wrapper checks its tensors, allocates the output (and the partials'
workspace) with ``torch.empty``, launches on PyTorch's current stream, raises
if the C entry reports a CUDA error, and counts its launches in the plain
integer ``<wrapper>.launches``.  Nothing here synchronises.

  sim_partials_from_params_call — replaces kernel.py _sim_from_params_kernel
  sim_partials_call             — replaces kernel.py _sim_kernel
  weighted_agg_call             — replaces kernel.py _agg_kernel
(file and function names of the JAX package's src/repro/kernels/seafl_agg).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import library
from repro_torch.kernels._common import DTYPES as _DTYPES
from repro_torch.kernels._common import MAX_SMEM as _MAX_SMEM
from repro_torch.kernels._common import check_cuda as _check_cuda
from repro_torch.kernels._common import stream as _stream

# each thread of a block walks this many elements of P (grid-stride), so the
# grid is ceil(P / (256 * 16)) blocks: many waves, a small tail.  The
# autotuner's knob ``block_p`` (runtime/autotune.py) is the elements of P one
# block covers, which sets the grid; None keeps this default.
_THREADS = 256
_ELEMS_PER_THREAD = 16
DEFAULT_BLOCK_P = _THREADS * _ELEMS_PER_THREAD
_MAX_GRID_X = 2**31 - 1
_MAX_GRID_Y = 65535
_ROWS_PER_BLOCK = 16          # kRows in the source


def _lib() -> ctypes.CDLL:
    lib = library("seafl_agg")
    if not getattr(lib, "_seafl_bound", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.seafl_sim_partials.argtypes = [vp, i, vp, i, i, ll, i, vp, i, vp,
                                           vp]
        lib.seafl_sim_partials.restype = i
        lib.seafl_weighted_agg.argtypes = [vp, vp, i, vp, i, i, ll,
                                           ctypes.c_float, ctypes.c_float,
                                           vp, i, vp]
        lib.seafl_weighted_agg.restype = i
        lib._seafl_bound = True
    return lib


def _check_rows(stacked: torch.Tensor, global_flat: torch.Tensor,
                min_rows: int = 1) -> None:
    if stacked.device.type != "cuda" or global_flat.device != stacked.device:
        raise ValueError("seafl_agg kernels take CUDA tensors on one device, "
                         f"got {stacked.device} and {global_flat.device}")
    for t, what in ((stacked, "rows"), (global_flat, "global")):
        if t.dtype not in _DTYPES:
            raise TypeError(f"seafl_agg kernels take f32 or bf16 {what}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"seafl_agg kernels take contiguous {what}")
    if stacked.ndim != 2 or global_flat.ndim != 1 \
            or stacked.shape[1] != global_flat.shape[0]:
        raise ValueError(f"expected (K, P) rows and a (P,) global, got "
                         f"{tuple(stacked.shape)} and "
                         f"{tuple(global_flat.shape)}")
    if stacked.shape[0] < min_rows:
        raise ValueError(f"this seafl_agg kernel needs K >= {min_rows} rows")


def _grid(p: int, block_p=None) -> int:
    """Blocks of the grid over P: ceil(P / block_p).  A block covers its
    share with a grid-stride loop, so any positive ``block_p`` is exact;
    only the partials kernel's summation order depends on it."""
    bp = DEFAULT_BLOCK_P if block_p is None else int(block_p)
    if bp < 1:
        raise ValueError(f"block_p must be a positive element count, got "
                         f"{block_p!r}")
    nblocks = max(1, -(-p // bp))
    if nblocks > _MAX_GRID_X:
        raise ValueError(f"block_p={bp} makes {nblocks} blocks over P={p}, "
                         f"more than the grid holds")
    return nblocks


def _sim_partials(stacked: torch.Tensor, global_flat: torch.Tensor,
                  from_params: bool, block_p=None) -> torch.Tensor:
    _check_rows(stacked, global_flat)
    k, p = stacked.shape
    if -(-k // _ROWS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"K={k} rows exceed the partials kernel's grid")
    dev = stacked.device
    nblocks = _grid(p, block_p)
    ws = torch.empty((nblocks, k, 3), dtype=torch.float32, device=dev)
    out = torch.empty((k, 4), dtype=torch.float32, device=dev)
    err = _lib().seafl_sim_partials(
        stacked.data_ptr(), _DTYPES[stacked.dtype], global_flat.data_ptr(),
        _DTYPES[global_flat.dtype], k, p, int(from_params), ws.data_ptr(),
        nblocks, out.data_ptr(), _stream(dev))
    _check_cuda("seafl_sim_partials", err)
    return out


def sim_partials_from_params_call(stacked: torch.Tensor,
                                  global_flat: torch.Tensor,
                                  block_p=None) -> torch.Tensor:
    """(K, P) client params, (P,) global -> (K, 4) f32
    [d.g, |d|^2, |g|^2, 0] with d = w_k - g formed in registers."""
    out = _sim_partials(stacked, global_flat, from_params=True,
                        block_p=block_p)
    sim_partials_from_params_call.launches += 1
    return out


def sim_partials_call(deltas: torch.Tensor, global_flat: torch.Tensor,
                      block_p=None) -> torch.Tensor:
    """(K, P) explicit deltas, (P,) global -> (K, 4) f32 partials."""
    out = _sim_partials(deltas, global_flat, from_params=False,
                        block_p=block_p)
    sim_partials_call.launches += 1
    return out


def keep_of(theta: float) -> float:
    """The f32 factor ``1 - theta`` of the global, as the kernel took it."""
    return float(np.float32(1.0) - np.float32(theta))


def weighted_agg_call(weights: torch.Tensor, stacked: torch.Tensor,
                      global_flat: torch.Tensor, theta: float,
                      block_p=None, keep=None) -> torch.Tensor:
    """(K,) f32 weights, (K, P) rows, (P,) global, host float theta ->
    keep * g + theta * (w @ rows), a new (P,) tensor in g's dtype.
    ``keep`` defaults to ``keep_of(theta)``; with ``keep=0`` g is not read
    (a pod's partial mix on a pod-sharded buffer, where K may be 0)."""
    _check_rows(stacked, global_flat, min_rows=0)
    k, p = stacked.shape
    if weights.device != stacked.device or weights.dtype != torch.float32 \
            or tuple(weights.shape) != (k,) or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous ({k},) f32 tensor on "
                         f"{stacked.device}, got {tuple(weights.shape)} "
                         f"{weights.dtype} on {weights.device}")
    if 4 * k > _MAX_SMEM:
        raise ValueError(f"K={k} weights exceed the kernel's shared memory")
    dev = stacked.device
    out = torch.empty_like(global_flat)
    nblocks = _grid(p, block_p)
    err = _lib().seafl_weighted_agg(
        weights.data_ptr(), stacked.data_ptr(), _DTYPES[stacked.dtype],
        global_flat.data_ptr(), _DTYPES[global_flat.dtype], k, p,
        float(theta), keep_of(theta) if keep is None else float(keep),
        out.data_ptr(), nblocks, _stream(dev))
    _check_cuda("seafl_weighted_agg", err)
    weighted_agg_call.launches += 1
    return out


sim_partials_from_params_call.launches = 0
sim_partials_call.launches = 0
weighted_agg_call.launches = 0

KERNELS = (sim_partials_from_params_call, sim_partials_call, weighted_agg_call)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
