"""What every ctypes kernel binding of the port shares: dtype codes, the
current stream, the error check and the device check; and the H100's
spec-sheet rates that every roofline bound of the port is computed from."""
from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 227 * 1024          # dynamic shared memory a block may use (H100)

# H100 SXM data sheet (dense, 700 W): HBM3 bandwidth, the f32 rate outside
# the tensor cores, the bf16 tensor-core rate, and the rate of f32-accurate
# products on the tensor cores (3xTF32: three TF32 products each, 495 / 3).
# Spec-sheet numbers, not measurements: they bound times from below
# (chip_smoke.py's bound_ms, runtime/autotune.py's predicted_us).
HBM_BYTES_PER_S = 3.35e12
# NVLink 4, H100 SXM data sheet: 900 GB/s both ways a GPU, 450 GB/s each
# way (a spec-sheet number: the dry run's least time for a collective)
NVLINK_BYTES_PER_S = 450e9
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
F32_TC_FLOPS_PER_S = 495e12 / 3


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: cudaError_t {err} after launch")


def check_device(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it."""
    devs = {t.device for t in tensors}
    dev = devs.pop()
    if devs or dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def strides(t: torch.Tensor, dims) -> ctypes.Array:
    """The element strides of ``t`` along ``dims`` as a C long long array."""
    return (ctypes.c_longlong * len(dims))(*(t.stride(d) for d in dims))
