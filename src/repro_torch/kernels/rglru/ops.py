"""Public entry point of the RG-LRU scan.

CUDA tensors go to the hand-written kernel (kernel.py), CPU tensors to the
plain sequential version (ref.py).  There is no fallback from one to the
other.  Ragged S and C need no padding on either route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru import kernel as _k
from repro_torch.kernels.rglru.ref import rglru_scan_ref


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None):
    """h_t = exp(log_a_t) h_{t-1} + b_t over (B, S, C), from h0 (B, C) f32
    (zeros when None).  Takes the log decays, as the model's gates make
    them: the kernel exponentiates in registers.  Returns (h (B, S, C) f32,
    h_last (B, C) f32)."""
    if log_a.device.type == "cuda":
        return _k.rglru_scan_call(log_a, b, h0)
    if log_a.device.type != "cpu":
        raise ValueError(f"rglru_scan runs on cuda or cpu, got {log_a.device}")
    if h0 is None:
        h0 = torch.zeros((log_a.shape[0], log_a.shape[2]),
                         dtype=torch.float32)
    return rglru_scan_ref(torch.exp(log_a.to(torch.float32)), b, h0)
