"""Plain PyTorch version of the RG-LRU scan kernel: the sequential
recurrence, in f32.

The wrapper in ops.py takes it for CPU tensors; on the card it is what
chip_smoke.py and the gpu tests hold the CUDA kernel against.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """h_t = a_t h_{t-1} + b_t.  a, b: (B, S, C); h0: (B, C) ->
    (h (B, S, C) f32, h_last (B, C) f32)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    h = h0.to(torch.float32)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
