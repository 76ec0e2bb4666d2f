"""Public entry point of flash attention, in the model's layout.

CUDA tensors go to the hand-written kernel (kernel.py), which reads the
(B, S, H, D) layout through strides and masks the ragged edge itself, so
nothing is transposed or padded.  CPU tensors go to the plain version
(ref.py).  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None):
    """q (B, Sq, H, D); k (B, Skv, KVH, D); v (B, Skv, KVH, Dv), Dv <= D
    -> o (B, Sq, H, Dv), q's dtype; scores scaled by 1/sqrt(D)."""
    if q.device.type == "cuda":
        return _k.flash_attention_call(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, window=window)
    return o.transpose(1, 2)
