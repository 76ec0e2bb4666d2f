"""Public entry point of the SSD chunked forward.

CUDA tensors go to the hand-written kernel (kernel.py), which walks the
chunks of ``chunk`` steps, reads any strided layout with the last dim
contiguous and masks the ragged last chunk, so nothing is padded.  CPU
tensors go to the plain sequential SSM (ref.py), which computes the same
function without chunking.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as _k
from repro_torch.kernels.ssd.ref import ssd_ref


def ssd_forward(x, dt, a, Bm, Cm, *, chunk: int = 256, h0=None):
    """x: (B, NH, S, hd); dt: (B, NH, S); a: (NH,); Bm, Cm: (B, S, ds); h0:
    (B, NH, hd, ds) or None.  Returns (y (B, NH, S, hd), state
    (B, NH, hd, ds)), f32."""
    if x.device.type == "cuda":
        return _k.ssd_forward_call(x, dt, a, Bm, Cm, chunk=chunk, h0=h0)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_forward runs on cuda or cpu, got {x.device}")
    return ssd_ref(x, dt, a, Bm, Cm, h0)
