"""Plain PyTorch version of the SSD kernel: the sequential (per-timestep)
SSM, the literal Mamba-2 definition, O(S hd ds).

  S_t = exp(dt_t a) S_{t-1} + dt_t (x_t B_t^T);  y_t = S_t C_t

The wrapper in ops.py takes it for CPU tensors; on the card it is what
chip_smoke.py and the gpu tests hold the CUDA kernel against.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, a, Bm, Cm, h0=None):
    """x: (B, NH, S, hd); dt: (B, NH, S); a: (NH,); Bm/Cm: (B, S, ds);
    h0: (B, NH, hd, ds) or None (zeros).  Returns (y (B, NH, S, hd),
    final state (B, NH, hd, ds)), f32."""
    B, NH, S, hd = x.shape
    ds = Bm.shape[-1]
    x = x.to(torch.float32)
    dt = dt.to(torch.float32)
    Bm = Bm.to(torch.float32)
    Cm = Cm.to(torch.float32)
    state = (torch.zeros((B, NH, hd, ds), dtype=torch.float32,
                         device=x.device)
             if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, :, t] * a[None, :])          # (B, NH)
        state = (decay[..., None, None] * state
                 + dt[:, :, t, None, None] * x[:, :, t, :, None]
                 * Bm[:, None, None, t, :])
        ys.append(torch.einsum("bnhs,bs->bnh", state, Cm[:, t]))
    return torch.stack(ys, dim=2), state
