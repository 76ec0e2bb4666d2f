"""Plain PyTorch versions of the seafl_agg kernels (f32 accumulation).

The wrappers in ops.py take these for tensors on the CPU; on the card they
are what chip_smoke.py and the gpu tests hold the CUDA kernels against.
"""
from __future__ import annotations

import torch


def similarity_partials_ref(deltas, global_flat):
    """(K, P), (P,) -> (K, 4) f32: [d.g, |d|^2, |g|^2, 0] per row."""
    d = deltas.to(torch.float32)
    g = global_flat.to(torch.float32)
    dot = d @ g
    dsq = torch.sum(d * d, dim=1)
    gsq = torch.sum(g * g).expand(dot.shape)
    return torch.stack([dot, dsq, gsq, torch.zeros_like(dot)], dim=1)


def similarity_partials_from_params_ref(stacked, global_flat):
    """Delta-free form: partials of d_k = w_k - g from client params."""
    w = stacked.to(torch.float32)
    g = global_flat.to(torch.float32)
    return similarity_partials_ref(w - g[None, :], g)


def weighted_agg_ref(weights, stacked, global_flat, theta, keep=None):
    """keep * g + theta * (w @ W), returned in g's dtype; ``keep`` is
    1 - theta in f32 by default, and g is left out where it is 0."""
    w = weights.to(torch.float32)
    p = stacked.to(torch.float32)
    g = global_flat.to(torch.float32)
    th = torch.tensor(float(theta), dtype=torch.float32, device=g.device)
    mix = th * (w @ p)
    if keep is None:
        return ((1.0 - th) * g + mix).to(global_flat.dtype)
    if keep == 0:
        return mix.to(global_flat.dtype)
    kp = torch.tensor(float(keep), dtype=torch.float32, device=g.device)
    return (kp * g + mix).to(global_flat.dtype)
