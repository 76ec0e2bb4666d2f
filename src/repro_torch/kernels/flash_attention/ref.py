"""Plain PyTorch version of the flash-attention kernel: exact (non-blocked)
attention with the kernel's mask rules, f32 scores and softmax.

The wrapper in ops.py takes it for CPU tensors; on the card it is what
chip_smoke.py and the gpu tests hold the CUDA kernel against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, kv_len=None):
    """q: (B, H, Sq, D); k: (B, KVH, Skv, D); v: (B, KVH, Skv, Dv) -> (B,
    H, Sq, Dv) in q's dtype, the scores scaled by 1/sqrt(D) (MLA's Dv <
    D included).  Keys seen by query q: k <= q (causal), k > q - window,
    k < kv_len; a row with none gives 0."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    G = H // KVH
    kq = torch.repeat_interleave(k.to(torch.float32), G, dim=1)
    vq = torch.repeat_interleave(v.to(torch.float32), G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kq) \
        / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= k_pos < kv_len
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1)[:, None]
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
