"""Plain PyTorch reference of one SEAFL aggregation, Eqs. (4)-(8) of the
paper: the staleness factor, the importance of each update by its cosine
with the global, the normalised weights, the weighted model and the
server's mix.  Independent of the program; f32 as the configuration
states, sums over P taken in blocks in f64 so the reference's own rounding
stays far below the program's.

``precision="tf32"`` is the control: both operands of every product over P
rounded to TF32 (10 mantissa bits, as the card's TF32 products round them)
before the same sums.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 26


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to the nearest TF32 value (ties away from
    zero, as the card's conversion rounds)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def partials(rows: list[torch.Tensor], g: torch.Tensor,
             precision: str = "f32") -> torch.Tensor:
    """(K, 3) f64: d_k . g, |d_k|^2 and |g|^2 with d_k = w_k - g."""
    out = torch.zeros((len(rows), 3), dtype=torch.float64)
    for i in range(0, g.numel(), BLOCK):
        gb = g[i:i + BLOCK].float()
        gq = tf32(gb) if precision == "tf32" else gb
        gsq = (gq.double() * gq.double()).sum().cpu()
        for k, w in enumerate(rows):
            d = w[i:i + BLOCK].float() - gb
            if precision == "tf32":
                d = tf32(d)
            dd = d.double()
            out[k, 0] += (dd * gq.double()).sum().cpu()
            out[k, 1] += (dd * dd).sum().cpu()
            out[k, 2] += gsq
    return out


def weights(part: torch.Tensor, sizes, staleness, alpha: float, mu: float,
            beta: float) -> torch.Tensor:
    """Eqs. (4)-(6): p_k proportional to (n_k / n) (gamma_k + s_k), with
    gamma_k = alpha beta / (staleness_k + beta) and s_k = mu (cos_k + 1) / 2,
    cos_k = d_k . g / sqrt(|d_k|^2 |g|^2).  f64, (K,)."""
    n = torch.as_tensor(sizes, dtype=torch.float64)
    st = torch.as_tensor(staleness, dtype=torch.float64)
    cos = part[:, 0] / torch.sqrt(part[:, 1] * part[:, 2] + 1e-12)
    gamma = alpha * beta / (st + beta)
    s = mu * (cos.clamp(-1.0, 1.0) + 1.0) / 2.0
    p = n / n.sum() * (gamma + s)
    return p / p.sum()


def mix(rows: list[torch.Tensor], g: torch.Tensor, p: torch.Tensor,
        theta: float, precision: str = "f32") -> torch.Tensor:
    """Eqs. (7)-(8): (1 - theta) g + theta sum_k p_k w_k, returned in f32
    (blocks of P computed in f64, the products' operands in ``precision``)."""
    out = torch.empty_like(g, dtype=torch.float32)
    pk = p.to(torch.float32)
    if precision == "tf32":
        pk = tf32(pk)
    pk = pk.double().tolist()
    for i in range(0, g.numel(), BLOCK):
        acc = (1.0 - theta) * g[i:i + BLOCK].double()
        for k, w in enumerate(rows):
            wb = w[i:i + BLOCK].float()
            if precision == "tf32":
                wb = tf32(wb)
            acc += theta * pk[k] * wb.double()
        out[i:i + BLOCK] = acc.float()
    return out


def aggregate(rows, g, sizes, staleness, alpha, mu, beta, theta,
              precision: str = "f32"):
    """(new global (P,) f32, weights (K,) f64) of one aggregation."""
    p = weights(partials(rows, g, precision), sizes, staleness, alpha, mu,
                beta)
    return mix(rows, g, p, theta, precision), p
