"""SEAFL adaptive weight rules — Eqs. (4)-(6) of the paper.

The weight rules the flat-buffer engine (kernels/seafl_agg/ops.py) applies to
the Eq. (5) partials the kernels reduce.  Inputs are small (K,) vectors;
they may be tensors on any device, numpy arrays or Python sequences, and the
result is an f32 tensor on the device of the first tensor argument.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SeaflHyper:
    """Aggregation hyper-parameters (paper Table I + §VI defaults)."""
    alpha: float = 3.0        # staleness weight (Fig. 4 optimum)
    mu: float = 1.0           # similarity weight (Fig. 4 optimum)
    beta: float = 10.0        # staleness limit (Fig. 2b optimum)
    theta: float = 0.8        # server mixing rate (paper §VI)
    use_importance: bool = True    # Fig. 2c ablation switch
    use_staleness: bool = True


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# Eq. (4): staleness factor
def staleness_factor(staleness, alpha, beta):
    """gamma_t^k = alpha * beta / ((t - t_k) + beta).  Vectorised over K."""
    s = _f32(staleness)
    return alpha * beta / (s + beta)


# Eq. (5): importance via cosine similarity (from partial reductions)
def cosine_from_partials(dot, d_sq, g_sq, eps=1e-12):
    return dot * torch.rsqrt(d_sq * g_sq + eps)


def importance_factor(cos_sim, mu):
    """s_t^k = mu * (Theta + 1) / 2, Theta in [-1, 1] -> s in [0, mu]."""
    return mu * (torch.clamp(cos_sim, -1.0, 1.0) + 1.0) / 2.0


# Eq. (6): adaptive aggregation weights (normalised)
def seafl_weights(data_sizes, staleness, cos_sims, hyper: SeaflHyper):
    """p_t^k ∝ (|D_k|/|D|) * (gamma_t^k + s_t^k), normalised to sum 1."""
    cos = _f32(cos_sims)
    n = _f32(data_sizes, cos.device)
    d = n / torch.clamp(torch.sum(n), min=1.0)
    gamma = (staleness_factor(_f32(staleness, cos.device), hyper.alpha,
                              hyper.beta)
             if hyper.use_staleness else
             torch.full_like(d, hyper.alpha))
    s = (importance_factor(cos, hyper.mu)
         if hyper.use_importance else
         torch.full_like(d, hyper.mu / 2.0))
    p = d * (gamma + s)
    return p / torch.clamp(torch.sum(p), min=1e-12)
