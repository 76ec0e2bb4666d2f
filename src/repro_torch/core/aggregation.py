"""SEAFL adaptive weight aggregation — Eqs. (4)-(8) of the paper.

The weight rules (Eqs. 4-6) are what the flat-buffer engine
(kernels/seafl_agg/ops.py) applies to the Eq. (5) partials its kernels
reduce.  Their inputs are small (K,) vectors: tensors on any device, numpy
arrays or Python sequences; the result is an f32 tensor on the device of the
first tensor argument.

The rest is the reference pytree path of the JAX package's
``core/aggregation.py``: the same math over nested dicts of tensors whose
leaves carry a leading K axis where stacked (Eqs. 5, 7, 8, the delta-free
form, and the FedAvg / FedBuff / FedAsync rules).  The server runs the flat
engine; tests pin the two together.  This module imports nothing of the
server: the kernels' ops import it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import tree_leaves, tree_map
from repro_torch.utils import (
    scale, tree_dot, tree_lerp, tree_sqnorm, tree_weighted_sum,
)


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


def _row(stacked, k):
    return tree_map(lambda t: t[k], stacked)


def _n_rows(stacked) -> int:
    return next(tree_leaves(stacked))[1].shape[0]


def _per_k(stacked, global_params):
    """(w_k . g, |w_k|^2) for each row k of ``stacked``, two (K,) f32."""
    pairs = [(tree_dot(r, global_params), tree_sqnorm(r))
             for r in (_row(stacked, k) for k in range(_n_rows(stacked)))]
    return (torch.stack([d for d, _ in pairs]),
            torch.stack([s for _, s in pairs]))


def update_similarities(stacked_deltas, global_params):
    """cos(Delta_k, w_g) for each buffered update (leading dim K)."""
    g_sq = tree_sqnorm(global_params)
    dots, d_sqs = _per_k(stacked_deltas, global_params)
    return cosine_from_partials(dots, d_sqs, g_sq)


# Eq. (7) + Eq. (8): weighted aggregation and server mixing
def aggregate(stacked_params, weights):
    """w_new = sum_k p_k w_k  (leading dim K on every leaf)."""
    return tree_weighted_sum(stacked_params, weights)


def mix(global_params, w_new, theta):
    """w_{t+1} = (1 - theta) w_t + theta w_new."""
    return tree_lerp(global_params, w_new, theta)


def _diag(p, cos, staleness):
    return {"weights": p, "cos": cos,
            "staleness": _f32(staleness, p.device)}


def seafl_aggregate(global_params, stacked_params, stacked_deltas,
                    data_sizes, staleness, hyper: SeaflHyper):
    """One SEAFL server aggregation (Algorithm 1 lines 10-14).
    Returns (new_global, {"weights", "cos", "staleness"})."""
    cos = update_similarities(stacked_deltas, global_params)
    p = seafl_weights(data_sizes, staleness, cos, hyper)
    new_global = mix(global_params, aggregate(stacked_params, p),
                     hyper.theta)
    return new_global, _diag(p, cos, staleness)


def seafl_aggregate_from_params(global_params, stacked_params, data_sizes,
                                staleness, hyper: SeaflHyper):
    """Delta-free SEAFL aggregation: the Eq. (5) terms from (w_k . w_g,
    |w_k|^2, |w_g|^2), since Delta_k . w_g = w_k . w_g - |w_g|^2 and
    |Delta_k|^2 = |w_k|^2 - 2 w_k . w_g + |w_g|^2, so no delta exists."""
    g_sq = tree_sqnorm(global_params)
    wg_dots, w_sqs = _per_k(stacked_params, global_params)
    d_dot = wg_dots - g_sq
    d_sq = torch.clamp(w_sqs - 2.0 * wg_dots + g_sq, min=0.0)
    cos = cosine_from_partials(d_dot, d_sq, g_sq)
    p = seafl_weights(data_sizes, staleness, cos, hyper)
    new_global = mix(global_params, aggregate(stacked_params, p),
                     hyper.theta)
    return new_global, _diag(p, cos, staleness)


# Baseline weight rules (paper §VI comparison set)
def fedavg_weights(data_sizes):
    n = _f32(data_sizes)
    return n / torch.clamp(torch.sum(n), min=1.0)


def fedavg_aggregate(stacked_params, data_sizes):
    """Synchronous FedAvg: w_{t+1} = sum_k (n_k/n) w_k."""
    return aggregate(stacked_params, fedavg_weights(data_sizes))


def fedbuff_aggregate(global_params, stacked_deltas, eta_g):
    """FedBuff: w_{t+1} = w_t + eta_g * mean_k Delta_k (uniform weights)."""
    K = _n_rows(stacked_deltas)
    mean_delta = tree_weighted_sum(stacked_deltas,
                                   torch.full((K,), 1.0 / K))
    return tree_map(lambda g, d: g + scale(d.to(g.dtype), eta_g),
                    global_params, mean_delta)


def fedasync_mixing(staleness, alpha0=0.6, a=0.5):
    """FedAsync polynomial staleness discount: alpha_t = alpha0 (1+s)^-a."""
    s = _f32(staleness)
    return alpha0 * (1.0 + s) ** (-a)


def fedasync_aggregate(global_params, client_params, staleness, alpha0=0.6,
                       a=0.5):
    """FedAsync: immediate mixing with staleness-discounted rate."""
    return tree_lerp(global_params, client_params,
                     fedasync_mixing(staleness, alpha0, a))
