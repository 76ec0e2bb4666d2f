"""Public entry points of the flat-buffer aggregation engine.

The single engine behind every server algorithm (seafl / seafl2 / fedbuff /
fedavg / fedasync): SEAFL's Eq. (4)-(8) adaptive rule plus the baselines'
weight rules, each one fused ``weighted_aggregate`` pass over the (K, P)
buffer.  The delta-free entry point (``seafl_aggregate_flat_from_params``)
takes the Eq. (5) cosine terms straight from client params, so no delta
buffer ever exists.

Routing is by the tensors' device: CUDA tensors go to the hand-written
kernels (kernel.py), CPU tensors to the plain versions (ref.py).  There is no
fallback from one to the other.  Neither pads P: the kernels mask the ragged
tail themselves, so the (K, P) buffer is never copied.

Every entry point returns a new tensor; the global it is given is never
written (the server's version history aliases it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregation import (
    SeaflHyper, cosine_from_partials, seafl_weights,
)
from repro_torch.kernels.seafl_agg import kernel as _k
from repro_torch.kernels.seafl_agg import ref as _ref


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"seafl_agg: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"seafl_agg runs on cuda or cpu, got {dev}")


def similarity_partials(deltas, global_flat):
    """(K, P), (P,) -> (K, 4) f32 partials of explicit deltas."""
    if _on_cuda(deltas, global_flat):
        return _k.sim_partials_call(deltas, global_flat)
    return _ref.similarity_partials_ref(deltas, global_flat)


def similarity_partials_from_params(stacked, global_flat):
    """Delta-free Eq. (5) partials from client params (K, P) directly."""
    if _on_cuda(stacked, global_flat):
        return _k.sim_partials_from_params_call(stacked, global_flat)
    return _ref.similarity_partials_from_params_ref(stacked, global_flat)


def weighted_aggregate(weights, stacked, global_flat, theta):
    """(1 - theta) * g + theta * (weights @ stacked), in g's dtype."""
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=stacked.device)
    if _on_cuda(weights, stacked, global_flat):
        return _k.weighted_agg_call(weights.contiguous(), stacked,
                                    global_flat, float(theta))
    return _ref.weighted_agg_ref(weights, stacked, global_flat, theta)


def _weights_from_partials(part, data_sizes, staleness, alpha, mu, beta,
                           use_importance, use_staleness):
    cos = cosine_from_partials(part[:, 0], part[:, 1], part[:, 2])
    hyper = SeaflHyper(alpha=alpha, mu=mu, beta=beta,
                       use_importance=use_importance,
                       use_staleness=use_staleness)
    return seafl_weights(data_sizes, staleness, cos, hyper)


def seafl_aggregate_flat(global_flat, stacked_params, stacked_deltas,
                         data_sizes, staleness, alpha, mu, beta, theta,
                         use_importance=True, use_staleness=True):
    """Fused flat-buffer SEAFL aggregation (Eqs. 4-8), explicit deltas.

    Two passes: one over the deltas (partials), one over the params
    (weighted mix).  Returns (new_global (P,), weights (K,))."""
    part = similarity_partials(stacked_deltas, global_flat)
    p = _weights_from_partials(part, data_sizes, staleness, alpha, mu, beta,
                               use_importance, use_staleness)
    return weighted_aggregate(p, stacked_params, global_flat, theta), p


def seafl_aggregate_flat_from_params(global_flat, stacked_params, data_sizes,
                                     staleness, alpha, mu, beta, theta,
                                     use_importance=True, use_staleness=True):
    """Delta-free fused SEAFL aggregation: the server hot path.

    The (K, P) buffer holds client params only; d_k = w_k - w_g is formed
    inside the partials kernel.  Two passes over one buffer.
    Returns (new_global (P,), weights (K,))."""
    part = similarity_partials_from_params(stacked_params, global_flat)
    p = _weights_from_partials(part, data_sizes, staleness, alpha, mu, beta,
                               use_importance, use_staleness)
    return weighted_aggregate(p, stacked_params, global_flat, theta), p


# Baseline weight rules on the same engine (paper §VI comparison set).
# Every algorithm is one fused (1-theta)*g + theta*(w @ buffer) pass.

def fedavg_aggregate_flat(global_flat, stacked_params, data_sizes):
    """FedAvg: w_{t+1} = sum_k (n_k/n) w_k  (theta = 1 drops the old global)."""
    n = torch.as_tensor(data_sizes, dtype=torch.float32,
                        device=stacked_params.device)
    w = n / torch.clamp(torch.sum(n), min=1.0)
    return weighted_aggregate(w, stacked_params, global_flat, 1.0), w


def fedbuff_aggregate_flat(global_flat, stacked_params, eta_g):
    """FedBuff, delta-free: w_t + eta_g mean_k(w_k - w_t)
    == (1 - eta_g) w_t + eta_g mean_k w_k  (uniform weights)."""
    k = stacked_params.shape[0]
    w = torch.full((k,), 1.0 / k, dtype=torch.float32,
                   device=stacked_params.device)
    return weighted_aggregate(w, stacked_params, global_flat, eta_g), w


def fedasync_aggregate_flat(global_flat, client_flat, staleness,
                            alpha0=0.6, a=0.5):
    """FedAsync: immediate K=1 mixing at the poly-discounted rate
    alpha_t = alpha0 (1+s)^-a (theta = alpha_t on the same fused pass),
    computed in f32 on the host."""
    alpha = (np.float32(alpha0)
             * (np.float32(1.0) + np.float32(staleness)) ** np.float32(-a))
    w = torch.ones((1,), dtype=torch.float32, device=client_flat.device)
    return weighted_aggregate(w, client_flat[None], global_flat, float(alpha))
