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

The sharded route: where the buffer's rows shard over 'pod', an entry
point is handed each rank's own committed rows (``core.buffer.LocalRows``)
in place of the (K, P) tensor.  B1 runs on those rows (a row's partials do
not depend on the others); the (K, 4) partials are assembled in arrival
order with one small sum across 'pod' (each row's from the one pod that
holds it, zeros from the rest); the Eq. (4)-(6) weights are computed on
every rank alike; B2 mixes each rank's rows with their weights, the global
entering on the first pod only (``keep``), and one (P,) sum across 'pod'
gives the new global.  The buffer's rows never cross a rank.  The route
goes by the local tensors' device as above.

Tuned grid (opt-in): every entry point takes ``block_p``, the elements of
P one CUDA block covers, as runtime/autotune.py tunes it.  ``None`` is the
kernels' default grid, the untuned call byte for byte.  It only sets the
grid: the port never routes a CUDA tensor to the plain version, and on the
CPU it is ignored (the plain version has no grid).

Kernel timing (opt-in): ``set_kernel_timing(telemetry)`` makes each
aggregate entry point record its wall time as a ``kernel.<name>_us``
histogram, the JAX package's names: on CUDA the device is synchronised
before the clock starts and after the call returns, so the time is that
of a finished result.  A measurement mode: it changes overlap, never
values.  Off (the default) nothing synchronises.  The server installs it
for the length of each of its own calls (core/server.py).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (
    SeaflHyper, cosine_from_partials, seafl_weights,
)
from repro_torch.core.buffer import LocalRows
from repro_torch.device import timed
from repro_torch.kernels.seafl_agg import kernel as _k
from repro_torch.kernels.seafl_agg import ref as _ref

# The Telemetry that times the aggregate entry points (FLConfig.
# telemetry_kernels), or None: a measurement mode, not protocol state.
_KERNEL_TEL = None


def set_kernel_timing(telemetry: Optional[object]) -> Optional[object]:
    """Install (or clear, with None) the Telemetry that times the public
    aggregate entry points; returns the one it replaces."""
    global _KERNEL_TEL
    prev, _KERNEL_TEL = _KERNEL_TEL, telemetry
    return prev


def _entry(fn):
    """A public aggregate entry point: installed kernel timing times the
    call under the function's name.  The first argument is the global."""
    name = fn.__name__

    @functools.wraps(fn)
    def entry(global_flat, *args, **kw):
        return timed(_KERNEL_TEL, name, global_flat.device, fn,
                     global_flat, *args, **kw)
    return entry


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


def similarity_partials(deltas, global_flat, block_p=None):
    """(K, P), (P,) -> (K, 4) f32 partials of explicit deltas."""
    if _on_cuda(deltas, global_flat):
        return _k.sim_partials_call(deltas, global_flat, block_p=block_p)
    return _ref.similarity_partials_ref(deltas, global_flat)


def similarity_partials_from_params(stacked, global_flat, block_p=None):
    """Delta-free Eq. (5) partials from client params (K, P) directly; of
    a pod-sharded buffer's :class:`LocalRows`, the whole buffer's (K, 4)
    in arrival order on every rank."""
    if isinstance(stacked, LocalRows):
        return _partials_across_pods(stacked, global_flat, block_p)
    if _on_cuda(stacked, global_flat):
        return _k.sim_partials_from_params_call(stacked, global_flat,
                                                block_p=block_p)
    return _ref.similarity_partials_from_params_ref(stacked, global_flat)


def _partials_across_pods(local: LocalRows, global_flat, block_p):
    part = torch.zeros((local.k, 4), dtype=torch.float32,
                       device=global_flat.device)
    if local.index:
        part[local.index] = similarity_partials_from_params(
            local.rows, global_flat, block_p)
    return local.shards.reduce(part)


def weighted_aggregate(weights, stacked, global_flat, theta, block_p=None):
    """(1 - theta) * g + theta * (weights @ stacked), in g's dtype; of a
    pod-sharded buffer's :class:`LocalRows` (``weights`` over all K), each
    pod's mix of its own rows summed across 'pod'."""
    if isinstance(stacked, LocalRows):
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=stacked.rows.device)[stacked.index]
        keep = _k.keep_of(theta) if stacked.shards.index == 0 else 0.0
        return stacked.shards.reduce(_mix(w, stacked.rows, global_flat,
                                          theta, block_p, keep))
    return _mix(torch.as_tensor(weights, dtype=torch.float32,
                                device=stacked.device),
                stacked, global_flat, theta, block_p)


def _mix(weights, stacked, global_flat, theta, block_p, keep=None):
    if _on_cuda(weights, stacked, global_flat):
        return _k.weighted_agg_call(weights.contiguous(), stacked,
                                    global_flat, float(theta),
                                    block_p=block_p, keep=keep)
    return _ref.weighted_agg_ref(weights, stacked, global_flat, theta, keep)


def _weights_from_partials(part, data_sizes, staleness, alpha, mu, beta,
                           use_importance, use_staleness):
    cos = cosine_from_partials(part[:, 0], part[:, 1], part[:, 2])
    hyper = SeaflHyper(alpha=alpha, mu=mu, beta=beta,
                       use_importance=use_importance,
                       use_staleness=use_staleness)
    return seafl_weights(data_sizes, staleness, cos, hyper)


@_entry
def seafl_aggregate_flat(global_flat, stacked_params, stacked_deltas,
                         data_sizes, staleness, alpha, mu, beta, theta,
                         use_importance=True, use_staleness=True,
                         block_p=None):
    """Fused flat-buffer SEAFL aggregation (Eqs. 4-8), explicit deltas.

    Two passes: one over the deltas (partials), one over the params
    (weighted mix).  Returns (new_global (P,), weights (K,))."""
    part = similarity_partials(stacked_deltas, global_flat, block_p)
    p = _weights_from_partials(part, data_sizes, staleness, alpha, mu, beta,
                               use_importance, use_staleness)
    return weighted_aggregate(p, stacked_params, global_flat, theta,
                              block_p), p


@_entry
def seafl_aggregate_flat_from_params(global_flat, stacked_params, data_sizes,
                                     staleness, alpha, mu, beta, theta,
                                     use_importance=True, use_staleness=True,
                                     block_p=None):
    """Delta-free fused SEAFL aggregation: the server hot path.

    The (K, P) buffer holds client params only; d_k = w_k - w_g is formed
    inside the partials kernel.  Two passes over one buffer.
    Returns (new_global (P,), weights (K,))."""
    part = similarity_partials_from_params(stacked_params, global_flat,
                                           block_p)
    p = _weights_from_partials(part, data_sizes, staleness, alpha, mu, beta,
                               use_importance, use_staleness)
    return weighted_aggregate(p, stacked_params, global_flat, theta,
                              block_p), p


# Baseline weight rules on the same engine (paper §VI comparison set).
# Every algorithm is one fused (1-theta)*g + theta*(w @ buffer) pass.

@_entry
def fedavg_aggregate_flat(global_flat, stacked_params, data_sizes,
                          block_p=None):
    """FedAvg: w_{t+1} = sum_k (n_k/n) w_k  (theta = 1 drops the old global)."""
    n = torch.as_tensor(data_sizes, dtype=torch.float32,
                        device=global_flat.device)
    w = n / torch.clamp(torch.sum(n), min=1.0)
    return weighted_aggregate(w, stacked_params, global_flat, 1.0,
                              block_p), w


@_entry
def fedbuff_aggregate_flat(global_flat, stacked_params, eta_g, block_p=None):
    """FedBuff, delta-free: w_t + eta_g mean_k(w_k - w_t)
    == (1 - eta_g) w_t + eta_g mean_k w_k  (uniform weights)."""
    k = (stacked_params.k if isinstance(stacked_params, LocalRows)
         else stacked_params.shape[0])
    w = torch.full((k,), 1.0 / k, dtype=torch.float32,
                   device=global_flat.device)
    return weighted_aggregate(w, stacked_params, global_flat, eta_g,
                              block_p), w


@_entry
def fedasync_aggregate_flat(global_flat, client_flat, staleness,
                            alpha0=0.6, a=0.5, block_p=None):
    """FedAsync: immediate K=1 mixing at the poly-discounted rate
    alpha_t = alpha0 (1+s)^-a (theta = alpha_t on the same fused pass),
    computed in f32 on the host."""
    alpha = (np.float32(alpha0)
             * (np.float32(1.0) + np.float32(staleness)) ** np.float32(-a))
    w = torch.ones((1,), dtype=torch.float32, device=client_flat.device)
    return weighted_aggregate(w, client_flat[None], global_flat, float(alpha),
                              block_p)
