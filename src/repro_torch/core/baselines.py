"""Baseline FL algorithm configurations (paper §VI comparison set).

The JAX package's ``core/baselines.py`` against the port's ``FLConfig``.
All baselines share SeaflServer's machinery with different policy settings:
FedAvg is the synchronous lower bound, FedAsync the fully-asynchronous upper
bound (K=1), FedBuff the closest semi-asynchronous counterpart (uniform
weights, no staleness limit).
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.server import FLConfig


def fedavg(base: FLConfig) -> FLConfig:
    return replace(base, algorithm="fedavg", staleness_limit=None)


def fedasync(base: FLConfig, alpha0: float = 0.6, poly_a: float = 0.5) -> FLConfig:
    return replace(base, algorithm="fedasync", buffer_size=1,
                   staleness_limit=None,
                   fedasync_alpha0=alpha0, fedasync_poly_a=poly_a)


def fedbuff(base: FLConfig, eta_g: float = 1.0) -> FLConfig:
    return replace(base, algorithm="fedbuff", staleness_limit=None,
                   fedbuff_eta_g=eta_g)


def seafl(base: FLConfig, beta: float | None = 10.0) -> FLConfig:
    return replace(base, algorithm="seafl", staleness_limit=beta)


def seafl2(base: FLConfig, beta: float | None = 10.0) -> FLConfig:
    return replace(base, algorithm="seafl2", staleness_limit=beta)


BASELINES = {"fedavg": fedavg, "fedasync": fedasync, "fedbuff": fedbuff,
             "seafl": seafl, "seafl2": seafl2}
