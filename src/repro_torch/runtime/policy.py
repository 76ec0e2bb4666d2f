"""Wire-rate policy: drift-adaptive top-k ratio + resync economics.

SEAFL's headline metric is wall-clock/bytes-to-accuracy, and the downlink
is ratio-static without this module: every delta dispatch ships
``topk_ratio`` of the model, sized for the *worst* round (a β-limit
recovery step that moves the global a lot) and over-shipping on every
small aggregation step in between.  :class:`RatePolicy` adapts the ratio
to the observed round-over-round global drift instead.

Drift bands
-----------

The server observes one scalar per aggregation: ``d_t = ||g_t − g_{t−1}||``
(the round-over-round drift norm).  The policy normalises it by an EMA of
its own history — ``x_t = d_t / ema(d_{<t})`` — so the banding is
scale-free (no per-model tuning of absolute norms), then picks a ratio
from a small *discrete* set by binning ``x_t`` against ``edges``::

    x < edges[0]            -> ratios[0]   (quiet step: ship few coeffs)
    edges[i-1] <= x < e[i]  -> ratios[i]
    x >= edges[-1]          -> ratios[-1]  (recovery step: ship many)

Discreteness is load-bearing: the multicast encode-cache key is
``(base, target, scheme, ratio, chunk_elems)``, and the ratio is chosen
once per round (per *target* version), so every client dispatched on the
same hop still shares one cached encode — an adaptive ratio fragments
cache hops only *across* bands, never within one.

The chosen ratio applies to delta-coded dispatch
(``FLConfig.dispatch_ratio_policy='drift'``) and optionally to uplink
encoding (``FLConfig.uplink_ratio_policy='drift'``: a client trained from
version ``v`` uploads at the ratio chosen for ``v``).  The EMA state and
the per-version chosen ratios are checkpointed by the server — a restored
session re-encodes byte-identically.

Resync economics (``dispatch_resync_mode``)
-------------------------------------------

``'norm'`` (default, the original multicast rule): a client's
accumulated multicast residual triggers a personalized fold-in re-encode
when ``|r| > dispatch_resync × |Δ|``.

``'bytes'``: denominate the decision in projected wire bytes instead.  At
the hop's top-k granularity each kept coefficient carries ~``|Δ|²/k`` of
energy, so re-shipping the residual's ``|r|²`` energy needs about
``k·(|r|/|Δ|)²`` coefficients — ``ship_bytes = 8·k·(|r|/|Δ|)²`` (capped at
the dense 8·P: beyond that no single re-ship recovers it).  Resync when
that projection exceeds ``dispatch_resync ×`` one payload's wire bytes:
while the projected re-ship is under budget, continued tracking is free in
wire bytes (the fold-in costs the same payload either way), and the moment
it crosses, waiting longer only grows the eventual re-ship.  Dense schemes
(int8) have no coefficient budget to split, so they keep the norm rule.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "RATIO_POLICIES",
    "RESYNC_MODES",
    "RatePolicy",
    "DriftTracker",
    "needs_resync",
]

RATIO_POLICIES = ("static", "drift")
RESYNC_MODES = ("norm", "bytes")


@dataclass(frozen=True)
class RatePolicy:
    """Maps a normalised drift observation to a discrete top-k ratio."""
    mode: str = "static"                      # 'static' | 'drift'
    edges: tuple[float, ...] = (0.8, 1.6)     # ascending, on x = d/ema(d)
    ratios: tuple[float, ...] = (0.025, 0.05, 0.1)   # len(edges) + 1 bands

    def __post_init__(self):
        if self.mode not in RATIO_POLICIES:
            raise ValueError(f"ratio policy must be one of {RATIO_POLICIES},"
                             f" got {self.mode!r}")
        edges = tuple(float(e) for e in self.edges)
        ratios = tuple(float(r) for r in self.ratios)
        if len(ratios) != len(edges) + 1:
            raise ValueError(
                f"drift bands need len(ratios) == len(edges) + 1, got "
                f"{len(ratios)} ratios for {len(edges)} edges")
        if any(e <= 0 for e in edges) or \
                any(a >= b for a, b in zip(edges, edges[1:])):
            raise ValueError(f"drift band edges must be positive and "
                             f"strictly ascending, got {edges}")
        if any(not 0.0 < r <= 1.0 for r in ratios):
            raise ValueError(f"drift band ratios must be in (0, 1], "
                             f"got {ratios}")
        object.__setattr__(self, "edges", edges)
        object.__setattr__(self, "ratios", ratios)

    @classmethod
    def from_config(cls, cfg) -> "RatePolicy":
        """Build from an ``FLConfig``-shaped object (dispatch_ratio_policy /
        uplink_ratio_policy select who *consumes* the chosen ratio; the
        bands themselves are shared)."""
        for m in (cfg.dispatch_ratio_policy, cfg.uplink_ratio_policy):
            if m not in RATIO_POLICIES:
                raise ValueError(f"ratio policy must be one of "
                                 f"{RATIO_POLICIES}, got {m!r}")
        mode = ("drift" if "drift" in (cfg.dispatch_ratio_policy,
                                       cfg.uplink_ratio_policy)
                else "static")
        return cls(mode=mode, edges=tuple(cfg.drift_band_edges),
                   ratios=tuple(cfg.drift_band_ratios))

    @property
    def active(self) -> bool:
        return self.mode == "drift"

    def band(self, x: float) -> int:
        """Band index of a normalised drift observation."""
        return bisect_right(self.edges, float(x))

    def ratio_for(self, x: Optional[float],
                  telemetry=None) -> Optional[float]:
        """Chosen ratio for normalised drift ``x`` (None when the policy is
        static or nothing has been observed yet — caller keeps its static
        ratio).  ``telemetry`` (a :class:`~repro_torch.runtime.telemetry.Telemetry`)
        records band occupancy and the chosen ratio; the policy itself is
        frozen, so observability happens at the decision point."""
        if not self.active or x is None:
            return None
        b = self.band(x)
        r = self.ratios[b]
        if telemetry is not None:
            telemetry.counter("policy.band", band=b)
            telemetry.gauge("policy.ratio", r)
            telemetry.gauge("policy.drift_x", x)
            telemetry.histogram("policy.drift_x_hist", x)
        return r


class DriftTracker:
    """EMA normaliser for the round-over-round drift norm.

    ``observe(d)`` returns ``x = d / ema`` against the EMA *before* this
    observation (the first observation returns 1.0 — mid-band by
    definition), then folds ``d`` in.  Pure function of the drift sequence,
    so banding is deterministic and replays identically after a checkpoint
    restore (the EMA is one float of persisted state).
    """

    def __init__(self, beta: float = 0.8, ema: Optional[float] = None):
        if not 0.0 <= beta < 1.0:
            raise ValueError(f"drift EMA beta must be in [0, 1), got {beta}")
        self.beta = float(beta)
        self.ema = ema if ema is None else float(ema)

    def observe(self, drift: float) -> float:
        d = float(drift)
        if self.ema is None or self.ema <= 0.0:
            self.ema = d
            return 1.0
        x = d / self.ema
        self.ema = self.beta * self.ema + (1.0 - self.beta) * d
        return x

    def state_dict(self) -> dict:
        return {"beta": self.beta, "ema": self.ema}

    @classmethod
    def from_state(cls, state: Optional[dict],
                   beta: float) -> "DriftTracker":
        if not state:
            return cls(beta)
        return cls(beta=float(state.get("beta", beta)),
                   ema=state.get("ema"))


def needs_resync(mode: str, *, r_norm: float, hop_norm: float,
                 threshold: float, fmt=None,
                 param_size: int = 0) -> bool:
    """Should this client's accumulated dispatch residual trigger a
    personalized fold-in re-encode?

    ``threshold`` is ``FLConfig.dispatch_resync``; ``<= 0`` means resync on
    every delta (both modes — the "multicast semantics, per-client bytes"
    escape hatch).  ``fmt``/``param_size`` feed the
    byte projections of ``'bytes'`` mode (see module docstring); dense
    schemes fall back to the norm rule.
    """
    if mode not in RESYNC_MODES:
        raise ValueError(f"resync mode must be one of {RESYNC_MODES}, "
                         f"got {mode!r}")
    if threshold <= 0.0:
        return True
    if mode == "bytes" and fmt is not None:
        kept = fmt.kept_coeffs(param_size)
        if kept:
            x2 = (r_norm / max(hop_norm, 1e-12)) ** 2
            ship_bytes = 8.0 * min(kept * x2, float(param_size))
            return ship_bytes > threshold * fmt.payload_bytes(param_size)
    return r_norm > threshold * hop_norm + 1e-12
