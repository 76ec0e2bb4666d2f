"""Run-health monitor: online anomaly detectors + SLO gates over telemetry.

The telemetry layer records raw counters, histograms and sim/wall spans;
this layer *interprets* them online.  A :class:`RunMonitor` is fed once per
aggregation round with the simulator's history record (plus the compact
telemetry snapshot riding inside it) and runs a fixed set of pluggable
detectors, each watching one first-class SEAFL failure mode:

============================  =========================================
detector                      fires when
============================  =========================================
``plateau``                   EMA-smoothed eval metric slope ~ 0 over a
                              window (run silently stopped learning)
``divergence``                EMA slope clearly negative (run unlearning)
``staleness_blowup``          round staleness_max far above the running
                              quantile of its own history
``straggler_dominance``       one client owns an outsized share of all
                              sim-clock train+upload span time vs the
                              fleet median (sync-wait hostage)
``buffer_starvation``         inter-aggregation sim-time gap far above
                              the running median gap (buffer starving)
``spill_pressure``            sync-wait spill grows the (K, P) buffer in
                              nearly every recent round
``band_saturation``           the drift policy pins (almost) all rounds
                              in one ``policy.band`` (bands mis-tuned)
``byte_budget``               cumulative up+down wire bytes exceed the
                              configured budget
``cohort_fragmentation``      cohorts ~ tracked clients while cohort
                              mode is on (sharing has collapsed)
``resync_storm``              dispatch/mismatch resyncs per round exceed
                              a sustained rate (EF residuals thrashing)
``schedule_skew``             a scheduler policy has starved an eligible
                              client past the participation floor
============================  =========================================

Each firing emits a typed :class:`Alert` that lands in the history record
(``rec['alerts']``), the ``--log-jsonl`` stream, and the console round
line; an optional SLO policy (``FLConfig.slo``) turns chosen alerts into a
fail-fast stop (the simulator breaks its event loop and
``launch/train.py`` exits nonzero).

Like telemetry and cohorts, the monitor is **off by default**
(``FLConfig.monitor='off'``) and bit-identical off: it only ever *reads*
the record/registry, draws no RNG, and is never checkpointed (a restored
run restarts its detectors cold — they re-warm within one window).

The port of the JAX package's ``runtime/monitor.py``: host code, the same
detectors, thresholds, window logic and alert text, so the two packages
raise equal alerts on equal records.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.runtime.telemetry import Telemetry, of

SEVERITIES = ("info", "warn", "error")

#: every detector name an Alert / SLO spec may carry
DETECTOR_NAMES = (
    "plateau", "divergence", "staleness_blowup", "straggler_dominance",
    "buffer_starvation", "spill_pressure", "band_saturation",
    "byte_budget", "cohort_fragmentation", "resync_storm",
    "schedule_skew",
)


@dataclass(frozen=True)
class Alert:
    """One detector firing: typed, JSON-able, ordered by round."""
    detector: str
    severity: str            # 'info' | 'warn' | 'error'
    round: int
    sim_time: float
    message: str
    evidence: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"detector": self.detector, "severity": self.severity,
                "round": self.round, "sim_time": self.sim_time,
                "message": self.message, "evidence": dict(self.evidence)}


@dataclass(frozen=True)
class MonitorConfig:
    """Detector thresholds.  Defaults are tuned so a healthy run — the CI
    trace_smoke fleet included — emits zero alerts; every threshold is a
    plain field so experiments can tighten or relax per-detector."""
    # rounds before trend/straggler detectors may fire at all
    warmup_rounds: int = 5
    # a fired detector stays quiet this many rounds (alert storms are the
    # monitor's own failure mode)
    cooldown_rounds: int = 5
    # --- plateau / divergence: slope of the EMA-smoothed eval metric over
    # a full window of rounds
    acc_window: int = 8
    acc_ema_beta: float = 0.5          # ema = beta*ema + (1-beta)*acc
    plateau_slope: float = 1e-3        # |slope|/round below => plateau
    diverge_slope: float = 5e-3        # slope/round below -this => diverge
    # --- staleness blowup: round staleness_max vs running quantile of its
    # own history
    staleness_quantile: float = 0.9
    staleness_factor: float = 3.0      # cur > factor * running quantile
    staleness_floor: float = 4.0       # and cur > this absolute floor
    staleness_min_history: int = 5
    # --- straggler dominance: per-client share of cumulative sim-clock
    # train+upload span time
    straggler_factor: float = 4.0      # top client > factor * fleet median
    straggler_share: float = 0.5       # and > this share of total busy
    straggler_min_clients: int = 4
    # --- buffer starvation: inter-aggregation gap vs running median gap
    starve_factor: float = 8.0
    starve_min_gap_s: float = 1.0
    starve_min_history: int = 5
    # --- sync-wait spill pressure: buffer.spill_grow deltas over a window
    spill_window: int = 5
    spill_rounds: int = 4              # fire when >= this many grew
    # --- drift-band saturation: policy.band occupancy
    band_window: int = 10              # observations before judging
    band_frac: float = 0.95
    # --- byte budget: cumulative up+down wire bytes (None = unlimited)
    byte_budget: Optional[int] = None
    # --- cohort fragmentation: cohorts / tracked clients, sustained
    frag_frac: float = 0.9
    frag_min_clients: int = 8
    frag_consecutive: int = 3
    # --- resync storm: (dispatch.resync + cohort.mismatch_resync) deltas
    resync_window: int = 5
    resync_per_round: float = 2.0
    # --- schedule skew: participation floor — fire when any *eligible
    # idle* client has gone this many sim seconds unselected (a ranked
    # scheduler starving the slow tail; the schedulers' own fairness
    # floor, Scheduler.fairness_seconds = 60, rotates clients in well
    # below this, so a firing means the floor was defeated)
    skew_max_wait: float = 300.0


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted non-empty list."""
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _counter_sum(snap: Dict[str, Any], *names: str) -> float:
    """Sum counter keys matching any bare name or labelled variant."""
    total = 0.0
    counters = snap.get("counters", {})
    for k, v in counters.items():
        base = k.split("[", 1)[0]
        if base in names:
            total += v
    return total


class Detector:
    """One online anomaly detector.  Subclasses keep their own running
    state and return freshly-fired alerts from :meth:`observe`; the
    shared cooldown lives here so no detector can storm."""

    name = "?"
    severity = "warn"

    def __init__(self, cfg: MonitorConfig):
        self.cfg = cfg
        self._last_fired: Dict[str, int] = {}

    def observe(self, rec: dict, snap: dict,
                busy: Dict[str, Dict[str, float]]) -> List[Alert]:
        raise NotImplementedError

    def _fire(self, rec: dict, message: str, *, name: Optional[str] = None,
              severity: Optional[str] = None, **evidence) -> List[Alert]:
        name = name or self.name
        rnd = int(rec.get("round", 0))
        last = self._last_fired.get(name)
        if last is not None and rnd - last < self.cfg.cooldown_rounds:
            return []
        self._last_fired[name] = rnd
        return [Alert(detector=name, severity=severity or self.severity,
                      round=rnd, sim_time=float(rec.get("time", 0.0)),
                      message=message, evidence=evidence)]


class AccuracyTrendDetector(Detector):
    """Plateau / divergence: least-informative failure mode first — the
    run that looks alive but stopped learning.  The eval metric is
    EMA-smoothed, then the slope over a full window of smoothed values is
    thresholded: ~0 => ``plateau`` (warn), clearly negative =>
    ``divergence`` (error)."""

    name = "plateau"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._ema: Optional[float] = None
        self._win: deque = deque(maxlen=cfg.acc_window)
        self._seen = 0

    def observe(self, rec, snap, busy):
        acc = rec.get("acc")
        if acc is None:
            return []
        b = self.cfg.acc_ema_beta
        self._ema = (float(acc) if self._ema is None
                     else b * self._ema + (1 - b) * float(acc))
        self._win.append(self._ema)
        self._seen += 1
        if (self._seen <= self.cfg.warmup_rounds
                or len(self._win) < self.cfg.acc_window):
            return []
        slope = (self._win[-1] - self._win[0]) / (len(self._win) - 1)
        if slope <= -self.cfg.diverge_slope:
            return self._fire(
                rec, f"eval metric diverging: EMA slope {slope:+.4f}/round "
                     f"over the last {len(self._win)} rounds",
                name="divergence", severity="error",
                slope=round(slope, 6), ema=round(self._ema, 6),
                window=len(self._win))
        if abs(slope) <= self.cfg.plateau_slope:
            return self._fire(
                rec, f"eval metric plateaued: EMA slope {slope:+.5f}/round "
                     f"over the last {len(self._win)} rounds",
                slope=round(slope, 6), ema=round(self._ema, 6),
                window=len(self._win))
        return []


class StalenessBlowupDetector(Detector):
    """Round ``staleness_max`` against the running quantile of its own
    history (the ``agg.staleness`` stream): a blowup means the buffer is
    aggregating ancient updates — exactly what SEAFL's Eq. (4)/(8)
    weighting and sync-wait exist to prevent."""

    name = "staleness_blowup"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._hist: deque = deque(maxlen=64)

    def observe(self, rec, snap, busy):
        cur = rec.get("staleness_max")
        if cur is None:
            return []
        cur = float(cur)
        out: List[Alert] = []
        if len(self._hist) >= self.cfg.staleness_min_history:
            q = _quantile(sorted(self._hist), self.cfg.staleness_quantile)
            thresh = max(self.cfg.staleness_floor,
                         self.cfg.staleness_factor * max(q, 1.0))
            if cur > thresh:
                out = self._fire(
                    rec, f"staleness blowup: round max {cur:.0f} vs "
                         f"running q{int(self.cfg.staleness_quantile * 100)}"
                         f" {q:.1f}",
                    staleness_max=cur, running_quantile=round(q, 3),
                    threshold=round(thresh, 3))
        self._hist.append(cur)
        return out


class StragglerDominanceDetector(Detector):
    """One client owning the fleet's sim-clock: per-client cumulative
    ``train``+``upload`` span seconds (from the telemetry sim tracks) vs
    the fleet median.  A dominant straggler both holds an outsized
    multiple of the median *and* an outright share of all busy time —
    the second condition keeps a merely-slow client in a busy fleet from
    firing (concurrency bounds any one client's share while the rest
    keep cycling)."""

    name = "straggler_dominance"

    def observe(self, rec, snap, busy):
        if int(rec.get("round", 0)) <= self.cfg.warmup_rounds:
            return []
        per_client = {
            track: spans.get("train", 0.0) + spans.get("upload", 0.0)
            for track, spans in busy.items() if track.startswith("client")
        }
        per_client = {k: v for k, v in per_client.items() if v > 0}
        if len(per_client) < self.cfg.straggler_min_clients:
            return []
        total = sum(per_client.values())
        top_track, top = max(per_client.items(), key=lambda kv: kv[1])
        med = _median(list(per_client.values()))
        share = top / total if total > 0 else 0.0
        if (top > self.cfg.straggler_factor * max(med, 1e-9)
                and share >= self.cfg.straggler_share):
            return self._fire(
                rec, f"straggler dominance: {top_track} holds "
                     f"{share:.0%} of fleet train+upload sim time "
                     f"({top:.1f}s vs median {med:.1f}s)",
                client=top_track, busy_s=round(top, 3),
                median_s=round(med, 3), share=round(share, 4),
                clients=len(per_client))
        return []


class BufferStarvationDetector(Detector):
    """Inter-aggregation sim-time gap vs its own running median: the
    buffer starves when deliveries stop arriving (crashed fleet, dead
    links, sync-wait deadlocking on stragglers) and rounds stretch."""

    name = "buffer_starvation"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._prev_t: Optional[float] = None
        self._gaps: deque = deque(maxlen=64)

    def observe(self, rec, snap, busy):
        t = float(rec.get("time", 0.0))
        out: List[Alert] = []
        if self._prev_t is not None:
            gap = t - self._prev_t
            if len(self._gaps) >= self.cfg.starve_min_history:
                med = _median(list(self._gaps))
                if (gap > self.cfg.starve_factor * max(med, 1e-9)
                        and gap > self.cfg.starve_min_gap_s):
                    out = self._fire(
                        rec, f"buffer starvation: {gap:.1f}s since the "
                             f"last aggregation vs median gap {med:.1f}s",
                        gap_s=round(gap, 3), median_gap_s=round(med, 3))
            self._gaps.append(gap)
        self._prev_t = t
        return out


class SpillPressureDetector(Detector):
    """Sync-wait spill pressure: ``buffer.spill_grow`` counting up in
    nearly every recent round means aggregation is persistently held by
    the staleness limit while uploads keep landing — the (K, P) buffer
    doubles past K and HBM climbs with it."""

    name = "spill_pressure"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._last = 0.0
        self._grew: deque = deque(maxlen=cfg.spill_window)

    def observe(self, rec, snap, busy):
        cum = _counter_sum(snap, "buffer.spill_grow")
        self._grew.append(1 if cum > self._last else 0)
        self._last = cum
        if (len(self._grew) == self.cfg.spill_window
                and sum(self._grew) >= self.cfg.spill_rounds):
            return self._fire(
                rec, f"sync-wait spill pressure: buffer spilled in "
                     f"{sum(self._grew)} of the last {len(self._grew)} "
                     f"rounds ({int(cum)} grows total)",
                spill_grows_total=int(cum),
                recent_spill_rounds=int(sum(self._grew)),
                window=len(self._grew))
        return []


class BandSaturationDetector(Detector):
    """Drift-band saturation: the adaptive rate policy exists to *move*
    between bands; every observation landing in one band means the edges
    are mis-tuned for this workload and the policy has degenerated to a
    static ratio (at band-choice bookkeeping cost)."""

    name = "band_saturation"

    def observe(self, rec, snap, busy):
        bands = {k: v for k, v in snap.get("counters", {}).items()
                 if k.startswith("policy.band[")}
        total = sum(bands.values())
        if len(bands) == 0 or total < self.cfg.band_window:
            return []
        top_key, top = max(bands.items(), key=lambda kv: kv[1])
        frac = top / total
        if frac >= self.cfg.band_frac:
            return self._fire(
                rec, f"drift-band saturation: {frac:.0%} of {int(total)} "
                     f"policy decisions landed in {top_key}",
                band=top_key, fraction=round(frac, 4),
                observations=int(total))
        return []


class ByteBudgetDetector(Detector):
    """Cumulative up+down wire bytes vs a hard budget.  Fires once
    (error): past the budget every further round is over budget too, and
    the SLO gate is the actionable response."""

    name = "byte_budget"
    severity = "error"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._done = False

    def observe(self, rec, snap, busy):
        budget = self.cfg.byte_budget
        if budget is None or self._done:
            return []
        total = int(rec.get("bytes", 0)) + int(rec.get("bytes_down", 0))
        if total > budget:
            self._done = True
            return self._fire(
                rec, f"byte budget overrun: {total} wire bytes (up+down) "
                     f"> budget {budget}",
                total_bytes=total, budget_bytes=int(budget))
        return []


class CohortFragmentationDetector(Detector):
    """Cohort fragmentation: with ``cohorts='on'`` the whole point is
    cohorts << clients; a sustained cohorts ~ tracked-clients ratio means
    every client sits in its own cohort (version/band churn) and the
    shared-residual state collapsed back to per-client cost — the
    ``mem_*`` watchdog fields make the regression visible per round."""

    name = "cohort_fragmentation"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._streak = 0

    def observe(self, rec, snap, busy):
        cohorts = rec.get("cohorts")
        members = rec.get("mem_tracking_entries")
        if members in (None, 0):
            g = snap.get("gauges", {})
            members = g.get("cohort.members")
        if cohorts is None or not members:
            self._streak = 0
            return []
        frac = float(cohorts) / float(members)
        if (members >= self.cfg.frag_min_clients
                and frac >= self.cfg.frag_frac):
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.cfg.frag_consecutive:
            return self._fire(
                rec, f"cohort fragmentation: {int(cohorts)} cohorts over "
                     f"{int(members)} tracked clients for "
                     f"{self._streak} straight rounds",
                cohorts=int(cohorts), tracked_clients=int(members),
                fraction=round(frac, 4), streak=int(self._streak))
        return []


class ResyncStormDetector(Detector):
    """Resync storm: personalized fold-in re-encodes (multicast EF
    escape hatch) plus cohort mismatch resyncs firing every round mean
    the shared-encode economics have inverted — the server is paying
    per-client encodes *and* cache bookkeeping."""

    name = "resync_storm"

    def __init__(self, cfg: MonitorConfig):
        super().__init__(cfg)
        self._last = 0.0
        self._deltas: deque = deque(maxlen=cfg.resync_window)

    def observe(self, rec, snap, busy):
        cum = _counter_sum(snap, "dispatch.resync", "cohort.mismatch_resync")
        self._deltas.append(max(0.0, cum - self._last))
        self._last = cum
        if len(self._deltas) < self.cfg.resync_window:
            return []
        rate = sum(self._deltas) / len(self._deltas)
        # a storm means resyncs land *every* round of the window; a single
        # burst round (a staleness sync-wait releasing a backlog of buffered
        # deliveries at once) can carry the same mean without the economics
        # having inverted
        if rate >= self.cfg.resync_per_round and min(self._deltas) > 0:
            return self._fire(
                rec, f"resync storm: {rate:.1f} resyncs/round over the "
                     f"last {len(self._deltas)} rounds "
                     f"({int(cum)} cumulative)",
                resyncs_per_round=round(rate, 3), cumulative=int(cum),
                window=len(self._deltas))
        return []


class ScheduleSkewDetector(Detector):
    """Schedule skew: a ranked scheduler (stragglers_last/rate_staleness)
    is meant to *delay* slow clients, never to starve them — the
    schedulers carry a fairness-aging floor precisely so every eligible
    client keeps participating.  Fires when the simulator's
    ``sched_max_wait`` column (longest any eligible idle client has gone
    unselected; offline time excluded, churn is not skew) exceeds the
    participation floor.  Silent when the column is absent (scheduler
    layer off)."""

    name = "schedule_skew"

    def observe(self, rec, snap, busy):
        wait = rec.get("sched_max_wait")
        if wait is None or int(rec.get("round", 0)) <= self.cfg.warmup_rounds:
            return []
        if float(wait) > self.cfg.skew_max_wait:
            return self._fire(
                rec, f"schedule skew: an eligible client has waited "
                     f"{float(wait):.0f}s unselected under "
                     f"'{rec.get('sched_policy', '?')}' "
                     f"(floor {self.cfg.skew_max_wait:.0f}s)",
                max_wait=float(wait),
                policy=rec.get("sched_policy"),
                floor=self.cfg.skew_max_wait)
        return []


DETECTOR_CLASSES = (
    AccuracyTrendDetector, StalenessBlowupDetector,
    StragglerDominanceDetector, BufferStarvationDetector,
    SpillPressureDetector, BandSaturationDetector, ByteBudgetDetector,
    CohortFragmentationDetector, ResyncStormDetector, ScheduleSkewDetector,
)


# ------------------------------------------------------------------- SLO
@dataclass(frozen=True)
class SloPolicy:
    """Which alerts fail the run: a minimum severity (every alert at or
    above it violates) and/or an explicit set of detector names (those
    violate at any severity)."""
    min_severity: Optional[str] = None
    detectors: frozenset = frozenset()

    def violates(self, alert: Alert) -> bool:
        if alert.detector in self.detectors:
            return True
        if self.min_severity is not None:
            return (SEVERITIES.index(alert.severity)
                    >= SEVERITIES.index(self.min_severity))
        return False


def parse_slo(spec: Optional[str]) -> Optional[SloPolicy]:
    """Parse ``FLConfig.slo``: a comma-separated list where each token is
    either a severity (``warn``/``error`` — fail on any alert at or above
    it) or a detector name (fail whenever that detector fires).  None or
    empty disables the gate.  Unknown tokens raise at construction, not
    mid-run."""
    if spec is None or not str(spec).strip():
        return None
    min_sev: Optional[str] = None
    detectors = set()
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok in ("warn", "error"):
            if min_sev is None or (SEVERITIES.index(tok)
                                   < SEVERITIES.index(min_sev)):
                min_sev = tok
        elif tok in DETECTOR_NAMES:
            detectors.add(tok)
        else:
            raise ValueError(
                f"unknown SLO token {tok!r}: expected a severity "
                f"('warn'|'error') or a detector name from "
                f"{DETECTOR_NAMES}")
    return SloPolicy(min_severity=min_sev, detectors=frozenset(detectors))


# ----------------------------------------------------------------- monitor
class RunMonitor:
    """Online run-health monitor: one :meth:`on_round` call per history
    record runs every detector and collects typed alerts; the optional
    SLO policy turns selected alerts into a fail-fast stop."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 config: Optional[MonitorConfig] = None,
                 slo: Optional[str] = None):
        self.tel = of(telemetry)
        self.cfg = config if config is not None else MonitorConfig()
        self.slo = parse_slo(slo)
        self.detectors = [cls(self.cfg) for cls in DETECTOR_CLASSES]
        self.alerts: List[Alert] = []
        self.slo_violations: List[Alert] = []

    @classmethod
    def from_config(cls, flcfg, telemetry: Optional[Telemetry] = None
                    ) -> "RunMonitor":
        """Build from an ``FLConfig``: the only per-run knobs surfaced
        there are the byte budget and the SLO spec; detector thresholds
        keep their tuned defaults."""
        return cls(telemetry,
                   MonitorConfig(byte_budget=flcfg.monitor_byte_budget),
                   slo=flcfg.slo)

    def on_round(self, rec: dict) -> List[Alert]:
        """Run every detector against one round's history record.  The
        compact telemetry snapshot is taken from ``rec['telemetry']`` when
        the record carries one (the simulator's layout) and pulled from
        the live registry otherwise; per-client busy time always comes
        from the registry's sim tracks."""
        snap = rec.get("telemetry")
        if snap is None:
            snap = (self.tel.snapshot(compact=True)
                    if self.tel.enabled else {})
        busy = self.tel.sim_track_busy()
        fired: List[Alert] = []
        for det in self.detectors:
            fired.extend(det.observe(rec, snap, busy))
        self.alerts.extend(fired)
        if self.slo is not None:
            self.slo_violations.extend(a for a in fired
                                       if self.slo.violates(a))
        return fired

    @property
    def slo_breached(self) -> bool:
        return bool(self.slo_violations)

    def alert_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for a in self.alerts:
            counts[a.detector] = counts.get(a.detector, 0) + 1
        return counts

    def summary(self) -> Dict[str, Any]:
        """JSON-able run-health summary (rides the train CLI's final
        summary record)."""
        return {
            "alerts_total": len(self.alerts),
            "alerts_by_detector": self.alert_counts(),
            "slo_breached": self.slo_breached,
            "slo_violations": [a.to_dict() for a in self.slo_violations],
        }
