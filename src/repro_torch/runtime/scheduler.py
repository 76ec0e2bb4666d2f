"""Pluggable client-selection scheduling policies.

The server decides *whom* to dispatch; this module is where that decision
lives.  ``SeaflServer._sample_idle`` delegates every idle-pool draw — the
``start()`` warm-up wave, crash replacements in ``mark_failed``, and the
post-aggregation top-up — to one :class:`Scheduler` object, so a policy
change never touches the protocol state machine.

Eligibility state machine (one client, as the simulator drives it)::

      available ──select──> dispatched ──deliver──> available
          │                     │
          │ (renewal: offline)  │ (renewal: offline mid-round)
          v                     v
      ineligible            killed in flight: transfer/training dies via
      (deferred from        the crash machinery, version tracking dropped
       every pool)              │
          │                     v
          │ (renewal: online)  deferred  ──(renewal: online)──> dispatched
          v                              (full-snapshot re-request: the
      available                           drop voided delta tracking)

    * *available -> dispatched*: the scheduler picked the client from the
      eligible slice of the idle pool (``select``).
    * *offline mid-round*: the availability model (runtime/simulator.py)
      kills the in-flight dispatch/training/upload exactly like a crash —
      ``mark_failed`` aborts any mid-stream ingest and ``dispatch.drop``
      voids version tracking, so the re-request on return ships a full
      snapshot.
    * *deferred*: a dispatch addressed to an offline client is parked, not
      sent; it goes out when the renewal process brings the client back,
      re-marked against the then-current global so version tracking stays
      honest about what the payload targets.

    Deferral and cohort membership: a deferred client holds no dispatch
    state (its tracking was dropped at the offline kill), so under
    ``cohorts='on'`` it simply leaves its (held version, drift band)
    cohort and re-enters one on its next delivered dispatch — no cohort
    ever holds a phantom member.

Policies:

``random``
    The legacy uniform draw over the (eligible) idle pool.  With
    availability off this consumes the server RNG stream **identically**
    to the pre-scheduler code — the default-config bit-identity pin
    depends on it.

``stragglers_last``
    Ranks eligible clients by predicted round time (an EMA over observed
    dispatch->deliver seconds per client) and picks the fastest first, so
    stragglers only train when nothing faster is idle.  Never-observed
    clients score 0 — optimism doubles as exploration.

``rate_staleness``
    CSMAAFL-style rate- and staleness-aware selection: the same predicted
    round time, additionally penalized by the staleness that update is
    *predicted* to arrive with (predicted round seconds over the EMA
    aggregation cadence) — and clients whose predicted arrival staleness
    exceeds a cutoff are vetoed outright (the slot stays empty) rather
    than merely ranked last.  Slow clients are doubly discounted — they
    hold a concurrency slot longer *and* their eventual update decays
    under Eq. (8) staleness weighting (or worse, trips the sync-wait).

Both ranked policies carry a fairness floor: the eligible client that has
waited longest jumps the queue once its wait exceeds ``fairness_seconds``
(one jump per selection, so a synchronized wave of waiters drains without
flooding every concurrency slot with stragglers).  Waits are measured in
sim seconds of *eligible* time — offline stretches reset the clock — and
the ``ScheduleSkewDetector`` in runtime/monitor.py alerts if a policy
ever defeats this floor.

The prediction features are exactly the telemetry layer's busy-share
evidence — per-client cumulative dispatch->deliver sim seconds — fed to
the scheduler by the simulator at each delivery (``observe_round``) and
each aggregation (``observe_aggregation``), so the scheduler works even
when the full telemetry registry is disabled.  Scheduler state is never
checkpointed: like the run monitor, a restored run re-warms its EMAs
within a few rounds.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.runtime.telemetry import Telemetry, of

#: every policy name ``FLConfig.scheduler`` accepts
SCHEDULERS = ("random", "stragglers_last", "rate_staleness")


class Scheduler:
    """Base class: eligibility filtering + selection bookkeeping.

    Subclasses implement ``_rank(eligible, k, rng, round_)`` returning the
    ``k`` clients to dispatch.  ``select`` wraps it with availability
    filtering, the ``sched.rank_ms`` telemetry counter, and per-client
    last-selected tracking (the fairness floor's and skew detector's
    evidence).
    """

    policy = "?"
    #: an eligible idle client that has waited this many *sim seconds*
    #: since its last selection jumps the ranked queue (starvation floor).
    #: Seconds, not rounds: ranked policies drive the aggregation cadence
    #: itself, so a round-denominated floor would tighten exactly when the
    #: scheduler succeeds.  One starved client jumps per selection, so a
    #: synchronized cohort of waiters drains smoothly instead of flooding
    #: every concurrency slot at once.
    fairness_seconds = 60.0
    #: True: the server re-selects the whole post-aggregation fan-out from
    #: the idle pool (contributors included — they went idle at ingest)
    #: instead of unconditionally re-dispatching contributors; gives a
    #: ranked policy control every round, not just on rare top-ups.
    #: False for the random policy: the legacy re-dispatch, bit-identical.
    reselect_contributors = False

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.tel = of(telemetry)
        # availability oracle, bound by the simulator when an availability
        # model is active; None = every client always eligible (legacy)
        self.availability_fn: Optional[Callable[[int], bool]] = None
        self._now = 0.0                          # sim clock (observe_*)
        self._last_sel: Dict[int, float] = {}    # cid -> time last selected
        self._elig_since: Dict[int, float] = {}  # cid -> time turned eligible
        self._was_offline: set = set()

    # ------------------------------------------------------------ wiring
    def bind_availability(self, fn: Callable[[int], bool]) -> None:
        self.availability_fn = fn

    def eligible(self, pool: List[int]) -> Tuple[List[int], List[int]]:
        """Split a candidate pool into (eligible, deferred-by-availability).

        Also maintains each client's eligible-since clock: an offline
        stretch resets it, so ``wait_of`` measures time spent *eligible*
        but unselected — not time spent offline.
        """
        if self.availability_fn is None:
            for c in pool:
                self._elig_since.setdefault(c, self._now)
            return list(pool), []
        elig, deferred = [], []
        for c in pool:
            (elig if self.availability_fn(c) else deferred).append(c)
        for c in deferred:
            self._was_offline.add(c)
        for c in elig:
            if c in self._was_offline:
                self._was_offline.discard(c)
                self._elig_since[c] = self._now
            else:
                self._elig_since.setdefault(c, self._now)
        return elig, deferred

    # --------------------------------------------------------- selection
    def select(self, pool: List[int], k: int, rng,
               round_: int = 0) -> List[int]:
        """Pick up to ``k`` clients from the eligible slice of ``pool``.

        ``pool`` must be sorted (the server passes ``sorted(idle)``) so
        ranking ties and RNG draws are deterministic.  Returns [] without
        touching ``rng`` when nothing is eligible — with availability off
        the eligible slice *is* the pool and the RNG stream is identical
        to the legacy ``_sample_idle``.
        """
        elig, _ = self.eligible(pool)
        if not elig or k <= 0:
            return []
        if self.tel.enabled:
            t0 = time.perf_counter()
            picked = self._rank(elig, min(k, len(elig)), rng, round_)
            self.tel.counter("sched.rank_ms",
                             (time.perf_counter() - t0) * 1e3)
        else:
            picked = self._rank(elig, min(k, len(elig)), rng, round_)
        for c in picked:
            self._last_sel[c] = self._now
        return picked

    def _rank(self, elig: List[int], k: int, rng, round_: int) -> List[int]:
        raise NotImplementedError

    def note_dispatched(self, cid: int) -> None:
        """A dispatch bypassed ``select`` (a parked deferred client going
        out on return) — refresh its wait clock so it isn't double-served."""
        self._last_sel[cid] = self._now

    # ------------------------------------------------- observation feeds
    def observe_round(self, cid: int, round_seconds: float) -> None:
        """One client finished a full dispatch->deliver round."""

    def observe_aggregation(self, round_: int, sim_time: float) -> None:
        """The server aggregated — advances the scheduler's sim clock
        (subclasses also read it as cadence evidence)."""
        self._now = max(self._now, float(sim_time))

    # ------------------------------------------------------ skew evidence
    def wait_of(self, cid: int) -> float:
        """Sim seconds ``cid`` has been eligible since its last selection
        (0 if never yet seen eligible)."""
        base = max(self._last_sel.get(cid, float("-inf")),
                   self._elig_since.get(cid, self._now))
        return max(0.0, self._now - base)

    def max_wait(self, pool: List[int]) -> Tuple[float, Optional[int]]:
        """(longest wait among ``pool``, that client) — the simulator feeds
        this over the *eligible* idle pool so the ScheduleSkewDetector
        measures scheduler-induced starvation, not offline time."""
        best_w, best_c = 0.0, None
        for c in pool:
            w = self.wait_of(c)
            if w > best_w:
                best_w, best_c = w, c
        return best_w, best_c


class RandomScheduler(Scheduler):
    """Uniform draw over the eligible pool — the legacy ``_sample_idle``
    behaviour, RNG-call-for-RNG-call (pinned by test)."""

    policy = "random"

    def _rank(self, elig, k, rng, round_):
        pick = rng.choice(len(elig), size=k, replace=False)
        return [elig[i] for i in pick]


class _RankedScheduler(Scheduler):
    """Shared prediction state for the ranked policies: per-client EMA of
    observed round seconds plus an EMA of the aggregation cadence."""

    ema_beta = 0.5          # weight on the previous EMA value
    reselect_contributors = True

    def __init__(self, telemetry: Optional[Telemetry] = None):
        super().__init__(telemetry)
        self._rate: Dict[int, float] = {}       # cid -> EMA round seconds
        self._agg_gap: Optional[float] = None   # EMA inter-aggregation gap
        self._last_agg_t: Optional[float] = None

    def observe_round(self, cid, round_seconds):
        prev = self._rate.get(cid)
        b = self.ema_beta
        self._rate[cid] = (float(round_seconds) if prev is None
                           else b * prev + (1 - b) * float(round_seconds))

    def observe_aggregation(self, round_, sim_time):
        super().observe_aggregation(round_, sim_time)
        if self._last_agg_t is not None:
            gap = max(float(sim_time) - self._last_agg_t, 1e-9)
            self._agg_gap = (gap if self._agg_gap is None
                             else 0.5 * self._agg_gap + 0.5 * gap)
        self._last_agg_t = float(sim_time)

    def predicted_round_s(self, cid: int) -> float:
        return self._rate.get(cid, 0.0)

    def _score(self, cid: int) -> float:
        raise NotImplementedError

    def _skip(self, cid: int) -> bool:
        """Policy veto: refuse this client even if slots remain — the slot
        stays empty until someone better frees up.  The fairness jump
        bypasses the veto, so starvation stays bounded."""
        return False

    def _rank(self, elig, k, rng, round_):
        # fairness floor: the single longest-waiting starved client (if
        # any) jumps the queue; one per selection so a synchronized wave
        # of waiters drains without flooding every slot with stragglers
        jump = None
        wait, cand = self.max_wait(elig)
        if wait >= self.fairness_seconds:
            jump = cand
        ranked = sorted(elig, key=lambda c: (self._score(c), c))
        picked = [] if jump is None else [jump]
        for c in ranked:
            if len(picked) >= k:
                break
            if c == jump or self._skip(c):
                continue
            picked.append(c)
        if not picked:
            # liveness: a policy may under-fill, never refuse everyone
            picked = ranked[:k]
        return picked


class StragglersLastScheduler(_RankedScheduler):
    """Fastest-predicted-first: stragglers are dispatched only when no
    faster client is idle (the fairness floor still rotates them in)."""

    policy = "stragglers_last"

    def _score(self, cid):
        return self.predicted_round_s(cid)


class RateStalenessScheduler(_RankedScheduler):
    """Rate- and predicted-staleness-aware selection (CSMAAFL-style).

    Ranks by score = T_hat * (1 + w * s_hat), with s_hat = T_hat /
    EMA(agg gap): the staleness (in rounds) an update dispatched *now* is
    predicted to arrive with.  On top of the ranking it vetoes any client
    with s_hat > ``staleness_cut``: such an update would arrive so stale
    it decays to nothing under Eq. (8) weighting (or trips the
    sync-wait), so the slot is better left empty for a faster client
    about to free up.  The fairness jump bypasses the veto, bounding
    starvation.
    """

    policy = "rate_staleness"
    staleness_weight = 1.0
    #: veto clients predicted to arrive more than this many rounds stale
    staleness_cut = 16.0

    def _s_hat(self, cid: int) -> float:
        gap = self._agg_gap or 0.0
        return self.predicted_round_s(cid) / gap if gap > 0 else 0.0

    def _score(self, cid):
        t_hat = self.predicted_round_s(cid)
        return t_hat * (1.0 + self.staleness_weight * self._s_hat(cid))

    def _skip(self, cid):
        return self._s_hat(cid) > self.staleness_cut


_POLICIES = {cls.policy: cls for cls in
             (RandomScheduler, StragglersLastScheduler,
              RateStalenessScheduler)}


def make_scheduler(policy: str,
                   telemetry: Optional[Telemetry] = None) -> Scheduler:
    """Build a scheduler by ``FLConfig.scheduler`` name; raises at
    construction on unknown policies (the FLConfig validation pattern)."""
    if policy not in _POLICIES:
        raise ValueError(f"scheduler must be one of {SCHEDULERS}, "
                         f"got {policy!r}")
    return _POLICIES[policy](telemetry)
