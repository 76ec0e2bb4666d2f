"""Deterministic event-driven FL cluster simulator.

Reproduces the paper's two heterogeneity testbeds:
  * §III preliminary study — per-epoch idle gaps ~ Zipf(s=1.7, max 60 s)
  * §VI evaluation        — per-client speed multipliers ~ Pareto (heavy tail)

plus link latencies, an optional per-client *bandwidth* model, and fault
injection (client crash/recovery).  Simulated seconds are the wall-clock
metric of every paper-figure benchmark; learning itself is real (lazy local
SGD at upload time), so time-to-accuracy curves are true learning curves
under simulated cluster timing.

Link timing is wire-accurate in *both* directions: when the bandwidth model
is enabled, an upload takes ``up_latency + wire_bytes / up_bandwidth`` where
``wire_bytes`` is the *actual* size of the chunked transport payload the
server will ingest (runtime/transport.py), and a dispatch takes
``down_latency + dispatch_wire_bytes / down_bandwidth`` where the dispatch
payload is the version-tracked, possibly delta-coded downlink transfer
(runtime/dispatch.py; legacy ``dispatch_compression=None`` charges the raw
f32 model size, the pre-dispatch behaviour, bit-for-bit).  So compression
ratio, bf16 wire format, SEAFL² partial uploads, and delta-coded dispatch
all move the time-to-accuracy curves, which is the paper's headline metric.
Per-client bandwidths are heavy-tailed (Pareto), like the compute speeds:
the slow-link tail is exactly the straggler population SEAFL's semi-async
buffer exists for.

Event flow per client: dispatch -> (down link) -> E epoch ends ->
"upload" (training materialises, payload encoded, uplink time computed) ->
"deliver" (server ingests the payload chunk-by-chunk into its (K, P) buffer
slot; maybe aggregates).  With ``bandwidth_model='none'`` the deliver lands
exactly ``up_latency`` after training ends — byte-count-independent, the
pre-transport behaviour.

Client *availability* is a third heterogeneity axis
(``SimConfig.availability``): per-client available/unavailable renewal
processes (:class:`AvailabilityModel` — ``diurnal`` timezone waves or
``longtail`` heavy-tailed churn) gate which clients the server's
scheduler (runtime/scheduler.py) may select, defer dispatches addressed
to offline clients, and kill in-flight work when a client drops
mid-round — through the same crash-event machinery as fault injection,
so version tracking and mid-stream ingest aborts behave identically.
``availability='always'`` (default) draws no RNG and pushes no events:
bit-identical to the availability-free simulator, pinned by test.

Under ``FLConfig.resync_batching`` one aggregation's dispatch fan-out is
encoded in one pass (``SeaflServer.encode_dispatch_round``): the resync
fold-ins coalesce into one batched encode whose source cost is priced once
and shared by the resynced clients.

With ``FLConfig.monitor='on'`` every round record carries the server's
resident-state breakdown as ``mem_*`` fields and, when a detector fires,
its ``alerts``; an SLO breach stops ``run`` with the next event still
queued.  Off, none of it runs and the records keep their keys.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.client import Client
from repro_torch.core.server import SeaflServer

PyTree = Any


@dataclass(frozen=True)
class SimConfig:
    speed_model: str = "pareto"        # pareto | zipf
    base_epoch_time: float = 1.0       # seconds per epoch on the fastest device
    pareto_shape: float = 1.5
    zipf_s: float = 1.7
    zipf_max: float = 60.0             # paper §III: idle capped at 60 s
    down_latency: float = 0.1
    up_latency: float = 0.1
    # --- bandwidth model: 'none' keeps fixed-latency links (legacy);
    # 'pareto' draws per-client up/down rates with a heavy slow tail, and
    # link time = latency + wire_bytes / rate.
    bandwidth_model: str = "none"      # none | pareto
    up_mbps: float = 20.0              # fastest-client uplink, megabits/s
    down_mbps: float = 100.0           # fastest-client downlink, megabits/s
    bandwidth_pareto_shape: float = 1.5
    # --- server-side dispatch *encode* throughput, megabits/s of f32
    # source processed (0 = free, the legacy timing).  Charged per dispatch
    # from the payload's actual encode work: a fresh encode (full snapshot,
    # personalized resync, or multicast cache miss) processes 4*P source
    # bytes; a multicast cache hit costs nothing — so the encode cache
    # changes server encode *time* accounting, never wire bytes.
    encode_mbps: float = 0.0
    fail_prob: float = 0.0             # per-dispatch crash probability
    recover_after: float = 30.0
    # --- client availability (churn): 'always' keeps every client willing
    # (legacy, bit-identical); 'diurnal' and 'longtail' run per-client
    # available/unavailable renewal processes (AvailabilityModel below).
    # An offline client is ineligible for selection, a dispatch addressed
    # to it is deferred until it returns, and going offline mid-round
    # kills the in-flight transfer/training via the crash machinery.
    availability: str = "always"       # always | diurnal | longtail
    avail_period: float = 200.0        # diurnal: day length, sim seconds
    avail_duty: float = 0.5            # diurnal: mean fraction of day online
    avail_mean_on: float = 120.0       # longtail: mean online stretch
    avail_mean_off: float = 40.0       # longtail: mean offline stretch
    seed: int = 0


AVAILABILITY_MODES = ("always", "diurnal", "longtail")


class AvailabilityModel:
    """Per-client available/unavailable renewal processes (FLGo-style).

    Eligibility state machine as the simulator drives it (the scheduler
    module documents the same machine from the selection side)::

        available --select--> dispatched --deliver--> available
        available --toggle--> offline    --toggle--> available
        dispatched --toggle--> offline-mid-round (in-flight killed via the
            crash machinery; version tracking dropped) --toggle-->
            available --select--> full-snapshot re-request
        dispatch addressed while offline --> deferred --toggle--> dispatched

    Modes:

    ``diurnal``
        Each client lives on a day of ``avail_period`` sim seconds split
        into one online window (``avail_duty`` of the day, per-cycle
        jitter) and one offline window, at a per-client random phase — so
        the fleet's online population swells and shrinks like a timezone
        wave instead of toggling in lockstep.

    ``longtail``
        Online stretches are exponential around ``avail_mean_on``;
        offline stretches are Pareto-tailed around ``avail_mean_off`` —
        most disconnections are brief, a heavy tail of devices vanish for
        many multiples of the mean (the churn analogue of the Pareto
        speed/bandwidth tails).

    Determinism and restore: every draw comes from a dedicated per-client
    RNG seeded as ``(sim seed, salt, cid)`` — never the simulator's main
    stream, so availability changes zero draws in the speed/crash/link
    streams, and a checkpoint-restored process (whose sim clock restarts
    at 0, per the existing run() semantics) re-derives the identical
    toggle schedule from the config alone.  Nothing here is checkpointed.
    """

    #: seed salt so availability streams never collide with speed/link draws
    SALT = 0x5EAF1

    def __init__(self, cfg: SimConfig, client_ids):
        if cfg.availability not in ("diurnal", "longtail"):
            raise ValueError(
                f"availability must be one of {AVAILABILITY_MODES}, "
                f"got {cfg.availability!r}")
        self.cfg = cfg
        self.mode = cfg.availability
        self._rng = {cid: np.random.default_rng((cfg.seed, self.SALT, cid))
                     for cid in client_ids}

    def _window(self, cid: int, online: bool) -> float:
        """Length of the next online/offline stretch for ``cid``."""
        rng, cfg = self._rng[cid], self.cfg
        if self.mode == "diurnal":
            base = cfg.avail_period * (cfg.avail_duty if online
                                       else 1.0 - cfg.avail_duty)
            return max(1e-3, base * (0.8 + 0.4 * rng.random()))
        if online:
            return max(1e-3, rng.exponential(cfg.avail_mean_on))
        # Pareto(a)+1 has mean a/(a-1); rescale so the stretch averages
        # avail_mean_off with a heavy right tail
        a = 1.5
        return max(1e-3, cfg.avail_mean_off * (a - 1) / a
                   * (rng.pareto(a) + 1.0))

    def bootstrap(self, cid: int) -> tuple[bool, float]:
        """Initial (online?, seconds until the first toggle).  The process
        starts mid-window: online with the mode's stationary probability,
        a uniform fraction of the way through the current stretch."""
        rng, cfg = self._rng[cid], self.cfg
        if self.mode == "diurnal":
            p_on = cfg.avail_duty
        else:
            p_on = cfg.avail_mean_on / (cfg.avail_mean_on
                                        + cfg.avail_mean_off)
        online = bool(rng.random() < p_on)
        remaining = self._window(cid, online) * rng.random()
        return online, max(1e-3, remaining)

    def next_delay(self, cid: int, online: bool) -> float:
        """Seconds until the next toggle, given the state just entered."""
        return self._window(cid, online)


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    data: dict = field(compare=False, default_factory=dict)
    valid: bool = field(compare=False, default=True)


@dataclass
class InFlight:
    cid: int
    version: int
    epoch_ends: list[float]
    upload_event: _Event
    n_epochs_at_upload: int
    t0: float = 0.0               # training start (after the down link)
    notified: bool = False
    payload: Any = None           # DispatchPayload on the downlink wire
    arrive_event: Optional[_Event] = None   # payload delivery at t0
    sched: float = 0.0            # dispatch scheduled (encode + wire start)
    # pending crash draw for this dispatch (training- or download-window),
    # so an availability kill can void it — else the stale fail event
    # would spuriously kill the client's *next* dispatch
    fail_event: Optional[_Event] = None


class FLSimulation:
    def __init__(self, server: SeaflServer, clients: dict[int, Client],
                 sim_cfg: SimConfig,
                 eval_fn: Optional[Callable[[PyTree], float]] = None,
                 eval_every: int = 1):
        self.server = server
        self.clients = clients
        self.cfg = sim_cfg
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        # the server's registry is the simulation's and its clients' too:
        # client lifecycle events become spans on the *simulated* clock
        # (one track per client), next to the host's wall-clock spans
        self.tel = server.tel
        for client in clients.values():
            client.tel = server.tel
        self._rng = np.random.default_rng(sim_cfg.seed)
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self._inflight: dict[int, InFlight] = {}
        self._delivering: dict[int, _Event] = {}   # cid -> pending deliver
        self.now = 0.0
        self.encode_seconds = 0.0      # cumulative server encode time spent
        self.history: list[dict] = []
        # one record per topk dispatch actually encoded: the ratio it
        # shipped at (the drift band's choice under the adaptive policy,
        # the static configured ratio otherwise)
        self.ratio_log: list[dict] = []
        # per-client static speed multiplier (Pareto heavy tail, paper §VI)
        self._speed = {
            cid: float(self._rng.pareto(sim_cfg.pareto_shape) + 1.0)
            for cid in clients
        }
        # per-client link rates in bytes/s (heavy slow tail, like the
        # speeds).  Drawn only when the model is on, so legacy configs keep
        # a bit-identical RNG stream.
        self._up_bw: Optional[dict[int, float]] = None
        self._down_bw: Optional[dict[int, float]] = None
        if sim_cfg.bandwidth_model == "pareto":
            shape = sim_cfg.bandwidth_pareto_shape
            self._up_bw = {
                cid: sim_cfg.up_mbps * 1e6 / 8.0
                / float(self._rng.pareto(shape) + 1.0)
                for cid in clients
            }
            self._down_bw = {
                cid: sim_cfg.down_mbps * 1e6 / 8.0
                / float(self._rng.pareto(shape) + 1.0)
                for cid in clients
            }
        elif sim_cfg.bandwidth_model != "none":
            raise ValueError(
                f"unknown bandwidth_model {sim_cfg.bandwidth_model!r}")
        # --- client availability + scheduling state.  With
        # availability='always' none of this draws RNG or pushes events —
        # the legacy stream and heap stay bit-identical (pinned).
        self.avail: Optional[AvailabilityModel] = None
        self._offline: set[int] = set()     # currently-unavailable clients
        self._deferred: set[int] = set()    # dispatches parked until return
        self._crashed: set[int] = set()     # crash-recovery pending
        self._transfer_fail: dict[int, _Event] = {}  # pending uplink crash
        self.deferrals = 0                  # cumulative deferred dispatches
        # history grows sched columns only when the layer is exercised, so
        # default-config history keys stay those of the scheduler-free run
        self._sched_cols = (sim_cfg.availability != "always"
                            or server.cfg.scheduler != "random")
        if sim_cfg.availability != "always":
            self.avail = AvailabilityModel(sim_cfg, sorted(clients))
            # the scheduler filters every selection through this oracle
            server.scheduler.bind_availability(
                lambda cid: cid not in self._offline)
            for cid in sorted(clients):
                online, delay = self.avail.bootstrap(cid)
                if not online:
                    self._offline.add(cid)
                self._push(delay, "avail_off" if online else "avail_on",
                           cid=cid)

    # ------------------------------------------------------------ timing
    def _idle_gap(self) -> float:
        if self.cfg.speed_model != "zipf":
            return 0.0
        z = float(self._rng.zipf(self.cfg.zipf_s))
        return min(z, self.cfg.zipf_max)

    def _epoch_time(self, cid: int) -> float:
        mult = self._speed[cid] if self.cfg.speed_model == "pareto" else 1.0
        jitter = 1.0 + 0.05 * self._rng.standard_normal()
        return max(1e-3, self.cfg.base_epoch_time * mult * abs(jitter)) \
            + self._idle_gap()

    def _down_time(self, cid: int, nbytes: int) -> float:
        """Model dispatch: latency + actual downlink wire bytes over the
        per-client link rate.  Legacy broadcast payloads carry the raw f32
        model size, so ``dispatch_compression=None`` keeps the pre-dispatch
        timing bit-for-bit."""
        t = self.cfg.down_latency
        if self._down_bw is not None:
            t += nbytes / self._down_bw[cid]
        return t

    def _up_time(self, cid: int, wire_bytes: int) -> float:
        """Upload: latency + actual transport payload bytes over the uplink."""
        t = self.cfg.up_latency
        if self._up_bw is not None:
            t += wire_bytes / self._up_bw[cid]
        return t

    def _encode_time(self, payload) -> float:
        """Server-side encode cost of one dispatch payload: the f32 source
        bytes this encode actually processed over the configured encode
        rate.  Multicast cache hits report zero cost — amortisation the
        wire-byte model can't see."""
        if self.cfg.encode_mbps <= 0 or not payload.encode_cost_bytes:
            return 0.0
        return payload.encode_cost_bytes * 8.0 / (self.cfg.encode_mbps * 1e6)

    def _push(self, time: float, kind: str, **data) -> _Event:
        ev = _Event(time, next(self._seq), kind, data)
        heapq.heappush(self._heap, ev)
        return ev

    # ---------------------------------------------------------- dispatch
    def _maybe_defer(self, cid: int) -> bool:
        """Park a dispatch addressed to an offline client: it stays in
        ``_deferred`` until its renewal process brings it back (the
        avail_on handler then re-marks and dispatches it on the
        then-current global, if a concurrency slot is still free).  The
        client leaves ``server.active`` while parked — it holds no
        in-flight work, so the SEAFL sync-wait must not hold aggregation
        hostage to an offline stretch, and its slot refills immediately
        from the eligible pool.  Always False with availability off."""
        if self.avail is None or cid not in self._offline:
            return False
        self._deferred.add(cid)
        self.deferrals += 1
        self.tel.counter("sched.deferrals")
        self.tel.sim_instant("defer", self.now, track=f"client{cid}")
        self.server.active.pop(cid, None)
        self._top_up()
        return True

    def _dispatch(self, cid: int, payload=None,
                  encode_delay: Optional[float] = None):
        # defensive deferral: selection already filters offline clients,
        # but contributor re-dispatches and restored actives can address
        # a client that went offline since the server decided
        if self._maybe_defer(cid):
            return
        E = self.server.cfg.local_epochs
        # full payload chunks are never read here (the training base is
        # reconstructed server-side), so skip materialising them
        if payload is None:
            payload = self.server.encode_dispatch(cid, materialize=False)
        if payload.ratio is not None:
            self.ratio_log.append({
                "time": self.now, "cid": cid,
                "round": payload.target_version, "ratio": payload.ratio})
        if encode_delay is None:
            enc = self._encode_time(payload)
            self.encode_seconds += enc
        else:
            # resync batching: this payload came out of the round's one
            # coalesced fold pass, whose source cost _on_aggregation
            # accounted once; the delay is that shared batch-encode time
            enc = encode_delay
        t0 = self.now + enc + self._down_time(cid, payload.nbytes)
        ends, t = [], t0
        for _ in range(E):
            t += self._epoch_time(cid)
            ends.append(t)
        train_fail = None
        if self.cfg.fail_prob > 0 and self._rng.random() < self.cfg.fail_prob:
            fail_at = t0 + self._rng.uniform(0, max(ends[-1] - t0, 1e-3))
            train_fail = self._push(fail_at, "fail", cid=cid)
        # With the bandwidth model on, a slow downlink makes the dispatch
        # window a real slice of the client's lifetime, so it must be
        # organically crashable too (mirror of the uplink-transfer hazard):
        # a crash here kills the payload before delivery and the client
        # re-requests a full snapshot.  At most one crash per dispatch — a
        # download-window crash supersedes any training-window draw, else
        # the stale training fail event would spuriously kill the client's
        # *next* dispatch after recovery.  No draws with the model off —
        # the legacy RNG stream stays untouched.
        down = t0 - self.now
        fail_ev = train_fail
        if (self._down_bw is not None and self.cfg.fail_prob > 0
                and down > 0):
            train_window = max(ends[-1] - t0, 1e-9)
            p_down = self.cfg.fail_prob * down / (down + train_window)
            if self._rng.random() < p_down:
                if train_fail is not None:
                    train_fail.valid = False
                fail_ev = self._push(self.now + self._rng.uniform(0, down),
                                     "fail", cid=cid)
        # the payload lands at t0: version tracking + downlink byte
        # accounting commit then, whether or not the client survives the
        # training that follows
        arrive = self._push(t0, "arrive", cid=cid)
        ev = self._push(ends[-1], "upload", cid=cid)
        self._inflight[cid] = InFlight(
            cid=cid, version=self.server.round, epoch_ends=ends,
            upload_event=ev, n_epochs_at_upload=E, t0=t0, payload=payload,
            arrive_event=arrive, sched=self.now, fail_event=fail_ev)

    def _notify(self, cid: int):
        """Server NOTIFY (SEAFL², Algorithm 2): arrives after down link."""
        self._push(self.now + self.cfg.down_latency, "notify", cid=cid)

    def _handle_notify(self, cid: int):
        fl = self._inflight.get(cid)
        if fl is None or fl.notified:
            return
        fl.notified = True
        # finish only the epoch in progress, then upload immediately
        done = [e for e in fl.epoch_ends if e <= self.now]
        nxt = next((e for e in fl.epoch_ends if e > self.now), None)
        if nxt is None:                        # already finished training
            return
        fl.upload_event.valid = False
        fl.n_epochs_at_upload = max(1, len(done) + 1)
        fl.upload_event = self._push(nxt, "upload", cid=cid)
        self.tel.sim_instant("notify", self.now, track=f"client{cid}",
                             epochs=fl.n_epochs_at_upload)

    # ------------------------------------------------------------ upload
    def _handle_upload(self, cid: int):
        """Training finished: materialise the local update, encode it for
        the wire, and start the uplink transfer."""
        fl = self._inflight.pop(cid, None)
        if fl is None:
            return
        # the dispatch payload was delivered at t0 (the "arrive" event);
        # training materialises lazily now, from the model the client
        # actually received — the delta reconstruction under lossy
        # dispatch, the exact global under legacy/f32 dispatch
        base = self.server.dispatch_model(cid)
        client = self.clients[cid]
        w, loss = client.local_train(base, fl.n_epochs_at_upload,
                                     self.server.cfg.local_lr)
        payload = self.server.encode_update(cid, w, fl.n_epochs_at_upload)
        self.tel.sim_span("train", fl.t0, self.now, track=f"client{cid}",
                          epochs=fl.n_epochs_at_upload, version=fl.version,
                          notified=fl.notified)
        up_time = self._up_time(cid, payload.nbytes)
        self._delivering[cid] = self._push(
            self.now + up_time, "deliver", cid=cid, payload=payload,
            loss=loss, up_t0=self.now, sched_t0=fl.sched)
        # Under the bandwidth model slow transfers can dominate a client's
        # lifetime, so they must be organically crashable too: the dispatch
        # draw covered the training window at full fail_prob; allocate the
        # transfer window a crash hazard proportional to its share of the
        # lifetime.  (No draw with the model off — legacy RNG stream and
        # fault behaviour stay untouched; the transfer is then just
        # up_latency, which the legacy draw never covered either.)
        if (self._up_bw is not None and self.cfg.fail_prob > 0
                and up_time > 0):
            train_time = max(self.now - fl.t0, 1e-9)
            p_transfer = self.cfg.fail_prob * up_time / (up_time + train_time)
            if self._rng.random() < p_transfer:
                self._transfer_fail[cid] = self._push(
                    self.now + self._rng.uniform(0, up_time),
                    "fail", cid=cid)

    def _handle_deliver(self, cid: int, payload, loss: float,
                        up_t0: Optional[float] = None,
                        sched_t0: Optional[float] = None):
        """The last wire chunk landed: the server ingests the payload into
        its (K, P) buffer slot and may aggregate."""
        self._delivering.pop(cid, None)
        self._transfer_fail.pop(cid, None)
        if sched_t0 is not None:
            # the client's full dispatch->deliver round time is the
            # scheduler's rate feature (a no-op under the random policy)
            self.server.scheduler.observe_round(cid, self.now - sched_t0)
        if up_t0 is not None:
            self.tel.sim_span("upload", up_t0, self.now,
                              track=f"client{cid}", bytes=payload.nbytes,
                              version=payload.version,
                              epochs=payload.n_epochs)
        agg = self.server.ingest_payload(payload, recv_time=self.now)
        if agg is not None:
            self._on_aggregation(agg, loss)
        if self.server.scheduler.reselect_contributors:
            # ranked policies dispatch eagerly on every delivery instead
            # of waiting for the aggregation wave: the freed slot refills
            # with the best eligible client immediately, so arrivals stay
            # staggered (a synchronized wave's cadence is its slowest
            # member; a staggered pool pipelines)
            self._top_up()

    def _on_aggregation(self, agg, last_loss: float):
        self.tel.sim_instant("aggregate", self.now, track="server",
                             round=agg.round, k=len(agg.contributors))
        # aggregation cadence is the scheduler's staleness-prediction
        # denominator (no-op under the random policy)
        self.server.scheduler.observe_aggregation(agg.round, self.now)
        rec = {"time": self.now, "round": agg.round,
               "staleness_mean": float(np.mean(agg.staleness)),
               "staleness_max": float(np.max(agg.staleness)),
               "bytes": int(self.server.bytes_uploaded),
               "bytes_down": int(self.server.bytes_downloaded),
               "encode_s": self.encode_seconds,
               "dispatch_ratio": self.server.dispatch_ratio(),
               "loss": last_loss}
        cs = self.server.cohort_stats()
        if cs is not None:
            rec["cohorts"] = cs["cohorts"]
            rec["edge_partials"] = cs["edge_partials"]
        if self._sched_cols:
            # participation columns (only when the availability/scheduler
            # layer is exercised, so default history keys are unchanged):
            # eligible = online fleet size, deferred = dispatches currently
            # parked, sched_max_wait = the longest any *eligible idle*
            # client has gone unselected (the skew detector's evidence —
            # offline waits are churn, not scheduler starvation)
            rec["sched_policy"] = self.server.scheduler.policy
            rec["eligible"] = len(self.clients) - len(self._offline)
            rec["deferred"] = len(self._deferred)
            elig_idle = [c for c in sorted(self.server.idle)
                         if c not in self._offline]
            wait, _ = self.server.scheduler.max_wait(elig_idle)
            rec["sched_max_wait"] = round(wait, 1)
        if self.eval_fn is not None and (agg.round % self.eval_every == 0):
            self.tel.counter("sim.evals")
            with self.tel.span("sim.eval", round=agg.round):
                rec["acc"] = float(self.eval_fn(self.server.params))
        if self.tel.enabled:
            # rolling metrics snapshot rides with the round record (compact:
            # histogram summaries only) — history keys are unchanged when
            # telemetry is off
            rec["telemetry"] = self.tel.snapshot(compact=True)
        mon = self.server.monitor
        if mon is not None:
            # memory watchdog: the resident-state breakdown rides every
            # round record as mem_* fields, then the detectors read the
            # finished record; alerts attach only when one fired
            for k, v in self.server.resident_state_bytes().items():
                rec[f"mem_{k}"] = v
            fired = mon.on_round(rec)
            if fired:
                rec["alerts"] = [a.to_dict() for a in fired]
        self.history.append(rec)
        for cid in agg.notify:
            self._notify(cid)
        # defer before encoding: a dispatch addressed to a client that went
        # offline since the server decided is parked, and under resync
        # batching must not waste an encode (or churn its EF) on a payload
        # that will never ship
        targets = [c for c in agg.dispatch if not self._maybe_defer(c)]
        if (self.server.cfg.resync_batching
                and self.server.dispatch is not None and targets):
            # encode the whole fan-out in one pass: cached hops fan out as
            # usual, every personalized resync fold coalesces into one
            # batched encode whose source cost is priced once
            payloads, fold_cost = self.server.encode_dispatch_round(
                targets, materialize=False)
            batch_enc = 0.0
            if self.cfg.encode_mbps > 0 and fold_cost:
                batch_enc = fold_cost * 8.0 / (self.cfg.encode_mbps * 1e6)
                self.encode_seconds += batch_enc
            for cid, p in zip(targets, payloads):
                self._dispatch(cid, payload=p,
                               encode_delay=(batch_enc if p.batched
                                             else None))
        else:
            for cid in targets:
                self._dispatch(cid)

    # ------------------------------------------------------------- faults
    def _kill_inflight(self, cid: int, instant: Optional[str] = None) -> bool:
        """Kill whatever ``cid`` has in flight — pending dispatch/training
        (upload + arrive events, so an undelivered payload dies on the
        wire and the client re-requests a full snapshot later) or a
        mid-transfer upload (deliver event) — plus any pending crash draw
        for it, so a stale fail event can't kill a future dispatch.  Used
        by both the crash path and an availability model taking the client
        offline mid-round.  Returns True if anything was in flight."""
        fl = self._inflight.pop(cid, None)
        deliver = self._delivering.pop(cid, None)
        tf = self._transfer_fail.pop(cid, None)
        if tf is not None:
            tf.valid = False
        # a crash mid-*transfer* (after training, before the last wire
        # chunk lands) kills the in-flight payload too — the encode-time
        # EF residual update stands, like a real client whose send died
        # after it updated local error memory
        if deliver is not None:
            deliver.valid = False
        if fl is None and deliver is None:
            return False
        if instant is not None:
            self.tel.sim_instant(instant, self.now, track=f"client{cid}")
        if fl is not None:
            fl.upload_event.valid = False
            if fl.fail_event is not None:
                fl.fail_event.valid = False
            # a kill inside the dispatch window voids the downlink
            # payload: it is never delivered and the client re-requests a
            # full snapshot when it next trains
            if fl.arrive_event is not None:
                fl.arrive_event.valid = False
        for c in self.server.mark_failed(cid):
            self._dispatch(c)
        return True

    def _top_up(self):
        """Fill spare concurrency slots from the eligible idle pool (used
        when a returning client re-grows the pool)."""
        spare = self.server.cfg.concurrency - len(self.server.active)
        for c in self.server._sample_idle(spare):
            self.server.mark_dispatched(c)
            self._dispatch(c)

    # --------------------------------------------------------------- run
    def run(self, max_time: float = 1e9, max_rounds: int = 10_000,
            target_acc: Optional[float] = None) -> list[dict]:
        for cid in self.server.start():
            self._dispatch(cid)
        # a restored server may list clients as in-flight whose training died
        # with the previous process: nothing in this simulator will ever
        # upload for them (and with no idle clients the run would end
        # immediately), so re-dispatch them on the current global.  Clients
        # mid-*transfer* (trained, deliver event queued) are alive — a
        # checkpoint-chunked run() boundary must not double-dispatch them.
        for cid in sorted(self.server.active):
            if cid not in self._inflight and cid not in self._delivering:
                self.server.mark_dispatched(cid)
                self._dispatch(cid)
        mon = self.server.monitor
        while self._heap:
            # peek before popping: breaking must leave the next event queued
            # so a later run() call (chunked driving) resumes it instead of
            # silently dropping one client's upload, the SLO fail-fast stop
            # included (train.py reports it and exits non-zero)
            if (self._heap[0].time > max_time
                    or self.server.round >= max_rounds
                    or (mon is not None and mon.slo_breached)):
                break
            ev = heapq.heappop(self._heap)
            if not ev.valid:
                continue
            self.now = ev.time
            with self.tel.span(f"sim.{ev.kind}", cid=ev.data.get("cid")):
                self._handle(ev)
            if target_acc is not None and self.history:
                accs = [h.get("acc", 0.0) for h in self.history]
                if accs and max(accs) >= target_acc:
                    break
        return self.history

    def _handle(self, ev: _Event) -> None:
        """One event of the heap, at ``self.now``."""
        if ev.kind == "upload":
            self._handle_upload(ev.data["cid"])
        elif ev.kind == "arrive":
            fl = self._inflight.get(ev.data["cid"])
            if fl is not None and fl.payload is not None:
                self.server.deliver_dispatch(fl.cid, fl.payload)
                self.tel.sim_span(
                    "dispatch", fl.sched, self.now,
                    track=f"client{fl.cid}", bytes=fl.payload.nbytes,
                    version=fl.payload.target_version,
                    scheme=fl.payload.scheme)
        elif ev.kind == "deliver":
            self._handle_deliver(ev.data["cid"], ev.data["payload"],
                                 ev.data["loss"],
                                 ev.data.get("up_t0"),
                                 ev.data.get("sched_t0"))
        elif ev.kind == "notify":
            self._handle_notify(ev.data["cid"])
        elif ev.kind == "fail":
            cid = ev.data["cid"]
            if self._kill_inflight(cid, instant="crash"):
                self._crashed.add(cid)
                self._push(self.now + self.cfg.recover_after,
                           "recover", cid=cid)
        elif ev.kind == "recover":
            self._crashed.discard(ev.data["cid"])
            self.server.recover(ev.data["cid"])
        elif ev.kind == "avail_off":
            cid = ev.data["cid"]
            self._offline.add(cid)
            self.tel.sim_instant("offline", self.now,
                                 track=f"client{cid}")
            # going offline mid-round kills the in-flight
            # transfer/training exactly like a crash: tracking drops,
            # the return dispatch ships a full snapshot
            self._kill_inflight(cid)
            self._push(self.now + self.avail.next_delay(cid, False),
                       "avail_on", cid=cid)
        elif ev.kind == "avail_on":
            cid = ev.data["cid"]
            self._offline.discard(cid)
            self.tel.sim_instant("online", self.now,
                                 track=f"client{cid}")
            self._push(self.now + self.avail.next_delay(cid, True),
                       "avail_off", cid=cid)
            if cid in self._deferred:
                self._deferred.discard(cid)
                if (len(self.server.active)
                        < self.server.cfg.concurrency):
                    # the parked dispatch goes out now, re-marked
                    # against the current global (tracking stayed
                    # honest: the old decision's version was never
                    # delivered)
                    self.server.mark_dispatched(cid)
                    self.server.scheduler.note_dispatched(cid)
                    self._dispatch(cid)
                else:
                    # its slot was refilled while it was away: the
                    # promise lapses, the client rejoins the pool
                    self.server.recover(cid)
            elif cid not in self._crashed:
                # back in the pool (crash recovery, if pending, keeps
                # its own clock); spare concurrency refills from the
                # now-larger eligible pool
                self.server.recover(cid)
                self._top_up()

    # ------------------------------------------------------------ metrics
    def time_to_accuracy(self, target: float) -> Optional[float]:
        """Simulated seconds when ``target`` accuracy was first reached, or
        None if it never was (a ``target_not_reached`` gauge records the
        miss so benchmark sweeps can audit silent Nones)."""
        for h in self.history:
            if h.get("acc", 0.0) >= target:
                return h["time"]
        self.tel.gauge("sim.target_not_reached", 1.0, metric="time",
                       target=target)
        return None

    def bytes_to_accuracy(self, target: float,
                          direction: str = "up") -> Optional[int]:
        """Cumulative wire bytes when ``target`` was first reached.

        ``direction``: 'up' (uplink only — the historical metric), 'down'
        (downlink only), or 'total' (both directions — the honest traffic
        number; fig7 under-reported it before the dispatch subsystem)."""
        if direction not in ("up", "down", "total"):
            raise ValueError(f"unknown direction {direction!r}")
        for h in self.history:
            if h.get("acc", 0.0) >= target:
                up, down = h["bytes"], h.get("bytes_down", 0)
                return {"up": up, "down": down,
                        "total": up + down}[direction]
        self.tel.gauge("sim.target_not_reached", 1.0, metric="bytes",
                       direction=direction, target=target)
        return None
