"""Server-side policy state machine for SEAFL / SEAFL² and baselines.

Time-free: the event-driven simulator (runtime/simulator.py) drives this
object, so the paper's protocol logic exists exactly once.

Policies (paper §VI comparison set):
  fedavg   — synchronous, waits for all M selected clients
  fedasync — aggregate-on-arrival with polynomial staleness mixing
  fedbuff  — buffer K, uniform-weight delta aggregation, no staleness limit
  seafl    — buffer K + staleness limit (sync-wait) + adaptive weights (Eqs 4-8)
  seafl2   — seafl + partial-training notifications (Algorithm 2)

Hot path: every algorithm aggregates through the flat (K, P) buffer engine
(kernels/seafl_agg, hand-written CUDA kernels on the card).  Uploads arrive
over the chunked uplink transport (runtime/transport.py: raw f32/bf16, or
topk/int8-compressed deltas against the dispatch version with per-client
flat error feedback) and are written straight into a reserved (K, P) buffer
slot.  Downlink dispatches go through the multicast ``DispatchSession``
(runtime/dispatch.py) when ``dispatch_compression`` is set: version-tracked
f32/bf16 snapshots or topk/int8 deltas against the client's held ring
version, with shared hops encoded once.  ``cohorts='on'`` makes the cohort
the unit of dispatch state (runtime/cohorts.py) and merges same-version
uploads into one buffer slot (the edge tier, ``_edge_absorb``).  Model
versions live in ``_history`` as flat (P,) f32 tensors, unpacked only at
dispatch / eval boundaries.  The buffer can store slots in bf16
(``FLConfig.buffer_dtype``); the kernels accumulate in f32 regardless.

Run health and tuning, each off by default and the untuned, unmonitored
code path when off: ``monitor='on'`` builds the run monitor
(runtime/monitor.py, never checkpointed) and implies an enabled
``Telemetry``; ``autotune='cache'|'sweep'`` resolves a ``ServerTuning``
(runtime/autotune.py) once at construction, keyed by the server's device;
``telemetry_kernels=True`` times the aggregate entry points and the chunk
codecs into ``kernel.<name>_us`` histograms, for this server's own calls.

Fault tolerance: ``state_dict`` (JSON-able control state) and
``checkpoint_trees`` (the flat tensors) go through ``repro_torch.checkpoint``
in the same format as the JAX package's, and ``load_state`` restores either
package's checkpoint.

``FLConfig`` keeps every field of the JAX package's config, so the two are
interchangeable.
"""
from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass, field, replace as dc_replace
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregation import SeaflHyper
from repro_torch.core.buffer import Update, UpdateBuffer
from repro_torch.core.packer import ParamPacker
from repro_torch.device import resolve_device
from repro_torch.kernels.seafl_agg.ops import (
    fedasync_aggregate_flat, fedavg_aggregate_flat, fedbuff_aggregate_flat,
    seafl_aggregate_flat_from_params, set_kernel_timing,
)
from repro_torch.runtime.autotune import ServerTuning
from repro_torch.runtime.codecs import Chunk, make_wire_format, \
    set_codec_timing
from repro_torch.runtime.cohorts import CohortDispatchSession
from repro_torch.runtime.dispatch import DispatchPayload, DispatchSession
from repro_torch.runtime.monitor import RunMonitor
from repro_torch.runtime.policy import DriftTracker, RatePolicy, RESYNC_MODES
from repro_torch.runtime.scheduler import make_scheduler
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.transport import (
    FlatErrorFeedback, IngestBatcher, IngestSession, UploadPayload,
    encode_update as transport_encode_update,
)
from repro_torch.tree import tree_map

Params = dict[str, torch.Tensor]

ALGORITHMS = ("seafl", "seafl2", "fedbuff", "fedasync", "fedavg")

BUFFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class FLConfig:
    algorithm: str = "seafl"
    n_clients: int = 100
    concurrency: int = 20            # M: clients training at any time
    buffer_size: int = 10            # K
    staleness_limit: Optional[float] = 10.0   # beta; None = infinity
    alpha: float = 3.0
    mu: float = 1.0
    theta: float = 0.8
    local_epochs: int = 5            # E
    local_lr: float = 0.05
    batch_size: int = 32
    use_importance: bool = True
    use_staleness: bool = True
    importance_mode: str = "delta_vs_global"   # paper Eq. 5
    fedbuff_eta_g: float = 1.0
    fedasync_alpha0: float = 0.6
    fedasync_poly_a: float = 0.5
    # uplink wire format: None (= raw f32) | 'bf16' | 'topk:<ratio>' | 'int8'
    compression: Optional[str] = None
    chunk_elems: int = 1 << 16       # wire chunk granularity (elements)
    buffer_dtype: str = "float32"    # 'float32' | 'bfloat16' slot storage
    # downlink wire format: None keeps the whole-model broadcast (no wire
    # object; the bandwidth model charges raw f32 model bytes); 'f32' |
    # 'bf16' | 'topk:<ratio>' | 'int8' serve chunked dispatch payloads with
    # per-client version tracking (runtime/dispatch.py)
    dispatch_compression: Optional[str] = None
    dispatch_history: int = 8        # global-history ring depth (versions)
    dispatch_chunk_elems: int = 1 << 16   # downlink chunk granularity
    # multicast: delta hits encode the pure ring hop once per (base,
    # target) and fan the cached chunks out; a client whose accumulated EF
    # residual exceeds dispatch_resync x |hop delta| gets one personalized
    # fold-in encode (False: per-client fold-in on every delta)
    dispatch_multicast: bool = True
    dispatch_resync: float = 4.0
    dispatch_resync_mode: str = "norm"       # 'norm' | 'bytes' (policy.py)
    # 'drift' bins the round-over-round global drift norm into bands and
    # dispatches each round at its band's top-k ratio (runtime/policy.py)
    dispatch_ratio_policy: str = "static"    # 'static' | 'drift'
    uplink_ratio_policy: str = "static"      # 'static' | 'drift'
    drift_band_edges: tuple = (0.8, 1.6)
    drift_band_ratios: tuple = (0.025, 0.05, 0.1)
    drift_ema_beta: float = 0.8
    # streaming-ingest batch queue: coalesce up to this many pending chunk
    # writes across concurrent uploads into one indexed write per flush
    # (0 = eager, one write per chunk)
    ingest_batch_chunks: int = 16
    # batched-ingest auto-bypass: a startup probe times eager chunk writes
    # against a batched flush at the actual chunk size and falls back to
    # eager pass-through where coalescing loses
    ingest_auto_bypass: bool = True
    # 'on': one shared dispatch residual and fold encode per cohort (held
    # version, drift band) instead of per client, and the edge tier that
    # merges same-version uploads into one (K, P) slot (runtime/cohorts.py)
    cohorts: str = "off"
    # coalesce one round's personalized resync re-encodes into one batched
    # encode pass (DispatchSession.encode_many)
    resync_batching: bool = False
    telemetry: bool = False
    # time each aggregate entry point and chunk encode/decode into
    # kernel.<name>_us histograms (a measurement mode: on CUDA it
    # synchronises around each call, which changes overlap, never values)
    telemetry_kernels: bool = False
    # run-health monitor (runtime/monitor.py): 'on' runs the online
    # detectors over every round record (mem_* fields, typed alerts) and
    # implies telemetry; 'off' is the monitor-free stack
    monitor: str = "off"
    # fail-fast SLO: severities and/or detector names (monitor.parse_slo);
    # a violating alert stops the simulator at the next event boundary
    slo: Optional[str] = None
    monitor_byte_budget: Optional[int] = None
    # client-selection policy (runtime/scheduler.py): 'random' reproduces
    # the uniform draw RNG-call-for-RNG-call; 'stragglers_last' and
    # 'rate_staleness' rank eligible clients by predicted round time
    scheduler: str = "random"
    # per-device kernel tuning (runtime/autotune.py): 'off' runs the
    # defaults; 'cache' applies cached winners; 'sweep' measures this
    # server's shapes first and persists the winners
    autotune: str = "off"
    seed: int = 0

    def hyper(self) -> SeaflHyper:
        beta = self.staleness_limit if self.staleness_limit is not None else 1e9
        return SeaflHyper(alpha=self.alpha, mu=self.mu, beta=float(beta),
                          theta=self.theta, use_importance=self.use_importance,
                          use_staleness=self.use_staleness)


@dataclass
class AggregationEvent:
    round: int
    weights: Optional[np.ndarray]
    staleness: Optional[np.ndarray]
    contributors: list[int]
    dispatch: list[int] = field(default_factory=list)
    notify: list[int] = field(default_factory=list)


def _timing_scope(method):
    """A server call that encodes, decodes or aggregates: the server's own
    kernel timing (its Telemetry, or None) is installed in the codec and
    aggregate hooks for the length of the call, and what was there before
    is put back.  A server never times another's calls, nor leaves its
    hooks behind."""
    @functools.wraps(method)
    def scoped(self, *args, **kw):
        prev_k = set_kernel_timing(self._kernel_tel)
        prev_c = set_codec_timing(self._kernel_tel)
        try:
            return method(self, *args, **kw)
        finally:
            set_kernel_timing(prev_k)
            set_codec_timing(prev_c)
    return scoped


class SeaflServer:
    """Holds global params (flat), buffer, version history, client activity.

    ``params`` (a dict of tensors, nested or dotted) fixes the flat layout
    and is the initial global; everything the server keeps lives on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, cfg: FLConfig, params: Params,
                 client_sizes: dict[int, int],
                 telemetry: Optional[Telemetry] = None, device=None):
        if cfg.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                             f"got {cfg.algorithm!r}")
        if cfg.buffer_dtype not in BUFFER_DTYPES:
            raise ValueError(f"buffer_dtype must be one of "
                             f"{sorted(BUFFER_DTYPES)}, got {cfg.buffer_dtype}")
        for name, val in (("monitor", cfg.monitor), ("cohorts", cfg.cohorts)):
            if val not in ("off", "on"):
                raise ValueError(f"{name} must be 'off' or 'on', got {val!r}")
        if cfg.autotune not in ("off", "cache", "sweep"):
            raise ValueError(f"autotune must be 'off', 'cache' or 'sweep', "
                             f"got {cfg.autotune!r}")
        if cfg.dispatch_resync_mode not in RESYNC_MODES:
            raise ValueError(f"dispatch_resync_mode must be one of "
                             f"{RESYNC_MODES}, got "
                             f"{cfg.dispatch_resync_mode!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # the monitor consumes telemetry (compact snapshots, sim-track busy
        # time), so monitor='on' implies an enabled registry
        self.tel = (telemetry if telemetry is not None
                    else Telemetry(enabled=cfg.telemetry
                                   or cfg.monitor == "on"))
        # built eagerly so a bad SLO spec fails at construction; never
        # checkpointed (detectors restart cold on resume)
        self.monitor: Optional[RunMonitor] = (
            RunMonitor.from_config(cfg, self.tel)
            if cfg.monitor == "on" else None)
        # pluggable client-selection policy: built eagerly (bad names fail
        # at construction)
        self.scheduler = make_scheduler(cfg.scheduler, self.tel)
        self.wire = make_wire_format(cfg.compression, cfg.chunk_elems)
        self._cohorts_on = cfg.cohorts == "on"
        self.dispatch: Optional[DispatchSession] = None
        if cfg.dispatch_compression is not None:
            sess_cls = (CohortDispatchSession if self._cohorts_on
                        else DispatchSession)
            self.dispatch = sess_cls(
                make_wire_format(cfg.dispatch_compression,
                                 cfg.dispatch_chunk_elems),
                cfg.dispatch_history,
                multicast=cfg.dispatch_multicast,
                resync=cfg.dispatch_resync,
                resync_mode=cfg.dispatch_resync_mode,
                telemetry=self.tel)
        # drift-adaptive rate policy: validated here so a bad band config
        # fails at construction, not mid-run
        self.rate_policy = RatePolicy.from_config(cfg)
        if cfg.dispatch_ratio_policy == "drift" and (
                self.dispatch is None
                or self.dispatch.fmt.scheme != "topk"):
            raise ValueError(
                "dispatch_ratio_policy='drift' adapts the top-k dispatch "
                "ratio and needs dispatch_compression='topk:<ratio>'")
        if cfg.uplink_ratio_policy == "drift" and self.wire.scheme != "topk":
            raise ValueError(
                "uplink_ratio_policy='drift' adapts the top-k uplink "
                "ratio and needs compression='topk:<ratio>'")
        self._drift = DriftTracker(cfg.drift_ema_beta)
        self._ratio_by_version: dict[int, float] = {}
        self.packer = ParamPacker(params)
        self._flat = self.packer.pack(params).to(self.device)   # (P,) global
        self.round = 0
        self._buffer_dtype = BUFFER_DTYPES[cfg.buffer_dtype]
        # per-device tuning, resolved once here.  'off' keeps the tuner out
        # of every code path (self.tuning is None and nothing below consults
        # it); a tuned chunk_elems rebuilds the uplink's wire format
        self.tuning: Optional[ServerTuning] = None
        if cfg.autotune != "off":
            self.tuning = ServerTuning.build(
                cfg.autotune, p=self.packer.size, k=self._trigger_size(),
                dtype=self._buffer_dtype, scheme=self.wire.scheme,
                algorithm=cfg.algorithm, chunk_elems=cfg.chunk_elems,
                flush_chunks=cfg.ingest_batch_chunks, telemetry=self.tel,
                device=self.device)
            ce = self.tuning.chunk_elems(cfg.chunk_elems)
            if ce != self.wire.chunk_elems:
                self.wire = make_wire_format(cfg.compression, ce)
        self.buffer = UpdateBuffer(self._trigger_size(), self.packer.size,
                                   dtype=self._buffer_dtype,
                                   telemetry=self.tel, device=self.device)
        self._batcher = self._make_batcher()
        # kernel timing: this server's Telemetry, installed for the length
        # of each of its calls that encodes, decodes or aggregates
        # (_timing_scope), None without telemetry_kernels
        self._kernel_tel = (self.tel if self.tel.enabled
                            and cfg.telemetry_kernels else None)
        # two-tier edge aggregation (cohorts='on'): same-version uploads
        # pre-combine into one resident (P,) partial per version, and the
        # trigger counts uploads absorbed since the last aggregation
        self._edge_slots: dict[int, tuple[int, Update]] = {}
        self._updates_since_agg = 0
        self._edge_merges_round = 0
        self._edge_merges_total = 0
        self._edge_partials_last = 0
        self.client_sizes = client_sizes
        self.active: dict[int, int] = {}         # cid -> version t_k
        self.idle: set[int] = set(client_sizes)
        self._history: dict[int, torch.Tensor] = {0: self._flat}
        self._unpack_cache: dict[int, Params] = {}
        self._notified: set[int] = set()
        self._rng = np.random.default_rng(cfg.seed)
        self.total_aggregations = 0
        self.bytes_uploaded = 0                  # uplink wire bytes
        self.bytes_downloaded = 0                # downlink wire bytes
        self._ef: dict[int, FlatErrorFeedback] = {}
        self._ingests: dict[int, IngestSession] = {}   # cid -> mid-stream

    # ------------------------------------------------------------- plumbing
    def _make_batcher(self) -> Optional[IngestBatcher]:
        """Ingest batcher over the current buffer: under tuning a cached
        bypass verdict answers without the startup probe and the swept
        flush size replaces the configured one."""
        cfg = self.cfg
        if cfg.ingest_batch_chunks <= 0:
            return None
        flush, verdict = cfg.ingest_batch_chunks, None
        if self.tuning is not None:
            flush = self.tuning.ingest_flush_chunks(flush)
            verdict = self.tuning.ingest_verdict
        return IngestBatcher(self.buffer, flush,
                             auto_bypass=cfg.ingest_auto_bypass,
                             telemetry=self.tel, tuned_verdict=verdict)

    def _trigger_size(self) -> int:
        if self.cfg.algorithm == "fedavg":
            return self.cfg.concurrency
        if self.cfg.algorithm == "fedasync":
            return 1
        return self.cfg.buffer_size

    @property
    def params(self) -> Params:
        """Current global model as a params dict (dispatch/eval boundary)."""
        return self.params_at(self.round)

    @property
    def global_flat(self) -> torch.Tensor:
        return self._flat

    def flat_at(self, version: int) -> torch.Tensor:
        return self._history[version]

    def params_at(self, version: int) -> Params:
        if version not in self._unpack_cache:
            self._unpack_cache[version] = self.packer.unpack(
                self._history[version])
        return self._unpack_cache[version]

    def staleness_of(self, cid: int) -> int:
        return self.round - self.active[cid]

    def _gc_history(self):
        live = set(self.active.values()) | {self.round}
        if self.dispatch is not None and self.dispatch.fmt.delta_coded:
            # the bounded dispatch ring: keep the last `dispatch_history`
            # globals so returning clients can receive deltas against the
            # version they hold (raw schemes never read old versions)
            live |= self.dispatch.ring_versions(self.round)
        self._history = {v: p for v, p in self._history.items() if v in live}
        self._unpack_cache = {v: p for v, p in self._unpack_cache.items()
                              if v in live}
        # chosen per-version ratios die with the versions they encode for
        self._ratio_by_version = {v: r for v, r in
                                  self._ratio_by_version.items()
                                  if v in self._history}
        if self.dispatch is not None:
            # encode-cache entries age out with the ring they index into
            self.dispatch.age_cache(self.round)

    def _sample_idle(self, k: int) -> list[int]:
        """Every idle-pool draw routes through the scheduler policy: it
        filters offline clients out (when the simulator bound an
        availability model) and ranks or samples the rest.  The default
        RandomScheduler consumes ``self._rng`` exactly like the JAX
        package's server."""
        return self.scheduler.select(sorted(self.idle), k, self._rng,
                                     round_=self.round)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> list[int]:
        """Dispatch up to M in-flight clients (top-up, so calling it on a
        resumed server never over-subscribes the fleet)."""
        cids = self._sample_idle(self.cfg.concurrency - len(self.active))
        for c in cids:
            self.mark_dispatched(c)
        return cids

    def mark_dispatched(self, cid: int):
        self.idle.discard(cid)
        self.active[cid] = self.round
        self._notified.discard(cid)

    def mark_failed(self, cid: int):
        """Client died mid-training: return a replacement dispatch if any."""
        self.active.pop(cid, None)
        self.abort_ingest(cid)           # a mid-stream upload dies with it
        if self.dispatch is not None:
            # the device lost its model: version tracking is void and its
            # next dispatch re-requests a full snapshot
            self.dispatch.drop(cid)
        # the dead client may rejoin the idle pool later (recovery)
        repl = self._sample_idle(1)
        for c in repl:
            self.mark_dispatched(c)
        return repl

    def recover(self, cid: int):
        if cid not in self.active:
            self.idle.add(cid)

    # --------------------------------------------------------------- policy
    def _blocked_by_stale(self) -> bool:
        """SEAFL sync-wait (paper §IV-B): hold aggregation while any
        in-flight client's update would exceed the staleness limit."""
        if self.cfg.algorithm not in ("seafl", "seafl2"):
            return False
        if self.cfg.staleness_limit is None:
            return False
        return any(self.round - v >= self.cfg.staleness_limit
                   for v in self.active.values())

    def clients_to_notify(self) -> list[int]:
        """SEAFL² (Algorithm 2): in-flight clients at/over the limit get a
        NOTIFY and will upload after their current epoch."""
        if self.cfg.algorithm != "seafl2" or self.cfg.staleness_limit is None:
            return []
        out = [c for c, v in self.active.items()
               if (self.round - v) >= self.cfg.staleness_limit
               and c not in self._notified]
        self._notified.update(out)
        return out

    # ----------------------------------------------------- downlink transport
    def _dispatch_ratio_of(self, target: int) -> Optional[float]:
        if self.cfg.dispatch_ratio_policy == "drift":
            return self._ratio_by_version.get(target)
        return None

    @_timing_scope
    def encode_dispatch(self, cid: int,
                        materialize: bool = True) -> DispatchPayload:
        """Serve the current global to ``cid``.

        With ``dispatch_compression=None`` there is no wire object: a marker
        payload whose ``nbytes`` is the raw f32 model size.  Otherwise the
        DispatchSession encodes chunked f32/bf16 snapshots or topk/int8
        deltas against the client's held ring version
        (``materialize=False`` skips building full chunks whose bytes have a
        closed form, the simulator's path).  Tracking state is untouched
        until :meth:`deliver_dispatch`."""
        target = self.active.get(cid, self.round)
        if self.dispatch is None:
            return DispatchPayload(
                cid=cid, target_version=target, base_version=None,
                scheme="raw", param_size=self.packer.size, chunks=None,
                nbytes=4 * self.packer.size,
                encode_cost_bytes=4 * self.packer.size)
        with self.tel.span("dispatch.encode", cid=cid, version=target):
            return self.dispatch.encode(cid, target, self._history,
                                        materialize=materialize,
                                        ratio=self._dispatch_ratio_of(target))

    @_timing_scope
    def encode_dispatch_round(self, cids: list[int],
                              materialize: bool = True
                              ) -> tuple[list[DispatchPayload], int]:
        """Encode one aggregation round's dispatch fan-out in one pass
        (``DispatchSession.encode_many``): every personalized resync fold-in
        coalesces into one batched encode per wire format.  Returns
        ``(payloads, fold_cost_bytes)``, payloads aligned to ``cids`` and
        byte-identical to sequential :meth:`encode_dispatch` calls."""
        if self.dispatch is None:
            return ([self.encode_dispatch(c, materialize) for c in cids], 0)
        reqs = []
        for cid in cids:
            target = self.active.get(cid, self.round)
            reqs.append((cid, target, self._dispatch_ratio_of(target)))
        return self.dispatch.encode_many(reqs, self._history,
                                         materialize=materialize)

    def dispatch_ratio(self, version: Optional[int] = None) -> Optional[float]:
        """Top-k dispatch ratio for dispatches of ``version`` (default: the
        current round): the drift band's ratio under the adaptive policy,
        the static ratio for top-k dispatch, None for other schemes."""
        if self.dispatch is None or self.dispatch.fmt.scheme != "topk":
            return None
        v = self.round if version is None else version
        r = self._dispatch_ratio_of(v)
        return self.dispatch.fmt.topk_ratio if r is None else r

    @_timing_scope
    def deliver_dispatch(self, cid: int, payload: DispatchPayload) -> None:
        """The last downlink chunk reached the client: account the wire
        bytes and commit version tracking + error-feedback residual."""
        self.bytes_downloaded += payload.nbytes
        if self.dispatch is not None and payload.scheme != "raw":
            self.dispatch.deliver(payload)

    @_timing_scope
    def dispatch_model(self, cid: int) -> Params:
        """The model ``cid`` holds (training-base boundary): the exact
        dispatch-version global under the broadcast or f32 dispatch, the
        delivered reconstruction under a lossy dispatch."""
        with self.tel.span("dispatch.model", cid=cid):
            if self.dispatch is None or cid not in self.dispatch.versions:
                return self.params_at(self.active[cid])
            v = self.dispatch.versions[cid]
            held = self.dispatch.held_flat(cid, self._history)
            if held is self._history.get(v):
                return self.params_at(v)
            return self.packer.unpack(held)

    # ------------------------------------------------------- uplink transport
    @_timing_scope
    def encode_update(self, cid: int, client_params: Params,
                      n_epochs: int) -> UploadPayload:
        """Client-side encoder (simulated on the server object): pack once,
        then serialise to wire chunks per the configured WireFormat.  For
        delta-coded schemes (topk/int8) the delta is taken against the
        dispatch version and the client's flat error-feedback residual is
        folded in and updated."""
        version = self.active[cid]
        with self.tel.span("encode", cid=cid, version=version):
            with self.tel.span("encode.pack", cid=cid, version=version):
                flat = self.packer.pack(client_params)
            wire = self.wire
            if wire.scheme == "topk":
                if self.cfg.uplink_ratio_policy == "drift":
                    # the drift band chosen for the version this client
                    # trained from also sizes its upload
                    r = self._ratio_by_version.get(version)
                    if r is not None:
                        wire = dc_replace(wire, topk_ratio=r)
                if n_epochs < self.cfg.local_epochs:
                    # SEAFL² byte coupling: a notified partial-training
                    # client did n' < E epochs of work, so it ships
                    # proportionally fewer coefficients (decode is
                    # ratio-free: top-k chunks carry their own indices)
                    wire = dc_replace(
                        wire, topk_ratio=wire.topk_ratio
                        * max(1, n_epochs) / self.cfg.local_epochs)
            base = ef = None
            if wire.delta_coded:
                base = self._uplink_base(cid, version)
                ef = self._ef.setdefault(cid, FlatErrorFeedback())
            with self.tel.span("encode.chunks", cid=cid, version=version):
                payload = transport_encode_update(cid, version, n_epochs,
                                                  flat, wire, base, ef)
            self.tel.counter("encode.chunks", len(payload.chunks))
            self.tel.counter("encode.bytes", payload.nbytes)
            return payload

    def _uplink_base(self, cid: int, version: int) -> torch.Tensor:
        """The flat base a delta-coded upload is measured against.

        Under a lossy dispatch the client trained from the *delivered*
        reconstruction (``held = ring[version] - dispatch residual``), so
        its delta is measured against that, and the server, which knows the
        residual, decodes against the same base.  Exact dispatch (the
        broadcast, f32, or no tracking for this client) keeps the
        snapshot."""
        if (self.dispatch is not None
                and self.dispatch.versions.get(cid) == version):
            return self.dispatch.held_flat(cid, self._history)
        return self._history[version]

    @_timing_scope
    def begin_ingest(self, cid: int, version: int, n_epochs: int,
                     recv_time: float = 0.0) -> IngestSession:
        """Open a streaming ingest: reserve a buffer slot for ``cid``'s
        upload and return the session that decodes chunks into it."""
        if cid in self._ingests:
            raise RuntimeError(f"client {cid} already has an ingest open")
        base = (self._uplink_base(cid, version) if self.wire.delta_coded
                else None)
        slot = self.buffer.reserve(Update(
            client_id=cid, n_samples=self.client_sizes[cid], version=version,
            n_epochs=n_epochs, recv_time=recv_time))
        sess = IngestSession(self.buffer, slot, self.wire, base,
                             param_size=self.packer.size,
                             batcher=self._batcher)
        self._ingests[cid] = sess
        return sess

    @_timing_scope
    def ingest_chunk(self, cid: int, chunk: Chunk) -> None:
        self._ingests[cid].write(chunk)

    def abort_ingest(self, cid: int) -> None:
        """Drop a mid-stream upload (truncated stream, dead client): the
        session is discarded and its reserved buffer slot is recycled."""
        sess = self._ingests.pop(cid, None)
        if sess is not None:
            if self._batcher is not None:
                self._batcher.cancel_slot(sess.slot)
            self.buffer.release(sess.slot)

    @_timing_scope
    def finish_ingest(self, cid: int,
                      recv_time: float = 0.0) -> Optional[AggregationEvent]:
        """Close the stream: validate coverage, commit the slot, account the
        wire bytes, and aggregate if the buffer triggered.  On incomplete
        coverage the session stays open."""
        sess = self._ingests[cid]
        nbytes = sess.finish()           # raises while coverage is incomplete
        del self._ingests[cid]
        self.bytes_uploaded += nbytes
        self.tel.counter("ingest.commits")
        self.tel.histogram("ingest.upload_bytes", nbytes)
        if self._batcher is not None:
            # readers only ever see flushed rows
            self._batcher.flush()
        self.buffer.commit(sess.slot)
        self._updates_since_agg += 1
        if self._cohorts_on and self.buffer.capacity > 1:
            self._edge_absorb(sess.slot)
        self.active.pop(cid, None)
        self.idle.add(cid)
        filled = (self._updates_since_agg if self._cohorts_on
                  else len(self.buffer))
        if (filled >= self.buffer.capacity
                and not self._blocked_by_stale()):
            return self._aggregate(recv_time)
        return None

    def _edge_absorb(self, slot: int) -> None:
        """Two-tier aggregation, edge tier: fold the just-committed upload
        into its version's resident partial.

        The first upload of a version this round claims its slot as the
        version's partial; every later same-version upload merges into it
        as a sample-weighted mean and its own row returns to the free pool.
        The partial's metadata accumulates the contributor ids
        (``meta['merged_cids']``) and the sample count, so the Eq. (4)-(8)
        weights see one slot per version carrying the cohort's mass, while
        the trigger still counts raw uploads."""
        hu, _ = self.buffer._committed[-1]
        v = hu.version
        held = self._edge_slots.get(v)
        if held is None:
            self._edge_slots[v] = (slot, hu)
            return
        hslot, head = held
        self.buffer.merge_rows(hslot, slot, float(head.n_samples),
                               float(hu.n_samples))
        head.meta.setdefault("merged_cids",
                             [head.client_id]).append(hu.client_id)
        head.n_samples += hu.n_samples
        head.recv_time = hu.recv_time
        head.n_epochs = max(head.n_epochs, hu.n_epochs)
        self.buffer.uncommit(slot)
        self._edge_merges_round += 1
        self._edge_merges_total += 1

    @_timing_scope
    def ingest_payload(self, payload: UploadPayload,
                       recv_time: float = 0.0) -> Optional[AggregationEvent]:
        """Atomic ingest of a whole wire payload (the simulator's deliver
        event): the chunks are adjacent windows of one slot, so they land
        with one write (``IngestSession.write_all``)."""
        tel, cid, version = self.tel, payload.cid, payload.version
        with tel.span("ingest", cid=cid, version=version):
            sess = self.begin_ingest(cid, version, payload.n_epochs,
                                     recv_time=recv_time)
            with tel.span("ingest.write", cid=cid, version=version):
                sess.write_all(payload.chunks)
            with tel.span("ingest.commit", cid=cid, version=version):
                return self.finish_ingest(cid, recv_time)

    @_timing_scope
    def on_update(self, cid: int, client_params: Params, n_epochs: int,
                  recv_time: float = 0.0) -> Optional[AggregationEvent]:
        """Encode + ingest in one step (callers without an explicit wire)."""
        payload = self.encode_update(cid, client_params, n_epochs)
        return self.ingest_payload(payload, recv_time)

    # ----------------------------------------------------------- aggregate
    def _aggregate(self, now: float) -> AggregationEvent:
        """One server aggregation, entirely on the flat (K, P) engine.  The
        new global is a new tensor: ``_history`` still holds the old one.
        On a buffer whose rows shard over 'pod' the engine is handed each
        rank's own rows (``buffer.LocalRows``) and reduces across 'pod';
        the new global is whole on every rank."""
        cfg = self.cfg
        prev_flat = self._flat            # drift observation base
        updates = self.buffer.updates()
        staleness = np.asarray([self.round - u.version for u in updates],
                               np.float32)
        sizes = np.asarray([u.n_samples for u in updates], np.float32)
        stacked = self.buffer.stacked_flat()   # f32 or bf16 slots; kernels
        weights = None                         # accumulate in f32 either way
        # tuned grids (None without tuning: the untuned calls): the
        # baselines ride the raw fused pass, seafl/seafl2 the delta-free one
        grid_w = grid_s = None
        if self.tuning is not None:
            grid_w = self.tuning.agg_plan("weighted_aggregate")
            grid_s = self.tuning.agg_plan("seafl_aggregate_flat_from_params")

        with self.tel.span("server.aggregate", round=self.round,
                           k=len(updates), algorithm=cfg.algorithm):
            if cfg.algorithm == "fedavg":
                self._flat, w = fedavg_aggregate_flat(self._flat, stacked,
                                                      sizes, block_p=grid_w)
                weights = w.cpu().numpy()
            elif cfg.algorithm == "fedasync":
                # K = 1 shards over no pod: the row is the buffer's own
                # unless a spill grew it (then gathered once)
                self._flat = fedasync_aggregate_flat(
                    self._flat, self.buffer.row(0), staleness[0],
                    cfg.fedasync_alpha0, cfg.fedasync_poly_a, block_p=grid_w)
            elif cfg.algorithm == "fedbuff":
                # fedbuff_aggregate_flat yields w_t + eta*mean(w_k - w_t);
                # true FedBuff deltas are vs each client's dispatch version,
                # so add eta*(w_t - mean_k base_k) — a tiny combination over
                # the few distinct live versions, not another (K, P) pass.
                g, k = self._flat, float(len(updates))
                mixed, w = fedbuff_aggregate_flat(g, stacked,
                                                  cfg.fedbuff_eta_g,
                                                  block_p=grid_w)
                counts: dict[int, int] = {}
                for u in updates:
                    counts[u.version] = counts.get(u.version, 0) + 1
                base_mix = sum((n / k) * self._history[v]
                               for v, n in counts.items())
                self._flat = mixed + cfg.fedbuff_eta_g * (g - base_mix)
                weights = w.cpu().numpy()
            else:  # seafl / seafl2 — Eqs. (4)-(8), delta-free
                # Eq. (5) importance is measured against the *current*
                # global: cos(w_k - w_t^g, w_t^g), not the dispatch-version
                # base, so the buffer never has to store deltas.
                h = cfg.hyper()
                self._flat, w = seafl_aggregate_flat_from_params(
                    self._flat, stacked, sizes, staleness, h.alpha, h.mu,
                    h.beta, h.theta, use_importance=h.use_importance,
                    use_staleness=h.use_staleness, block_p=grid_s)
                weights = w.cpu().numpy()

        if self.tel.enabled:
            self.tel.counter("agg.count")
            self.tel.gauge("agg.buffer_fill", len(updates))
            self.tel.histogram_many("agg.staleness", staleness)
            if weights is not None:
                self.tel.histogram_many("agg.weight", weights)

        # an edge partial contributes every client it absorbed; a plain
        # slot its own id
        contributors = [c for u in updates
                        for c in u.meta.get("merged_cids", [u.client_id])]
        self.buffer.drain()
        self._edge_partials_last = self._edge_merges_round
        self._edge_merges_round = 0
        self._edge_slots = {}
        self._updates_since_agg = 0
        self.round += 1
        self.total_aggregations += 1
        self._history[self.round] = self._flat
        if self.rate_policy.active:
            # one scalar per aggregation: the round-over-round drift norm,
            # EMA-normalised and binned into a discrete ratio band, chosen
            # once per target version
            x = self._drift.observe(
                float(torch.linalg.norm(self._flat - prev_flat)))
            self._ratio_by_version[self.round] = \
                self.rate_policy.ratio_for(x, telemetry=self.tel)
        self._gc_history()

        # contributors + top-up to M go back to training on the new model.
        # Only contributors still idle: a crash replacement may have
        # re-dispatched a buffered contributor between its delivery and this
        # aggregation.
        dispatch = [c for c in dict.fromkeys(contributors) if c in self.idle]
        if self.scheduler.reselect_contributors:
            # ranked policies re-select the whole fan-out from the idle pool
            dispatch = self._sample_idle(
                self.cfg.concurrency - len(self.active))
            for c in dispatch:
                self.mark_dispatched(c)
        else:
            for c in dispatch:
                self.mark_dispatched(c)
            top_up = self._sample_idle(
                self.cfg.concurrency - len(self.active))
            for c in top_up:
                self.mark_dispatched(c)
            dispatch += top_up

        return AggregationEvent(
            round=self.round, weights=weights, staleness=staleness,
            contributors=contributors, dispatch=dispatch,
            notify=self.clients_to_notify())

    # ------------------------------------------------------- fleet telemetry
    def cohort_stats(self) -> Optional[dict]:
        """Cohort-layer occupancy (None when ``cohorts='off'``): the live
        cohort count of the dispatch table (0 without a dispatch session)
        and the edge merges of the round that just aggregated."""
        if not self._cohorts_on:
            return None
        return {
            "cohorts": (self.dispatch.table.n_cohorts()
                        if isinstance(self.dispatch, CohortDispatchSession)
                        else 0),
            "edge_partials": int(self._edge_partials_last),
            "edge_merges_total": int(self._edge_merges_total),
        }

    def resident_state_bytes(self) -> dict:
        """Server-resident fleet state, in bytes.

        ``server_array_bytes`` sums the (P,)-scaled state the server holds
        (history ring, (K, P) buffer, dispatch residuals), which must stay
        ~O(cohorts + ring) as the fleet grows; ``tracking_entries`` counts
        the per-client scalar entries (held versions).  ``client_ef_bytes``
        is apart: uplink error-feedback residuals live on the devices in a
        deployment and are only simulated here.  Counted as the reference
        counts them, 4 bytes an element."""
        hist = sum(int(v.numel()) * 4 for v in self._history.values())
        buf = int(self.buffer.hbm_bytes)
        ef = sum(int(e.residual.numel()) * 4 for e in self._ef.values()
                 if e.residual is not None)
        disp = cache = tracking = 0
        if self.dispatch is not None:
            tracking = len(self.dispatch.versions)
            if isinstance(self.dispatch, CohortDispatchSession):
                disp = self.dispatch.table.resident_bytes()
            else:
                disp = sum(int(r.numel()) * 4
                           for r in self.dispatch.residuals.values())
            for ent in self.dispatch._cache.values():
                cache += int(ent[2])
                if ent[1] is not None:
                    cache += int(ent[1].numel()) * 4
        return {
            "history_bytes": hist,
            "buffer_bytes": buf,
            "dispatch_residual_bytes": disp,
            "client_ef_bytes": ef,
            "encode_cache_bytes": cache,
            "tracking_entries": tracking,
            "edge_partial_slots": len(self._edge_slots),
            "server_array_bytes": hist + buf + disp,
        }

    # ------------------------------------------------------ fault tolerance
    def state_dict(self) -> dict:
        """JSON-able control state (the tensors are saved separately, from
        :meth:`checkpoint_trees`), with the JAX package's keys.  Committed
        buffer slots are persisted -- a checkpoint taken while SEAFL
        sync-wait holds aggregation must not drop a non-empty buffer.
        Uploads still mid-stream are *not*: their clients stay active, so a
        restored driver re-dispatches them and the upload is re-sent."""
        return {
            "round": self.round,
            "active": {str(k): int(v) for k, v in self.active.items()},
            "idle": sorted(self.idle),
            "notified": sorted(self._notified),
            "total_aggregations": self.total_aggregations,
            "bytes_uploaded": int(self.bytes_uploaded),
            "bytes_downloaded": int(self.bytes_downloaded),
            "dispatch": (self.dispatch.state_dict()
                         if self.dispatch is not None else None),
            "drift": self._drift.state_dict(),
            "ratio_by_version": {str(v): float(r) for v, r in
                                 self._ratio_by_version.items()},
            "rng": self._rng.bit_generator.state,
            "history_versions": sorted(self._history),
            # a slot's meta rides along only when non-empty
            "buffer": [
                dict({"client_id": u.client_id, "n_samples": u.n_samples,
                      "version": u.version, "n_epochs": u.n_epochs,
                      "recv_time": u.recv_time},
                     **({"meta": u.meta} if u.meta else {}))
                for u in self.buffer.updates()
            ],
            "ef_clients": sorted(c for c, ef in self._ef.items()
                                 if ef.residual is not None),
            **({
                # cohort mode: the upload counter decouples the trigger
                # from the committed-slot count, and edge partials re-link
                # to their rebuilt rows by committed index
                "updates_since_agg": int(self._updates_since_agg),
                "edge_slots": [
                    [int(v), next(i for i, (u, _) in
                                  enumerate(self.buffer._committed)
                                  if u is hu)]
                    for v, (_, hu) in self._edge_slots.items()
                ],
            } if self._cohorts_on else {}),
            # the metrics snapshot rides along only when telemetry is on
            **({"telemetry": self.tel.snapshot()}
               if self.tel.enabled else {}),
        }

    def checkpoint_trees(self) -> dict:
        """Tensors to persist: the flat model at each live version
        (``v{version}``), each client's error-feedback residual
        (``ef{cid}``; without them a restart under a delta-coded uplink
        resets error memory), the dispatch residuals (``dr{cid}``, or the
        cohort residuals ``cr{i}``) and the committed buffer rows (``slot{i}``, in
        the buffer's dtype).  They are the live tensors, not copies: the
        Checkpointer copies them to the host before it returns.  On a mesh
        that shards the buffer's rows or the cohort residuals over 'pod',
        each is whole on every rank (gathered here: every rank calls it),
        the one-device run's trees."""
        trees = {f"v{v}": p for v, p in self._history.items()}
        for cid, ef in self._ef.items():
            if ef.residual is not None:
                trees[f"ef{cid}"] = ef.residual
        if self.dispatch is not None:
            trees.update(self.dispatch.residual_trees())
        for i in range(len(self.buffer)):
            trees[f"slot{i}"] = self.buffer.row(i)
        return trees

    def load_state(self, state: dict, trees: dict):
        """Restore from :meth:`state_dict` / :meth:`checkpoint_trees` as
        either package wrote them (tensors or arrays; keys of layers off
        or not ported are dropped with a warning where they carry state)."""
        def tensor(x, dtype=None):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
            return t.to(device=self.device, dtype=dtype)

        self.round = int(state["round"])
        self.active = {int(k): int(v) for k, v in state["active"].items()}
        self.idle = set(state["idle"])
        self._notified = set(state["notified"])
        self.total_aggregations = int(state["total_aggregations"])
        self.bytes_uploaded = int(state.get("bytes_uploaded", 0))
        self.bytes_downloaded = int(state.get("bytes_downloaded", 0))
        disp_state = state.get("dispatch")
        disp_trees = {k: v for k, v in trees.items()
                      if k.startswith(("dr", "cr"))}
        if disp_state is not None and self.dispatch is None:
            warnings.warn(
                "checkpoint carries dispatch version-tracking state but the "
                "restored config has dispatch_compression=None; dropping it "
                "(all clients will receive full legacy broadcasts)")
        elif self.dispatch is not None:
            if disp_state is not None and \
                    disp_state.get("scheme") != self.dispatch.fmt.scheme:
                warnings.warn(
                    f"checkpoint dispatch state was written under scheme "
                    f"'{disp_state.get('scheme')}' but the restored config "
                    f"uses '{self.dispatch.fmt.scheme}'; dropping tracking "
                    f"state (clients re-request full snapshots)")
                disp_state, disp_trees = None, {}
            if disp_state is not None and \
                    ("cohort" in disp_state) != isinstance(
                        self.dispatch, CohortDispatchSession):
                # per-client residuals cannot seed cohort tables (or the
                # reverse): crossing modes drops tracking
                warnings.warn(
                    "checkpoint dispatch state was written under the "
                    f"{'cohort' if 'cohort' in disp_state else 'per-client'}"
                    " fleet-state mode but the restored config uses "
                    f"cohorts='{self.cfg.cohorts}'; dropping tracking state "
                    "(clients re-request full snapshots)")
                disp_state, disp_trees = None, {}
            self.dispatch.load_state(disp_state or {}, disp_trees,
                                     device=self.device)
        self._drift = DriftTracker.from_state(state.get("drift"),
                                              self.cfg.drift_ema_beta)
        self._ratio_by_version = {
            int(k): float(v)
            for k, v in state.get("ratio_by_version", {}).items()}
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._history = {int(k[1:]): tensor(v, torch.float32)
                         for k, v in trees.items() if k.startswith("v")}
        self._flat = self._history[self.round]
        self._unpack_cache = {}
        self._ingests = {}
        self._ef = {}
        ef_keys = sorted(k for k in trees if k.startswith("ef"))
        if ef_keys and not self.wire.delta_coded:
            # no delta-coded uplink in the restored config: a residual is
            # meaningless (and would corrupt the next upload) -- drop it
            warnings.warn(
                f"checkpoint carries {len(ef_keys)} error-feedback "
                f"residual(s) but the restored config uses wire scheme "
                f"'{self.wire.scheme}'; dropping stale residuals")
        else:
            for k in ef_keys:
                v = trees[k]
                # flat (P,) residuals are the native format; pre-transport
                # checkpoints stored per-leaf delta trees -- pack them
                residual = (self.packer.pack(tree_map(torch.as_tensor, v))
                            if isinstance(v, dict) else v)
                self._ef[int(k[2:])] = FlatErrorFeedback(
                    tensor(residual, torch.float32))
        self.buffer = UpdateBuffer(self._trigger_size(), self.packer.size,
                                   dtype=self._buffer_dtype,
                                   telemetry=self.tel, device=self.device)
        self._batcher = self._make_batcher()
        for i, m in enumerate(state.get("buffer", [])):
            self.buffer.add(
                Update(client_id=int(m["client_id"]),
                       n_samples=int(m["n_samples"]),
                       version=int(m["version"]),
                       n_epochs=int(m["n_epochs"]),
                       recv_time=float(m["recv_time"]),
                       meta=dict(m.get("meta", {}))),
                tensor(trees[f"slot{i}"]))
        # edge-tier state: absent in off-mode checkpoints, so the counter
        # defaults to the committed-slot count and the partial map is empty
        self._updates_since_agg = int(state.get(
            "updates_since_agg", len(state.get("buffer", []))))
        self._edge_slots = {}
        for v, i in state.get("edge_slots", []):
            u, row = self.buffer._committed[int(i)]
            self._edge_slots[int(v)] = (row, u)
        self._edge_merges_round = 0
        self._edge_partials_last = 0
        if self.tel.enabled and "telemetry" in state:
            self.tel.load_snapshot(state["telemetry"])
