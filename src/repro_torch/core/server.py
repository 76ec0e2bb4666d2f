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
slot.  Model versions live in ``_history`` as flat (P,) f32 tensors,
unpacked only at dispatch / eval boundaries.  The buffer can store slots in
bf16 (``FLConfig.buffer_dtype``); the kernels accumulate in f32 regardless.

Fault tolerance: ``state_dict`` (JSON-able control state) and
``checkpoint_trees`` (the flat tensors) go through ``repro_torch.checkpoint``
in the same format as the JAX package's, and ``load_state`` restores either
package's checkpoint.

``FLConfig`` keeps every field of the JAX package's config so the two are
interchangeable; options whose modules this port does not carry yet
(version-tracked dispatch, cohorts, the run monitor, the autotuner, kernel
timing) raise ``NotImplementedError`` at construction.
"""
from __future__ import annotations

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
    seafl_aggregate_flat_from_params,
)
from repro_torch.runtime.codecs import Chunk, make_wire_format
from repro_torch.runtime.dispatch import DispatchPayload
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
    # downlink: None keeps the whole-model broadcast (raw f32 model bytes);
    # the version-tracked dispatch session is not ported yet
    dispatch_compression: Optional[str] = None
    dispatch_history: int = 8
    dispatch_chunk_elems: int = 1 << 16
    dispatch_multicast: bool = True
    dispatch_resync: float = 4.0
    dispatch_resync_mode: str = "norm"
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
    cohorts: str = "off"             # 'on' is not ported yet
    resync_batching: bool = False
    telemetry: bool = False
    telemetry_kernels: bool = False  # True is not ported yet
    monitor: str = "off"             # 'on' is not ported yet
    slo: Optional[str] = None
    monitor_byte_budget: Optional[int] = None
    # client-selection policy (runtime/scheduler.py): 'random' reproduces
    # the uniform draw RNG-call-for-RNG-call; 'stragglers_last' and
    # 'rate_staleness' rank eligible clients by predicted round time
    scheduler: str = "random"
    autotune: str = "off"            # 'cache' / 'sweep' are not ported yet
    seed: int = 0

    def hyper(self) -> SeaflHyper:
        beta = self.staleness_limit if self.staleness_limit is not None else 1e9
        return SeaflHyper(alpha=self.alpha, mu=self.mu, beta=float(beta),
                          theta=self.theta, use_importance=self.use_importance,
                          use_staleness=self.use_staleness)


def _refuse_unported(cfg: FLConfig) -> None:
    """Options that need a module this port does not carry yet."""
    unported = []
    if cfg.dispatch_compression is not None:
        unported.append(f"dispatch_compression={cfg.dispatch_compression!r}")
    if cfg.cohorts == "on":
        unported.append("cohorts='on'")
    if cfg.monitor == "on":
        unported.append("monitor='on'")
    if cfg.autotune != "off":
        unported.append(f"autotune={cfg.autotune!r}")
    if cfg.telemetry_kernels:
        unported.append("telemetry_kernels=True")
    if unported:
        raise NotImplementedError(
            "repro_torch does not port these options yet: "
            + ", ".join(unported))


@dataclass
class AggregationEvent:
    round: int
    weights: Optional[np.ndarray]
    staleness: Optional[np.ndarray]
    contributors: list[int]
    dispatch: list[int] = field(default_factory=list)
    notify: list[int] = field(default_factory=list)


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
        self.tel = (telemetry if telemetry is not None
                    else Telemetry(enabled=cfg.telemetry))
        # pluggable client-selection policy: built eagerly (bad names fail
        # at construction)
        self.scheduler = make_scheduler(cfg.scheduler, self.tel)
        self.wire = make_wire_format(cfg.compression, cfg.chunk_elems)
        _refuse_unported(cfg)
        # drift-adaptive rate policy: validated here so a bad band config
        # fails at construction, not mid-run.  Its dispatch consumer needs
        # top-k dispatch, which raises above until the dispatch session is
        # ported.
        self.rate_policy = RatePolicy.from_config(cfg)
        if cfg.dispatch_ratio_policy == "drift":
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
        self.buffer = UpdateBuffer(self._trigger_size(), self.packer.size,
                                   dtype=self._buffer_dtype,
                                   telemetry=self.tel, device=self.device)
        self._batcher = self._make_batcher()
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
        cfg = self.cfg
        if cfg.ingest_batch_chunks <= 0:
            return None
        return IngestBatcher(self.buffer, cfg.ingest_batch_chunks,
                             auto_bypass=cfg.ingest_auto_bypass,
                             telemetry=self.tel)

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
        self._history = {v: p for v, p in self._history.items() if v in live}
        self._unpack_cache = {v: p for v, p in self._unpack_cache.items()
                              if v in live}
        # chosen per-version ratios die with the versions they encode for
        self._ratio_by_version = {v: r for v, r in
                                  self._ratio_by_version.items()
                                  if v in self._history}

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
    def encode_dispatch(self, cid: int) -> DispatchPayload:
        """Serve the current global to ``cid``: the whole-model broadcast,
        a marker payload whose ``nbytes`` is the raw f32 model size."""
        target = self.active.get(cid, self.round)
        return DispatchPayload(
            cid=cid, target_version=target, base_version=None,
            scheme="raw", param_size=self.packer.size, chunks=None,
            nbytes=4 * self.packer.size,
            encode_cost_bytes=4 * self.packer.size)

    def dispatch_ratio(self, version: Optional[int] = None) -> Optional[float]:
        """Top-k dispatch ratio for the simulator's history (None: the
        broadcast is not top-k coded)."""
        return None

    def deliver_dispatch(self, cid: int, payload: DispatchPayload) -> None:
        """The last downlink chunk reached the client: account the bytes."""
        self.bytes_downloaded += payload.nbytes

    def dispatch_model(self, cid: int) -> Params:
        """The model ``cid`` holds (training-base boundary): the exact
        dispatch-version global."""
        return self.params_at(self.active[cid])

    # ------------------------------------------------------- uplink transport
    def encode_update(self, cid: int, client_params: Params,
                      n_epochs: int) -> UploadPayload:
        """Client-side encoder (simulated on the server object): pack once,
        then serialise to wire chunks per the configured WireFormat.  For
        delta-coded schemes (topk/int8) the delta is taken against the
        dispatch version and the client's flat error-feedback residual is
        folded in and updated."""
        version = self.active[cid]
        flat = self.packer.pack(client_params)
        wire = self.wire
        if wire.scheme == "topk":
            if self.cfg.uplink_ratio_policy == "drift":
                # the drift band chosen for the version this client trained
                # from also sizes its upload
                r = self._ratio_by_version.get(version)
                if r is not None:
                    wire = dc_replace(wire, topk_ratio=r)
            if n_epochs < self.cfg.local_epochs:
                # SEAFL² byte coupling: a notified partial-training client
                # did n' < E epochs of work, so it ships proportionally
                # fewer coefficients (decode is ratio-free: top-k chunks
                # carry their own indices)
                wire = dc_replace(
                    wire, topk_ratio=wire.topk_ratio
                    * max(1, n_epochs) / self.cfg.local_epochs)
        base = ef = None
        if wire.delta_coded:
            base = self._uplink_base(cid, version)
            ef = self._ef.setdefault(cid, FlatErrorFeedback())
        return transport_encode_update(cid, version, n_epochs, flat,
                                       wire, base, ef)

    def _uplink_base(self, cid: int, version: int) -> torch.Tensor:
        """The flat base a delta-coded upload is measured against: the
        dispatch-version global the client trained from.  (The reference
        measures against the delivered reconstruction under a lossy
        dispatch scheme; the port's dispatch is the exact broadcast.)"""
        return self._history[version]

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
        self.active.pop(cid, None)
        self.idle.add(cid)
        if (len(self.buffer) >= self.buffer.capacity
                and not self._blocked_by_stale()):
            return self._aggregate(recv_time)
        return None

    def ingest_payload(self, payload: UploadPayload,
                       recv_time: float = 0.0) -> Optional[AggregationEvent]:
        """Atomic ingest of a whole wire payload (the simulator's deliver
        event): the chunks are adjacent windows of one slot, so they land
        with one write (``IngestSession.write_all``)."""
        sess = self.begin_ingest(payload.cid, payload.version,
                                 payload.n_epochs, recv_time=recv_time)
        sess.write_all(payload.chunks)
        return self.finish_ingest(payload.cid, recv_time)

    def on_update(self, cid: int, client_params: Params, n_epochs: int,
                  recv_time: float = 0.0) -> Optional[AggregationEvent]:
        """Encode + ingest in one step (callers without an explicit wire)."""
        payload = self.encode_update(cid, client_params, n_epochs)
        return self.ingest_payload(payload, recv_time)

    # ----------------------------------------------------------- aggregate
    def _aggregate(self, now: float) -> AggregationEvent:
        """One server aggregation, entirely on the flat (K, P) engine.  The
        new global is a new tensor: ``_history`` still holds the old one."""
        cfg = self.cfg
        prev_flat = self._flat            # drift observation base
        updates = self.buffer.updates()
        staleness = np.asarray([self.round - u.version for u in updates],
                               np.float32)
        sizes = np.asarray([u.n_samples for u in updates], np.float32)
        stacked = self.buffer.stacked_flat()   # f32 or bf16 slots; kernels
        weights = None                         # accumulate in f32 either way

        with self.tel.span("server.aggregate", round=self.round,
                           k=len(updates), algorithm=cfg.algorithm):
            if cfg.algorithm == "fedavg":
                self._flat, w = fedavg_aggregate_flat(self._flat, stacked,
                                                      sizes)
                weights = w.cpu().numpy()
            elif cfg.algorithm == "fedasync":
                self._flat = fedasync_aggregate_flat(
                    self._flat, stacked[0], staleness[0],
                    cfg.fedasync_alpha0, cfg.fedasync_poly_a)
            elif cfg.algorithm == "fedbuff":
                # fedbuff_aggregate_flat yields w_t + eta*mean(w_k - w_t);
                # true FedBuff deltas are vs each client's dispatch version,
                # so add eta*(w_t - mean_k base_k) — a tiny combination over
                # the few distinct live versions, not another (K, P) pass.
                g, k = self._flat, float(len(updates))
                mixed, w = fedbuff_aggregate_flat(g, stacked,
                                                  cfg.fedbuff_eta_g)
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
                    use_staleness=h.use_staleness)
                weights = w.cpu().numpy()

        if self.tel.enabled:
            self.tel.counter("agg.count")
            self.tel.gauge("agg.buffer_fill", len(updates))
            self.tel.histogram_many("agg.staleness", staleness)
            if weights is not None:
                self.tel.histogram_many("agg.weight", weights)

        contributors = [u.client_id for u in updates]
        self.buffer.drain()
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
            "dispatch": None,            # no version-tracked dispatch yet
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
            # the metrics snapshot rides along only when telemetry is on
            **({"telemetry": self.tel.snapshot()}
               if self.tel.enabled else {}),
        }

    def checkpoint_trees(self) -> dict:
        """Tensors to persist: the flat model at each live version
        (``v{version}``), each client's error-feedback residual
        (``ef{cid}``; without them a restart under a delta-coded uplink
        resets error memory) and the committed buffer rows (``slot{i}``, in
        the buffer's dtype).  They are the live tensors, not copies: the
        Checkpointer copies them to the host before it returns."""
        trees = {f"v{v}": p for v, p in self._history.items()}
        for cid, ef in self._ef.items():
            if ef.residual is not None:
                trees[f"ef{cid}"] = ef.residual
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
        if state.get("dispatch") is not None:
            warnings.warn(
                "checkpoint carries dispatch version-tracking state but the "
                "restored config has dispatch_compression=None; dropping it "
                "(all clients will receive full legacy broadcasts)")
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
        if self.tel.enabled and "telemetry" in state:
            self.tel.load_snapshot(state["telemetry"])
