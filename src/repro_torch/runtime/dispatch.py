"""Downlink dispatch: version-tracked, delta-coded, multicast model broadcast.

The uplink transport (runtime/transport.py) made client->server payloads a
wire object; this module is its mirror for the server->client direction,
the JAX package's ``runtime/dispatch.py`` on torch tensors.  Chunk
encode/decode is the shared codec layer (:mod:`repro_torch.runtime.codecs`);
what lives here is the downlink protocol: per-client version tracking, the
bounded global-history ring, server-side error feedback, and the multicast
encode cache.

A :class:`DispatchSession` tracks, per client, the last global version the
client fully received, and serves each dispatch as chunked payloads:

  f32   -- raw f32 chunks of the current global.  The client ends up
           holding exactly the server's (P,) global.
  bf16  -- raw bf16 chunks of the current global (2 B/elem): every dispatch
           is a fresh, base-free half-size snapshot.
  topk  -- per-chunk top-k of the *delta* ``global - ring[held_version]``
           (8 B per kept elem), with server-side error feedback so the
           client's reconstruction tracks the global across rounds.
  int8  -- per-chunk symmetric int8 quantisation of the same delta.

Delta-coded schemes need a shared base: the server keeps a bounded ring of
flat (P,) global-history tensors (``FLConfig.dispatch_history`` versions,
retained through ``SeaflServer._history``).  A returning client whose held
version is still in the ring receives a delta; a fresh client, a crashed
client, or one whose version aged out of the ring receives a **full
snapshot** as raw f32 chunks (exact, and it resets the error-feedback
residual).

Adaptive ratio: ``encode(..., ratio=...)`` overrides the static top-k
ratio for this dispatch -- the drift-band rate policy
(:mod:`repro_torch.runtime.policy`) chooses one ratio per *target* version,
so every client on the same hop still shares one cached encode and the
payload records the ratio it actually shipped at.

Multicast encode cache
----------------------

In multicast mode (the default) a delta hit encodes the **pure ring hop**
``ring[target] - ring[base]`` -- no per-client state enters the wire --
exactly once per ``(base_version, target_version, scheme, ratio,
chunk_elems)``; every other client on the same hop fans out the cached
chunks byte-identically.  Cache entries die with the ring (aging evicts any
entry whose base or target left the retained window) and are never
checkpointed: a restored session starts cold and re-encodes, byte-
identically, since the ring, residuals and chosen ratios are restored.

Error feedback under shared payloads: the per-client residual keeps its
invariant -- the client holds ``ring[version] - residual`` -- but delivery
*accumulates* the shared encode error: ``r' = r + (hop_delta - decoded)``.
A client whose residual outgrows the hop is **resynced** with a
personalized fold-in encode -- the classic EF payload ``delta + r``, same
wire bytes, cache-bypassed.  The trigger is ``policy.needs_resync``:
norm-threshold by default (``|r| > resync * |delta|``), or the byte-budget
projection (``resync_mode='bytes'``).  ``multicast=False`` gives per-client
fold-in on every delta.  Both modes keep the same ``held_flat`` algebra, so
checkpoints are interchangeable across them.

The residual commits only at *delivery* (``deliver``): a payload that dies
on the wire (client crash inside the dispatch window) leaves no trace, the
client's tracking state is dropped, and its next dispatch is a full
snapshot.

Norms: the resync test and the cached hop norm are ``float`` of an f32
``torch.linalg.norm``, which sums in another order than XLA's, so a value
may differ from the reference's in the last ulps; a decision flips only at
a margin that small (``tests/test_torch_dispatch.py`` reports the margins
it saw).

A residual may be a DTensor: the cohort table (runtime/cohorts.py) shards
its residuals' elements over 'pod' on such a mesh.  Its norm is the whole
vector's (each rank's shard's, reduced across 'pod'), and where the wire
encodes it (the fold-in) or the held model is rebuilt (``held_flat``) it
is gathered whole once.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.runtime.codecs import (
    CHUNK_HEADER_BYTES, Chunk, WireFormat, decode_concat, encode_error,
    encode_flat, encode_flat_batch,
)
from repro_torch.runtime.policy import needs_resync
from repro_torch.runtime.telemetry import Telemetry, of as _tel_of
from repro_torch.sharding import whole

__all__ = [
    "DispatchPayload",
    "DispatchSession",
    "apply_dispatch",
]


def _norm(x: torch.Tensor) -> float:
    """The f32 L2 norm as a host float (one device sync); of a DTensor,
    the whole vector's (a shard's norm alone is a partial value)."""
    n = torch.linalg.norm(x)
    return float(n.full_tensor() if isinstance(n, DTensor) else n)


@dataclass
class DispatchPayload:
    """One server->client model transfer as it travels on the wire.

    ``base_version is None`` marks a full snapshot (raw chunks of the
    global); otherwise the chunks carry a delta against that ring version.
    ``scheme == 'raw'`` is the legacy broadcast marker: no wire object at
    all, just the f32 model size for the bandwidth model (the
    ``dispatch_compression=None`` path).  ``chunks is None`` on a non-legacy
    payload means the encoder skipped materialisation
    (``DispatchSession.encode(materialize=False)``): the content is exactly
    a ring entry, only ``nbytes`` is meaningful.

    ``residual`` is server-side bookkeeping, not wire payload.  On a
    personalized (``shared=False``) delta it is the absolute error-feedback
    carry that *replaces* the client's tracked residual at delivery; on a
    multicast (``shared=True``) delta it is the shared encode error of the
    pure ring hop, *added to* the client's residual at delivery.

    ``ratio`` is the top-k ratio this payload shipped at (None for non-topk
    schemes and full snapshots).  ``encode_cost_bytes`` is the f32 source
    bytes this encode processed server-side: 4*P for a fresh encode, 0 for
    a cache hit (the simulator's encode-time model prices it).  ``hop``
    identifies the encode instance the content came from (the multicast
    cache key, the fold key, None for full snapshots), so the cohort layer
    can memoize per-delivery mismatch norms.  ``batched=True`` marks a fold
    payload from an ``encode_many`` coalesced pass (its source cost is
    returned once by that call).
    """
    cid: int
    target_version: int
    base_version: Optional[int]
    scheme: str
    param_size: int
    chunks: Optional[list[Chunk]]
    nbytes: int
    residual: Optional[torch.Tensor] = None
    shared: bool = False
    resync: bool = False
    ratio: Optional[float] = None
    encode_cost_bytes: int = 0
    hop: Optional[tuple] = None
    batched: bool = False

    @property
    def full(self) -> bool:
        return self.base_version is None


def apply_dispatch(payload: DispatchPayload, fmt: WireFormat,
                   held_flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Client-side reconstruction, literally from the wire chunks.

    Full payloads overwrite; delta payloads add onto ``held_flat`` (the flat
    model the client kept from its last dispatch).  Returns the client's new
    flat (P,) model."""
    if payload.chunks is None:
        raise ValueError("payload carries no wire chunks (legacy broadcast "
                         "marker, or encoded with materialize=False)")
    if payload.full:
        # delta schemes send full snapshots as exact raw f32
        full_fmt = fmt if not fmt.delta_coded else replace(fmt, scheme="f32")
        return decode_concat(payload.chunks, full_fmt)
    if held_flat is None:
        raise ValueError("delta dispatch payload needs the held base model")
    if payload.ratio is not None and fmt.scheme == "topk":
        fmt = replace(fmt, topk_ratio=payload.ratio)
    return held_flat + decode_concat(payload.chunks, fmt)


class DispatchSession:
    """Server-side downlink encoder with per-client version tracking.

    One session serves the whole fleet; per-client state is the held
    version (``versions``) plus, for delta-coded schemes, the error-feedback
    residual (``residuals``).  ``encode`` is pure with respect to that state
    -- tracking commits in ``deliver`` so an undelivered payload costs
    nothing and ``drop`` forces a full-snapshot re-request.

    ``multicast`` enables the shared-hop encode semantics and the bounded
    encode cache; ``use_cache=False`` keeps the multicast semantics but
    re-encodes every payload (a knob showing the cache is a pure
    amortisation).  ``resync_mode`` selects the fold-in trigger ('norm' |
    'bytes', runtime/policy.py).
    """

    def __init__(self, fmt: WireFormat, history: int,
                 multicast: bool = True, resync: float = 4.0,
                 use_cache: bool = True, resync_mode: str = "norm",
                 telemetry: Optional[Telemetry] = None):
        self.tel = _tel_of(telemetry)
        self.fmt = fmt
        self.history = max(1, int(history))
        self.multicast = bool(multicast)
        self.resync = float(resync)
        self.resync_mode = str(resync_mode)
        self.use_cache = bool(use_cache)
        self.versions: dict[int, int] = {}       # cid -> held global version
        self.residuals: dict[int, torch.Tensor] = {}   # delta schemes only
        self.full_dispatches = 0
        self.delta_dispatches = 0
        self.resync_dispatches = 0
        # (base, target, scheme, ratio, chunk_elems) ->
        #     (chunks, shared_err, nbytes, hop_norm); bounded by ring aging,
        # never checkpointed
        self._cache: dict[tuple, tuple] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    def _cache_hit(self) -> None:
        self.cache_hits += 1
        self.tel.counter("dispatch.cache_hit")

    def _cache_miss(self) -> None:
        self.cache_misses += 1
        self.tel.counter("dispatch.cache_miss")

    # ------------------------------------------------------ tracking hooks
    # Per-client tracking state is reached only through these accessors, so
    # a subclass can swap the O(clients) residual dict for cohort-shared
    # state (runtime/cohorts.py CohortDispatchSession) without touching the
    # wire protocol above them.

    def held_version(self, cid: int) -> Optional[int]:
        """The last global version ``cid`` fully received (None if
        untracked)."""
        return self.versions.get(cid)

    def tracks(self, cid: int) -> bool:
        return cid in self.versions

    def _residual_of(self, cid: int) -> Optional[torch.Tensor]:
        """The error-feedback residual backing ``held_flat`` for ``cid``."""
        return self.residuals.get(cid)

    # ---------------------------------------------------------------- wire
    def ring_versions(self, current: int) -> set[int]:
        """Versions the bounded ring retains at global version ``current``."""
        return {current - i for i in range(self.history) if current - i >= 0}

    def age_cache(self, current: int) -> None:
        """Ring aging: evict every cache entry whose base or target version
        left the retained window."""
        if not self._cache:
            return
        live = self.ring_versions(current)
        self._cache = {
            k: v for k, v in self._cache.items()
            if (k[0] is None or k[0] in live) and k[1] in live
        }

    def invalidate_cache(self) -> None:
        """Drop every cached encode (checkpoint restore starts cold)."""
        self._cache = {}

    def _cache_key(self, base: Optional[int], target: int,
                   fmt: Optional[WireFormat] = None) -> tuple:
        f = fmt if fmt is not None else self.fmt
        return (base, target, f.scheme, f.topk_ratio, f.chunk_elems)

    def _fmt_for(self, ratio: Optional[float]) -> WireFormat:
        """The wire format this dispatch encodes at: the session format,
        with the rate policy's chosen top-k ratio swapped in (only top-k is
        ratio-shaped)."""
        if ratio is None or self.fmt.scheme != "topk" \
                or float(ratio) == self.fmt.topk_ratio:
            return self.fmt
        return replace(self.fmt, topk_ratio=float(ratio))

    def encode(self, cid: int, target: int,
               ring: dict[int, torch.Tensor],
               materialize: bool = True,
               ratio: Optional[float] = None,
               _folds: Optional[list] = None) -> Optional[DispatchPayload]:
        """Encode one dispatch of global version ``target`` to ``cid``.

        ``ring`` maps version -> flat (P,) global (the server's
        ``_history``).  ``ratio`` (drift-band rate policy) overrides the
        static top-k ratio; the cache key carries it.  Does not mutate
        tracking state (the cache and its counters are amortisation
        bookkeeping, not protocol state).

        ``materialize=False`` skips building the wire chunks of *full*
        payloads (their byte size has a closed form and their content is a
        ring entry), which is all the simulator needs.  Lazy fulls still go
        through the cache in multicast mode (a chunk-less sentinel entry; a
        later materialized request upgrades it).  Delta payloads always
        materialize: the residual is defined by what the wire delivers.

        ``_folds`` (internal, see :meth:`encode_many`): a personalized
        fold-in encode is deferred -- appended to the list, and ``encode``
        returns None; every other outcome returns its payload.
        """
        g = ring[target]
        fmt = self._fmt_for(ratio)
        wire_ratio = fmt.topk_ratio if fmt.scheme == "topk" else None
        held = self.held_version(cid)
        usable = (held is not None and held in ring
                  and held in self.ring_versions(target))
        if fmt.delta_coded and usable:
            r = self._residual_of(cid)
            p = int(g.shape[0])
            delta = None
            if self.multicast:
                key = self._cache_key(held, target, fmt)
                self.age_cache(target)
                ent = self._cache.get(key) if self.use_cache else None
                # resync decision: a cache hit never materialises the delta,
                # its norm rides in the cache entry
                if r is None:
                    resync_now = False
                elif self.resync <= 0.0:
                    resync_now = True
                else:
                    if ent is not None:
                        dnorm = ent[3]
                    else:
                        delta = g - ring[held]
                        dnorm = _norm(delta)
                    resync_now = needs_resync(
                        self.resync_mode, r_norm=_norm(r), hop_norm=dnorm,
                        threshold=self.resync, fmt=fmt, param_size=p)
                if not resync_now:
                    if ent is not None:
                        self._cache_hit()
                        chunks, err, nbytes, _ = ent
                        cost = 0
                    else:
                        if delta is None:
                            delta = g - ring[held]
                        chunks = encode_flat(delta, fmt)
                        err = encode_error(delta, chunks, fmt)
                        nbytes = sum(c.nbytes for c in chunks)
                        if self.use_cache:
                            self._cache[key] = (chunks, err, nbytes,
                                                _norm(delta) if p else 0.0)
                        self._cache_miss()
                        cost = 4 * p
                    return DispatchPayload(
                        cid=cid, target_version=target, base_version=held,
                        scheme=fmt.scheme, param_size=p, chunks=chunks,
                        nbytes=nbytes, residual=err, shared=True,
                        ratio=wire_ratio, encode_cost_bytes=cost, hop=key)
            # personalized fold-in encode: multicast off, or this client's
            # residual tripped the resync threshold
            return self._encode_personalized(cid, target, held, fmt, g, ring,
                                             delta, r, wire_ratio, _folds)
        # full snapshot: raw schemes ship themselves; delta schemes fall
        # back to exact raw f32 (a client with no base)
        full_fmt = fmt if not fmt.delta_coded else replace(fmt, scheme="f32")
        p = int(g.shape[0])
        closed_form = (full_fmt.payload_bytes(p) if p
                       else CHUNK_HEADER_BYTES)
        if self.multicast:
            key = self._cache_key(None, target, full_fmt)
            self.age_cache(target)
            ent = self._cache.get(key) if self.use_cache else None
            # a sentinel (chunk-less) entry satisfies lazy requests; a
            # materialized request needs real chunks and upgrades it
            if ent is not None and (not materialize or ent[0] is not None):
                self._cache_hit()
                return DispatchPayload(
                    cid=cid, target_version=target, base_version=None,
                    scheme=full_fmt.scheme, param_size=p,
                    chunks=(ent[0] if materialize else None),
                    nbytes=ent[2], shared=True, encode_cost_bytes=0)
            chunks = encode_flat(g, full_fmt) if materialize else None
            nbytes = (sum(c.nbytes for c in chunks) if chunks is not None
                      else closed_form)
            if self.use_cache:
                self._cache[key] = (chunks, None, nbytes, None)
            self._cache_miss()
            return DispatchPayload(
                cid=cid, target_version=target, base_version=None,
                scheme=full_fmt.scheme, param_size=p, chunks=chunks,
                nbytes=nbytes, shared=True, encode_cost_bytes=4 * p)
        chunks = encode_flat(g, full_fmt) if materialize else None
        return DispatchPayload(
            cid=cid, target_version=target, base_version=None,
            scheme=full_fmt.scheme, param_size=p, chunks=chunks,
            nbytes=(sum(c.nbytes for c in chunks) if chunks is not None
                    else closed_form),
            encode_cost_bytes=4 * p)

    # ----------------------------------------------------- personalized fold
    def _fold_key(self, cid: int, held: int, target: int,
                  fmt: WireFormat) -> tuple:
        """Identity of one personalized fold-in encode's content: per
        client here (the folded vec carries the client's own residual);
        cohort sessions key on the shared cohort residual instead."""
        return (cid, held, target, fmt.scheme, fmt.topk_ratio,
                fmt.chunk_elems)

    def _fold_encoded(self, fold_key: tuple, chunks: list[Chunk],
                      err: Optional[torch.Tensor], nbytes: int) -> None:
        """Hook: a fold encode materialized (inline or batched).  The base
        session memoizes nothing; cohort sessions cache per cohort."""

    def _encode_personalized(self, cid: int, target: int, held: int,
                             fmt: WireFormat, g: torch.Tensor,
                             ring: dict[int, torch.Tensor],
                             delta: Optional[torch.Tensor],
                             r: Optional[torch.Tensor],
                             wire_ratio: Optional[float],
                             folds: Optional[list] = None
                             ) -> Optional[DispatchPayload]:
        """The classic EF payload ``delta + r``: cache-bypassed, re-ships
        the accumulated residual.  With ``folds`` given, the request is
        deferred for ``encode_many``'s batched pass (returns None)."""
        p = int(g.shape[0])
        if delta is None:
            delta = g - ring[held]
        vec = delta if r is None else delta + whole(r)
        resync = (self.multicast and r is not None)
        fk = self._fold_key(cid, held, target, fmt)
        if folds is not None:
            folds.append((cid, target, held, fmt, vec, wire_ratio, resync,
                          fk))
            return None
        chunks = encode_flat(vec, fmt)
        err = encode_error(vec, chunks, fmt)
        nbytes = sum(c.nbytes for c in chunks)
        self._fold_encoded(fk, chunks, err, nbytes)
        return DispatchPayload(
            cid=cid, target_version=target, base_version=held,
            scheme=fmt.scheme, param_size=p, chunks=chunks, nbytes=nbytes,
            residual=err, shared=False, resync=resync,
            ratio=wire_ratio, encode_cost_bytes=4 * p, hop=("fold",) + fk)

    def encode_many(self, reqs: list[tuple], ring: dict[int, torch.Tensor],
                    materialize: bool = True
                    ) -> tuple[list[DispatchPayload], int]:
        """Encode one aggregation round's dispatch fan-out, coalescing all
        personalized resync re-encodes into one batched encode pass per
        wire format (``codecs.encode_flat_batch``).

        ``reqs`` is a list of ``(cid, target, ratio)`` triples; returns
        ``(payloads, fold_cost_bytes)`` with ``payloads`` aligned to
        ``reqs``, each byte-identical to a sequential ``encode`` call.
        Batched fold payloads carry ``batched=True`` and
        ``encode_cost_bytes=0``: the batch's source cost comes back once
        as ``fold_cost_bytes`` (4*P per wire-format group).  Fold requests
        with identical fold keys (cohort members sharing one residual)
        encode one stacked row.
        """
        payloads: list[Optional[DispatchPayload]] = []
        folds: list[tuple] = []
        slots: list[int] = []            # payload index per deferred fold
        for cid, target, ratio in reqs:
            p = self.encode(cid, target, ring, materialize=materialize,
                            ratio=ratio, _folds=folds)
            if p is None:
                slots.append(len(payloads))
            payloads.append(p)
        fold_cost = 0
        if folds:
            groups: dict[tuple, list[int]] = {}
            for j, f in enumerate(folds):
                fmt = f[3]
                groups.setdefault(
                    (fmt.scheme, fmt.topk_ratio, fmt.chunk_elems),
                    []).append(j)
            for idx in groups.values():
                fmt = folds[idx[0]][3]
                rows: list[torch.Tensor] = []
                row_of: dict[tuple, int] = {}
                for j in idx:
                    fk = folds[j][7]
                    if fk not in row_of:
                        row_of[fk] = len(rows)
                        rows.append(folds[j][4])
                chunk_lists = encode_flat_batch(rows, fmt)
                fold_cost += 4 * int(rows[0].shape[0])
                errs: dict[tuple, Optional[torch.Tensor]] = {}
                for j in idx:
                    cid, target, held, fmt_j, vec, wire_ratio, resync, fk \
                        = folds[j]
                    chunks = chunk_lists[row_of[fk]]
                    if fk not in errs:
                        errs[fk] = encode_error(vec, chunks, fmt_j)
                        self._fold_encoded(fk, chunks, errs[fk],
                                           sum(c.nbytes for c in chunks))
                    payloads[slots[j]] = DispatchPayload(
                        cid=cid, target_version=target, base_version=held,
                        scheme=fmt_j.scheme, param_size=int(vec.shape[0]),
                        chunks=chunks,
                        nbytes=sum(c.nbytes for c in chunks),
                        residual=errs[fk], shared=False, resync=resync,
                        ratio=wire_ratio, encode_cost_bytes=0,
                        hop=("fold",) + fk, batched=True)
        return payloads, fold_cost

    # ------------------------------------------------------------- tracking
    def deliver(self, payload: DispatchPayload) -> None:
        """The last wire chunk reached the client: commit version tracking,
        the error-feedback residual this payload implies, and the
        full/delta counters (payloads that die on the wire count nothing)."""
        if payload.full:
            self.full_dispatches += 1
            self.tel.counter("dispatch.full")
        else:
            self.delta_dispatches += 1
            self.tel.counter("dispatch.delta")
            if payload.resync:
                self.resync_dispatches += 1
                self.tel.counter("dispatch.resync")
        self.tel.histogram("dispatch.payload_bytes", payload.nbytes)
        self._commit_tracking(payload)

    def _commit_tracking(self, payload: DispatchPayload) -> None:
        """Commit the version + residual state a delivery implies (the
        tracking half of :meth:`deliver`, overridden by cohort sessions)."""
        cid = payload.cid
        self.versions[cid] = payload.target_version
        if payload.full or payload.residual is None:
            # full snapshots reset error memory
            self.residuals.pop(cid, None)
        elif payload.shared:
            # multicast hop: the shared encode error joins this client's
            # accumulated residual (held' = ring[target] - r')
            r = self.residuals.get(cid)
            self.residuals[cid] = payload.residual if r is None \
                else r + payload.residual
        else:
            self.residuals[cid] = payload.residual

    def drop(self, cid: int) -> None:
        """Forget a client's tracking state (crash / lost device): its next
        dispatch re-requests a full snapshot."""
        self.versions.pop(cid, None)
        self.residuals.pop(cid, None)

    def held_flat(self, cid: int,
                  ring: dict[int, torch.Tensor]) -> torch.Tensor:
        """The flat model the client currently holds: the ring version
        exactly under f32, its bf16 rounding under bf16, and
        ``ring[version] - residual`` under the delta schemes."""
        v = self.versions[cid]
        g = ring[v]
        if self.fmt.scheme == "bf16":
            return g.to(torch.bfloat16).to(torch.float32)
        r = self._residual_of(cid)
        return g if r is None else g - whole(r)

    # ----------------------------------------------------------- telemetry
    def cache_info(self) -> dict:
        """Encode-cache amortisation stats."""
        lookups = self.cache_hits + self.cache_misses
        return {
            "hits": int(self.cache_hits),
            "misses": int(self.cache_misses),
            "hit_rate": (self.cache_hits / lookups) if lookups else 0.0,
            "entries": len(self._cache),
            "resyncs": int(self.resync_dispatches),
        }

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        # the ring depth is not persisted (restoring under another
        # dispatch_history only turns out-of-ring holders into full
        # snapshots), nor is the encode cache (a restored session
        # re-encodes byte-identically)
        return {
            "scheme": self.fmt.scheme,
            "versions": {str(c): int(v) for c, v in self.versions.items()},
            "full_dispatches": int(self.full_dispatches),
            "delta_dispatches": int(self.delta_dispatches),
            "resync_dispatches": int(self.resync_dispatches),
            "cache_hits": int(self.cache_hits),
            "cache_misses": int(self.cache_misses),
        }

    def residual_trees(self) -> dict:
        """Tensors to persist: the per-client dispatch residuals."""
        return {f"dr{cid}": r for cid, r in self.residuals.items()}

    def load_state(self, state: dict, trees: dict, device=None) -> None:
        """Restore from :meth:`state_dict` / :meth:`residual_trees` as
        either package wrote them; residuals land on ``device`` (by default
        where they are)."""
        self.versions = {int(c): int(v)
                         for c, v in state.get("versions", {}).items()}
        self.full_dispatches = int(state.get("full_dispatches", 0))
        self.delta_dispatches = int(state.get("delta_dispatches", 0))
        self.resync_dispatches = int(state.get("resync_dispatches", 0))
        self.cache_hits = int(state.get("cache_hits", 0))
        self.cache_misses = int(state.get("cache_misses", 0))
        self.residuals = {
            int(k[2:]): _as_f32(v, device)
            for k, v in trees.items() if k.startswith("dr")
        }
        self.invalidate_cache()


def _as_f32(x, device=None) -> torch.Tensor:
    """A checkpoint array (numpy or tensor) as an f32 tensor on ``device``
    (an array is copied: it may be read-only)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32)
