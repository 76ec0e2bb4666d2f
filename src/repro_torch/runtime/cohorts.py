"""Cohorted fleet state: O(cohorts) server memory for O(clients) fleets.

The per-client dispatch layer (runtime/dispatch.py) keeps one full (P,)
error-feedback residual and one dict entry per client.  SEAFL's
semi-asynchronous rounds make most clients move through the *same* hops,
so that state is highly redundant.  This module (the JAX package's
``runtime/cohorts.py`` on torch tensors) makes the *cohort* the unit of
server-side fleet state:

  cohort key = (held version, drift band, kind)

where the drift band is the top-k ratio the delivering dispatch shipped at,
and ``kind`` separates residual-free holders (``'x'``: full snapshots, raw
schemes) from residual-carrying delta holders (``'d'``).

:class:`CohortTable` stores **one** shared (P,) EF residual per cohort
(write-once: the first member to arrive on a hop defines it).  A member
that joins a cohort whose stored residual differs from its own implied one
accrues a scalar *mismatch bound* ``|implied - stored|`` instead of a (P,)
tensor; that norm is memoized per (hop, src, dst).  When a member's
accumulated mismatch outgrows the hop delta (the ``dispatch_resync``
economics), its tracking is dropped, it gets one exact full snapshot and
re-enters a fresh cohort with zero mismatch.

:class:`CohortDispatchSession` plugs the table into the dispatch protocol
through the tracking hooks (``held_version`` / ``_residual_of`` /
``_commit_tracking``); the wire protocol, ring, multicast cache and resync
triggers above them are the base class's, which keeps ``cohorts='off'``
bit for bit.  It also caches personalized fold-in encodes per cohort.

The edge-aggregation tier that pre-combines a cohort's uploads into one
(K, P) buffer slot lives in ``core/server.py`` (``_edge_absorb``).

A shared residual is placed as the reference places it
(``sharding.shard_cohort_state``, where a cohort is born and at a
restore): its elements over 'pod' on such a mesh.  The arithmetic that
reads it takes either: the join penalty's norms reduce across 'pod'
(``dispatch._norm``), a residual's sum with a payload's plain error stays
placed (``sharding.placed_as``), and the checkpoint's trees, the wire's
fold-in and the held model gather it whole.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.runtime.codecs import Chunk, WireFormat
from repro_torch.runtime.dispatch import (
    DispatchPayload, DispatchSession, _as_f32, _norm,
)
from repro_torch.runtime.policy import needs_resync
from repro_torch.runtime.telemetry import Telemetry, of as _tel_of
from repro_torch.sharding import placed_as, shard_cohort_state, whole

__all__ = [
    "CohortTable",
    "CohortDispatchSession",
    "shard_cohort_state",
]

# cohort-key kinds: exact holders (no residual) vs delta holders
KIND_EXACT = "x"
KIND_DELTA = "d"


class CohortTable:
    """Fleet membership + shared per-cohort dispatch residuals.

    State:
      ``member``    cid -> cohort key (version, band, kind): O(clients)
                    scalars, never (P,) tensors;
      ``mismatch``  cid -> scalar bound on |true residual - cohort
                    residual| (only clients that ever diverged appear);
      ``_residual`` cohort key -> one shared (P,) EF residual (delta
                    cohorts only; write-once per cohort generation);
      ``_gen``      cohort key -> generation counter, bumped each time a
                    cohort (re)defines its residual, so memoized mismatch
                    norms and cached fold encodes never alias a dead
                    cohort's residual with a later one under the same key.
    """

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.tel = _tel_of(telemetry)
        self.member: dict[int, tuple] = {}
        self.mismatch: dict[int, float] = {}
        self._residual: dict[tuple, torch.Tensor] = {}
        self._count: dict[tuple, int] = {}
        self._gen: dict[tuple, int] = {}
        # (hop, src, src_gen, dst, dst_gen) -> |implied - stored|
        self._memo: dict[tuple, float] = {}
        self.cohort_births = 0
        self.residual_writes = 0
        self.memo_hits = 0
        self.memo_misses = 0

    # ------------------------------------------------------------- queries
    def key_of(self, cid: int) -> Optional[tuple]:
        return self.member.get(cid)

    def gen_of(self, key: Optional[tuple]) -> int:
        return self._gen.get(key, 0)

    def residual_vec(self, key: Optional[tuple]) -> Optional[torch.Tensor]:
        return self._residual.get(key) if key is not None else None

    def mismatch_of(self, cid: int) -> float:
        return self.mismatch.get(cid, 0.0)

    def n_cohorts(self) -> int:
        return len(self._count)

    def n_members(self) -> int:
        return len(self.member)

    def resident_bytes(self) -> int:
        """Device bytes of the shared (P,) residuals, on every pod together:
        the state that must stay O(cohorts), not O(clients)."""
        return sum(int(v.numel()) * 4 for v in self._residual.values())

    # ------------------------------------------------------------ movement
    def move(self, cid: int, dst: tuple,
             implied: Optional[Callable[[], Optional[torch.Tensor]]] = None,
             hop: Optional[tuple] = None, reset: bool = False) -> None:
        """Deliver-time transition of ``cid`` into cohort ``dst``.

        ``implied`` lazily builds the (P,) residual this delivery implies
        for the client (None for exact deliveries); it runs only when the
        destination cohort is born or a join penalty must be computed (a
        memo miss).  ``reset`` clears the client's mismatch first (full
        snapshots reset error memory exactly).
        """
        src = self.member.get(cid)
        if reset:
            self.mismatch.pop(cid, None)
        if self._count.get(dst, 0) == 0:
            # cohort birth: the first member's implied residual defines the
            # shared one
            vec = implied() if implied is not None else None
            if vec is not None:
                self._residual[dst] = shard_cohort_state(vec)
                self._gen[dst] = self._gen.get(dst, 0) + 1
                self.residual_writes += 1
            self.cohort_births += 1
            self.tel.counter("cohort.births")
        elif implied is not None:
            # joining a live cohort: the member inherits the stored
            # residual; the gap to its own implied one becomes a scalar
            pen = self._join_penalty(hop, src, dst, implied)
            if pen > 0.0:
                self.mismatch[cid] = self.mismatch.get(cid, 0.0) + pen
                self.tel.histogram("cohort.mismatch_bound",
                                   self.mismatch[cid])
        if src != dst:
            self._count[dst] = self._count.get(dst, 0) + 1
            self.member[cid] = dst
            if src is not None:
                self._leave(src)

    def _join_penalty(self, hop: Optional[tuple], src: Optional[tuple],
                      dst: tuple,
                      implied: Callable[[], Optional[torch.Tensor]]) -> float:
        mk = (hop, src, self.gen_of(src), dst, self.gen_of(dst))
        pen = self._memo.get(mk) if hop is not None else None
        if pen is not None:
            self.memo_hits += 1
            return pen
        stored = self._residual.get(dst)
        vec = placed_as(implied(), stored)
        if vec is None and stored is None:
            pen = 0.0
        elif vec is None:
            pen = _norm(stored)
        elif stored is None:
            pen = _norm(vec)
        else:
            pen = _norm(vec - stored)
        if hop is not None:
            self._memo[mk] = pen
            self.memo_misses += 1
        return pen

    def _leave(self, key: tuple) -> None:
        n = self._count.get(key, 1) - 1
        if n <= 0:
            # last member out: the shared residual dies with the cohort
            # (the generation counter survives)
            self._count.pop(key, None)
            self._residual.pop(key, None)
        else:
            self._count[key] = n

    def remove(self, cid: int) -> None:
        """Forget a client entirely (crash / tracking drop)."""
        key = self.member.pop(cid, None)
        self.mismatch.pop(cid, None)
        if key is not None:
            self._leave(key)

    def prune(self, live: set[int]) -> None:
        """Ring aging: drop memo/gen entries whose versions left the
        retained window (versions are monotone, so those keys never
        recur)."""
        if self._memo:
            self._memo = {
                k: v for k, v in self._memo.items()
                if (k[1] is None or k[1][0] in live) and k[3][0] in live
            }
        if self._gen:
            self._gen = {k: g for k, g in self._gen.items()
                         if k[0] in live or k in self._count}

    # ----------------------------------------------------------- telemetry
    def stats(self) -> dict:
        return {
            "cohorts": self.n_cohorts(),
            "members": self.n_members(),
            "residual_cohorts": len(self._residual),
            "resident_bytes": self.resident_bytes(),
            "cohort_births": int(self.cohort_births),
            "residual_writes": int(self.residual_writes),
            "mismatched_members": len(self.mismatch),
        }

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        # cohort keys are (int version, float-or-None band, str kind): JSON
        # round-trips each exactly.  res_keys aligns with the cr{i} tensors
        # of residual_trees (same dict iteration).
        return {
            "member": {str(c): list(k) for c, k in self.member.items()},
            "mismatch": {str(c): float(m)
                         for c, m in self.mismatch.items()},
            "counts": [[list(k), int(n)] for k, n in self._count.items()],
            "gen": [[list(k), int(g)] for k, g in self._gen.items()],
            "res_keys": [list(k) for k in self._residual],
        }

    def residual_trees(self) -> dict:
        """The residuals whole, in ``state_dict``'s ``res_keys`` order (a
        pod-sharded one gathered: every rank calls this)."""
        return {f"cr{i}": whole(v)
                for i, v in enumerate(self._residual.values())}

    def load_state(self, state: dict, trees: dict, device=None) -> None:
        def kt(lst) -> tuple:
            return (int(lst[0]),
                    None if lst[1] is None else float(lst[1]),
                    str(lst[2]))

        self.member = {int(c): kt(k)
                       for c, k in state.get("member", {}).items()}
        self.mismatch = {int(c): float(m)
                         for c, m in state.get("mismatch", {}).items()}
        self._count = {kt(k): int(n) for k, n in state.get("counts", [])}
        self._gen = {kt(k): int(g) for k, g in state.get("gen", [])}
        self._residual = {}
        for i, k in enumerate(state.get("res_keys", [])):
            self._residual[kt(k)] = shard_cohort_state(
                _as_f32(trees[f"cr{i}"], device))
        self._memo = {}


class CohortDispatchSession(DispatchSession):
    """Dispatch session whose per-client (P,) state is cohort-shared.

    Overrides the tracking hooks (plus the fold-encode cache); the encode
    protocol, multicast cache, ring aging and resync economics are the base
    class's.  ``versions`` stays a per-client dict (one int per client);
    what collapses to O(cohorts) is the (P,) residual state and the fold
    encodes.
    """

    def __init__(self, fmt: WireFormat, history: int,
                 table: Optional[CohortTable] = None, **kw):
        super().__init__(fmt, history, **kw)
        self.table = (table if table is not None
                      else CohortTable(telemetry=self.tel))
        # (src key, src gen, target, scheme, ratio, chunk_elems) ->
        #     (chunks, err, nbytes): one fold encode serves every cohort
        # member on the hop
        self._fold_cache: dict[tuple, tuple] = {}
        self.fold_hits = 0
        self.fold_misses = 0
        self.mismatch_resyncs = 0

    # ------------------------------------------------------ tracking hooks
    def _residual_of(self, cid: int) -> Optional[torch.Tensor]:
        return self.table.residual_vec(self.table.key_of(cid))

    def _commit_tracking(self, payload: DispatchPayload) -> None:
        cid = payload.cid
        src = self.table.key_of(cid)
        self.versions[cid] = payload.target_version
        if payload.full or payload.residual is None:
            # exact delivery: residual-free cohort, mismatch resets
            self.table.move(
                cid, (payload.target_version, payload.ratio, KIND_EXACT),
                implied=None, hop=payload.hop, reset=True)
            self.tel.gauge("cohort.count", self.table.n_cohorts())
            self.tel.gauge("cohort.members", self.table.n_members())
            return
        dst = (payload.target_version, payload.ratio, KIND_DELTA)
        if payload.shared:
            # multicast hop: implied residual = own residual + shared err
            # (the err, whole on every rank, in the residual's placement)
            def implied():
                r = self.table.residual_vec(src)
                return payload.residual if r is None \
                    else r + placed_as(payload.residual, r)
        else:
            # personalized fold: the payload's err *replaces* the residual
            def implied():
                return payload.residual
        self.table.move(cid, dst, implied=implied, hop=payload.hop)
        self.tel.gauge("cohort.count", self.table.n_cohorts())
        self.tel.gauge("cohort.members", self.table.n_members())

    def drop(self, cid: int) -> None:
        super().drop(cid)
        self.table.remove(cid)

    # ------------------------------------------------------------- encode
    def encode(self, cid: int, target: int, ring, materialize: bool = True,
               ratio: Optional[float] = None,
               _folds: Optional[list] = None) -> Optional[DispatchPayload]:
        """The cohort escape hatch in front of the base protocol: a member
        whose accumulated mismatch bound outgrows the hop delta loses its
        tracking before the encode, so the base class ships one exact full
        snapshot (the ``dispatch_resync`` economics of the EF resync)."""
        held = self.held_version(cid)
        if (held is not None and self.fmt.delta_coded and held in ring
                and held in self.ring_versions(target)):
            m = self.table.mismatch_of(cid)
            if m > 0.0:
                if self.resync <= 0.0:
                    force = True
                else:
                    fmt = self._fmt_for(ratio)
                    ent = self._cache.get(
                        self._cache_key(held, target, fmt))
                    dnorm = (ent[3] if ent is not None
                             and ent[3] is not None
                             else _norm(ring[target] - ring[held]))
                    force = needs_resync(
                        "norm", r_norm=m, hop_norm=dnorm,
                        threshold=self.resync, fmt=fmt,
                        param_size=int(ring[target].shape[0]))
                if force:
                    self.versions.pop(cid, None)
                    self.table.remove(cid)
                    self.mismatch_resyncs += 1
                    self.tel.counter("cohort.mismatch_resync")
        return super().encode(cid, target, ring, materialize=materialize,
                              ratio=ratio, _folds=_folds)

    # ----------------------------------------------------- personalized fold
    def _fold_key(self, cid: int, held: int, target: int,
                  fmt: WireFormat) -> tuple:
        src = self.table.key_of(cid)
        if src is None:
            return super()._fold_key(cid, held, target, fmt)
        return (src, self.table.gen_of(src), target, fmt.scheme,
                fmt.topk_ratio, fmt.chunk_elems)

    def _encode_personalized(self, cid, target, held, fmt, g, ring, delta,
                             r, wire_ratio, folds=None):
        src = self.table.key_of(cid)
        if self.use_cache and src is not None:
            fk = self._fold_key(cid, held, target, fmt)
            ent = self._fold_cache.get(fk)
            if ent is not None:
                # cohort fold hit: every member's fold vec is the same hop
                # delta + shared residual, so the encode fans out
                chunks, err, nbytes = ent
                self.fold_hits += 1
                self.tel.counter("cohort.fold_hit")
                return DispatchPayload(
                    cid=cid, target_version=target, base_version=held,
                    scheme=fmt.scheme, param_size=int(g.shape[0]),
                    chunks=chunks, nbytes=nbytes, residual=err,
                    shared=False,
                    resync=(self.multicast and r is not None),
                    ratio=wire_ratio, encode_cost_bytes=0,
                    hop=("fold",) + fk)
            self.fold_misses += 1
            self.tel.counter("cohort.fold_miss")
        return super()._encode_personalized(cid, target, held, fmt, g,
                                            ring, delta, r, wire_ratio,
                                            folds)

    def _fold_encoded(self, fold_key: tuple, chunks: list[Chunk],
                      err: Optional[torch.Tensor], nbytes: int) -> None:
        # cache only cohort-keyed folds (leading element is the src cohort
        # key); per-cid fallback folds never repeat byte-identically
        if self.use_cache and isinstance(fold_key[0], tuple):
            self._fold_cache[fold_key] = (chunks, err, nbytes)

    # -------------------------------------------------------------- caches
    def age_cache(self, current: int) -> None:
        super().age_cache(current)
        if self._fold_cache:
            live = self.ring_versions(current)
            self._fold_cache = {
                k: v for k, v in self._fold_cache.items()
                if k[0][0] in live and k[2] in live
            }
        self.table.prune(self.ring_versions(current))

    def invalidate_cache(self) -> None:
        super().invalidate_cache()
        self._fold_cache = {}

    # ----------------------------------------------------------- telemetry
    def cache_info(self) -> dict:
        info = super().cache_info()
        info.update({
            "fold_hits": int(self.fold_hits),
            "fold_misses": int(self.fold_misses),
            "fold_entries": len(self._fold_cache),
            "mismatch_resyncs": int(self.mismatch_resyncs),
            "cohorts": self.table.n_cohorts(),
        })
        return info

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        s = super().state_dict()
        s["cohort"] = self.table.state_dict()
        s["fold_hits"] = int(self.fold_hits)
        s["fold_misses"] = int(self.fold_misses)
        s["mismatch_resyncs"] = int(self.mismatch_resyncs)
        return s

    def residual_trees(self) -> dict:
        # per-client residuals are unused here; persist the cohort tensors
        return self.table.residual_trees()

    def load_state(self, state: dict, trees: dict, device=None) -> None:
        super().load_state(state, trees, device)   # dr* absent
        # a restored table counts into no registry, as the reference's
        self.table = CohortTable()
        self.table.load_state(state.get("cohort", {}), trees, device)
        self.fold_hits = int(state.get("fold_hits", 0))
        self.fold_misses = int(state.get("fold_misses", 0))
        self.mismatch_resyncs = int(state.get("mismatch_resyncs", 0))
        self._fold_cache = {}
