"""K-slot update buffer (Algorithm 1 'Server stores received updates').

Host-side metadata + one preallocated ``(K, P)`` device tensor.  Client
updates arrive over the chunked uplink transport (runtime/transport.py) and
are written chunk by chunk into a reserved slot with in-place tensor writes
(where the JAX package donates its buffer) — no stored delta pytrees, no
transient (P,) staging vector.

Two storage modes (``dtype``): f32 slots, or bf16 slots at half the memory
(writes round to nearest-even) — the seafl_agg kernels accumulate in f32
either way.

Slot protocol (slots are *physical rows*, decoupled from commit order so
concurrent streams may finish — or die — in any order):
  ``reserve(meta) -> slot``    claim a free row (grows past K under SEAFL
                               sync-wait spill);
  ``write_range(slot, off, v)``  in-place chunk write into that row;
  ``write_batch(items)``       one indexed write landing many queued
                               (slot, start, vals) chunk writes at once —
                               the IngestBatcher flush path;
  ``commit(slot)``             the upload completed; the slot joins the
                               committed sequence (arrival order);
  ``release(slot)``            the upload died mid-stream; the row returns
                               to the free pool.
``add`` keeps the monolithic one-call write on top of the same protocol.
``stacked_flat`` is a zero-copy view whenever the committed rows run on
in arrival order (the common, single-stream case) and a gather otherwise.

On a mesh whose 'pod' axis has more than one device and divides the rows,
the slot array is placed as the reference places it
(``sharding.shard_update_buffer``, at allocation and on growth): a DTensor
whose rows shard over 'pod', each pod keeping its own slots.  The writes
land only on the rank that holds the row; ``merge_rows`` moves one row
across pods where the two lie on different ones; growth gathers the rows,
doubles and re-places them (doubling changes which pod holds which row);
``stacked_flat`` then gives each rank its own committed rows with their
arrival indices (:class:`LocalRows`), which the flat engine aggregates on
each rank and reduces across 'pod'; ``row`` hands a row whole to every
rank.  Off a mesh, and on a pod of one, the slot array is a plain tensor
and every path is the one-device one.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.telemetry import Telemetry, of as _tel_of
from repro_torch.sharding import RowShards, shard_update_buffer


@dataclass
class Update:
    """Per-slot host metadata (the params live in the device buffer)."""
    client_id: int
    n_samples: int
    version: int              # t_k — round at which the client got the model
    n_epochs: int             # epochs actually completed (< E under SEAFL²)
    recv_time: float = 0.0
    meta: dict = field(default_factory=dict)


class LocalRows(NamedTuple):
    """A pod-sharded buffer's committed rows as one rank holds them:
    ``rows`` (k_local, P), in arrival order, are the committed updates at
    ``index`` of the ``k`` in arrival order, and ``shards`` says which
    pod this rank is and how to reduce across pods."""
    rows: torch.Tensor
    index: list
    k: int
    shards: RowShards


class UpdateBuffer:
    """Fixed-capacity slot buffer: metadata list + (capacity, P) tensor on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, capacity: int, param_size: Optional[int] = None,
                 dtype=torch.float32, telemetry: Optional[Telemetry] = None,
                 device=None):
        self.tel = _tel_of(telemetry)
        self.capacity = int(capacity)
        self.param_size = param_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self._committed: list[tuple[Update, int]] = []   # (meta, row), arrival
        self._pending: dict[int, Update] = {}            # row -> meta
        self._free: list[int] = list(range(self.capacity))  # min-heap
        self._buf: Optional[torch.Tensor] = None    # plain, or a DTensor
        self._rows: Optional[torch.Tensor] = None   # this rank's rows of it
        self._shards: Optional[RowShards] = None    # None: every row here
        if param_size is not None:
            self._place(torch.zeros((self.capacity, int(param_size)),
                                    dtype=self.dtype, device=self.device))

    def _place(self, buf: torch.Tensor) -> None:
        """Hold ``buf`` as the slot array, placed as the reference places
        it (its rows over 'pod' on such a mesh, else as it is)."""
        self._buf = shard_update_buffer(buf)
        self._shards = RowShards.of(self._buf)
        self._rows = self._buf if self._shards is None \
            else self._buf.to_local()

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's storage, None where another pod
        holds it."""
        return slot if self._shards is None else self._shards.local(slot)

    def __len__(self) -> int:
        return len(self._committed)

    @property
    def full(self) -> bool:
        return len(self._committed) >= self.capacity

    @property
    def streaming(self) -> bool:
        """True while any reserved slot has not been committed."""
        return bool(self._pending)

    @property
    def hbm_bytes(self) -> int:
        """Allocated device bytes of the whole slot array, on every pod
        together (the bf16-mode metric)."""
        if self._buf is None:
            return 0
        return self._buf.numel() * self._buf.element_size()

    # ---------------------------------------------------------- slot protocol
    def _grow(self) -> None:
        # SEAFL sync-wait can hold aggregation while updates keep landing
        # (paper §IV-B): spill past K by doubling the slot array.  A
        # pod-sharded array is gathered first, as the reference replicates
        # it: doubling moves rows to other pods.
        old = self._buf if self._shards is None else self._buf.full_tensor()
        rows = old.shape[0]
        self._place(torch.cat([old, torch.zeros_like(old)]))
        for r in range(rows, 2 * rows):
            heapq.heappush(self._free, r)
        self.tel.counter("buffer.spill_grow")
        self.tel.gauge("buffer.rows", 2 * rows)

    def reserve(self, u: Update, param_size: Optional[int] = None) -> int:
        """Claim a free slot for a streaming upload."""
        if self._buf is None:                 # lazy alloc from first update
            if param_size is None:
                raise ValueError(
                    "UpdateBuffer was built without param_size; the first "
                    "reserve() must pass param_size= (add() infers it from "
                    "the flat vector)")
            self.param_size = int(param_size)
            self._place(torch.zeros((self.capacity, self.param_size),
                                    dtype=self.dtype, device=self.device))
        if not self._free:
            self._grow()
        slot = heapq.heappop(self._free)
        self._pending[slot] = u
        return slot

    def write_range(self, slot: int, start: int, vals: torch.Tensor) -> None:
        """In-place write of ``vals`` into row ``slot`` at element ``start``
        (cast to the slot dtype: bf16 rounds to nearest-even); only on the
        rank that holds the row."""
        r = self._local(slot)
        if r is not None:
            self._rows[r, start:start + vals.shape[0]] = vals

    def write_batch(self, items: list) -> None:
        """One indexed write applying many ``(slot, start, vals)`` chunk
        writes at once — the batched-ingest hot path (IngestBatcher flushes
        land here).  All ``vals`` must share one length; the windows are
        disjoint, so the result equals the writes done one by one.  Each
        rank writes the rows it holds."""
        items = [(r, o, v) for r, o, v in
                 ((self._local(s), o, v) for s, o, v in items)
                 if r is not None]
        if not items:
            return
        if len(items) == 1:
            r, start, vals = items[0]
            self._rows[r, start:start + vals.shape[0]] = vals
            return
        n = int(items[0][2].shape[0])
        dev = self._rows.device
        rows = torch.tensor([s for s, _, _ in items], device=dev)
        starts = torch.tensor([o for _, o, _ in items], device=dev)
        cols = starts[:, None] + torch.arange(n, device=dev)[None, :]
        vals = torch.stack([v for _, _, v in items]).to(self.dtype)
        self._rows[rows[:, None], cols] = vals

    def commit(self, slot: int) -> None:
        """The upload for ``slot`` completed; make it visible to readers.
        Commits may land in any order (concurrent streams)."""
        if slot not in self._pending:
            raise RuntimeError(f"slot {slot} is not a reserved slot")
        self._committed.append((self._pending.pop(slot), slot))
        self.tel.gauge("buffer.committed", len(self._committed))
        self.tel.gauge("buffer.pending", len(self._pending))

    def merge_rows(self, dst_slot: int, src_slot: int,
                   w_dst: float, w_src: float) -> None:
        """Sample-weighted in-place merge of row ``src_slot`` into row
        ``dst_slot`` (f32 accumulation): ``buf[dst] = (w_dst*buf[dst] +
        w_src*buf[src]) / (w_dst + w_src)``.  The caller owns the metadata
        fold and recycling of ``src_slot`` via :meth:`uncommit`.  Where
        the two rows lie on different pods, ``src_slot``'s row moves to
        ``dst_slot``'s (one collective over 'pod')."""
        sh = self._shards
        across = sh is not None and sh.owner(dst_slot) != sh.owner(src_slot)
        b = self._from_owner(src_slot) if across else None
        d = self._local(dst_slot)
        if d is None:
            return
        if b is None:
            b = self._rows[self._local(src_slot)]
        wd = torch.tensor(w_dst, dtype=torch.float32)
        ws = torch.tensor(w_src, dtype=torch.float32)
        a = self._rows[d].to(torch.float32)
        self._rows[d] = (wd * a + ws * b.to(torch.float32)) / (wd + ws)

    def uncommit(self, slot: int) -> Update:
        """Remove a *committed* slot from the visible sequence and recycle
        its row (the inverse of :meth:`commit`).  Returns its metadata."""
        for i, (u, r) in enumerate(self._committed):
            if r == slot:
                self._committed.pop(i)
                heapq.heappush(self._free, slot)
                return u
        raise RuntimeError(f"slot {slot} is not a committed slot")

    def release(self, slot: int) -> None:
        """The upload for ``slot`` died mid-stream; recycle the row."""
        if slot not in self._pending:
            raise RuntimeError(f"slot {slot} is not a reserved slot")
        self._pending.pop(slot)
        heapq.heappush(self._free, slot)

    def add(self, u: Update, flat_params: torch.Tensor) -> None:
        """Monolithic path: reserve + one full-row write + commit."""
        slot = self.reserve(u, param_size=int(flat_params.shape[0]))
        self.write_range(slot, 0, flat_params)
        self.commit(slot)

    # ----------------------------------------------------------------- reads
    def updates(self) -> list[Update]:
        return [u for u, _ in self._committed]

    def staleness(self, current_round: int) -> torch.Tensor:
        return torch.tensor([current_round - u.version
                             for u, _ in self._committed],
                            dtype=torch.float32)

    def data_sizes(self) -> torch.Tensor:
        return torch.tensor([u.n_samples for u, _ in self._committed],
                            dtype=torch.float32)

    def stacked_flat(self):
        """(k, P) view of the committed slots in arrival order.  Zero-copy
        when the rows run on in that order (single-stream case); gather
        when concurrent streams committed out of order.  On a pod-sharded
        buffer, this rank's own committed rows and their arrival indices
        (:class:`LocalRows`), by the same rule on its shard."""
        if self._buf is None:
            raise RuntimeError("UpdateBuffer is empty")
        if self._shards is None:
            return _rows_of(self._rows, [r for _, r in self._committed])
        held = [(i, self._local(s)) for i, (_, s) in
                enumerate(self._committed)]
        mine = [(i, r) for i, r in held if r is not None]
        return LocalRows(_rows_of(self._rows, [r for _, r in mine]),
                         [i for i, _ in mine], len(self._committed),
                         self._shards)

    def row(self, i: int) -> torch.Tensor:
        """(P,) view of the i-th committed update; on a pod-sharded buffer
        the row whole on every rank (one collective over 'pod')."""
        slot = self._committed[i][1]
        return self._rows[slot] if self._shards is None \
            else self._from_owner(slot)

    def _from_owner(self, slot: int) -> torch.Tensor:
        """``slot``'s row on every rank of a pod-sharded buffer, handed over
        by the pod that holds it (one collective over 'pod')."""
        r = self._local(slot)
        row = self._rows[r] if r is not None else torch.empty_like(
            self._rows[0])
        return self._shards.broadcast(row, self._shards.owner(slot))

    def drain(self) -> list[Update]:
        """Consume the committed slots; rows return to the free pool.
        Mid-stream reservations survive (their rows stay claimed)."""
        out = [u for u, _ in self._committed]
        for _, r in self._committed:
            heapq.heappush(self._free, r)
        self._committed = []
        return out

    def client_ids(self) -> list[int]:
        return [u.client_id for u, _ in self._committed]


def _rows_of(buf: torch.Tensor, rows: list) -> torch.Tensor:
    """``buf``'s ``rows`` stacked: a view where they run on from the first,
    else a gather."""
    if not rows:
        return buf[:0]
    if rows == list(range(rows[0], rows[0] + len(rows))):
        return buf[rows[0]:rows[0] + len(rows)]
    return buf[torch.tensor(rows, device=buf.device)]
