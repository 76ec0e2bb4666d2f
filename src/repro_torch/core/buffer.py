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
``stacked_flat`` is a zero-copy view whenever the committed rows are
contiguous from 0 (the common, single-stream case) and a gather otherwise.

The reference places the slot axis over the 'pod' mesh axis at allocation
and on growth (``shard_update_buffer``).  Here the slot array stays a plain
tensor on every mesh: the writes, the row merge and the flat engine that
reads ``stacked_flat`` take plain tensors, and placing it waits until they
take a DTensor's local shards (ROADMAP A19).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.telemetry import Telemetry, of as _tel_of


@dataclass
class Update:
    """Per-slot host metadata (the params live in the device buffer)."""
    client_id: int
    n_samples: int
    version: int              # t_k — round at which the client got the model
    n_epochs: int             # epochs actually completed (< E under SEAFL²)
    recv_time: float = 0.0
    meta: dict = field(default_factory=dict)


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
        self._buf: Optional[torch.Tensor] = None
        if param_size is not None:
            self._buf = self._alloc(self.capacity, int(param_size))

    def _alloc(self, rows: int, p: int) -> torch.Tensor:
        return torch.zeros((rows, p), dtype=self.dtype, device=self.device)

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
        """Allocated device bytes of the slot array (the bf16-mode metric)."""
        if self._buf is None:
            return 0
        return self._buf.numel() * self._buf.element_size()

    # ---------------------------------------------------------- slot protocol
    def _grow(self) -> None:
        # SEAFL sync-wait can hold aggregation while updates keep landing
        # (paper §IV-B): spill past K by doubling the slot array.
        old = self._buf
        rows = old.shape[0]
        self._buf = torch.cat([old, self._alloc(rows, self.param_size)])
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
            self._buf = self._alloc(self.capacity, self.param_size)
        if not self._free:
            self._grow()
        slot = heapq.heappop(self._free)
        self._pending[slot] = u
        return slot

    def write_range(self, slot: int, start: int, vals: torch.Tensor) -> None:
        """In-place write of ``vals`` into row ``slot`` at element ``start``
        (cast to the slot dtype: bf16 rounds to nearest-even)."""
        self._buf[slot, start:start + vals.shape[0]] = vals

    def write_batch(self, items: list) -> None:
        """One indexed write applying many ``(slot, start, vals)`` chunk
        writes at once — the batched-ingest hot path (IngestBatcher flushes
        land here).  All ``vals`` must share one length; the windows are
        disjoint, so the result equals the writes done one by one."""
        if not items:
            return
        if len(items) == 1:
            slot, start, vals = items[0]
            self.write_range(slot, start, vals)
            return
        n = int(items[0][2].shape[0])
        dev = self._buf.device
        rows = torch.tensor([s for s, _, _ in items], device=dev)
        starts = torch.tensor([o for _, o, _ in items], device=dev)
        cols = starts[:, None] + torch.arange(n, device=dev)[None, :]
        vals = torch.stack([v for _, _, v in items]).to(self.dtype)
        self._buf[rows[:, None], cols] = vals

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
        fold and recycling of ``src_slot`` via :meth:`uncommit`."""
        wd = torch.tensor(w_dst, dtype=torch.float32)
        ws = torch.tensor(w_src, dtype=torch.float32)
        a = self._buf[dst_slot].to(torch.float32)
        b = self._buf[src_slot].to(torch.float32)
        self._buf[dst_slot] = (wd * a + ws * b) / (wd + ws)

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

    def stacked_flat(self) -> torch.Tensor:
        """(k, P) view of the committed slots in arrival order.  Zero-copy
        when the rows are 0..k-1 (single-stream case); gather when
        concurrent streams committed out of order."""
        if self._buf is None:
            raise RuntimeError("UpdateBuffer is empty")
        rows = [r for _, r in self._committed]
        if rows == list(range(len(rows))):
            return self._buf[:len(rows)]
        return self._buf[torch.tensor(rows, device=self._buf.device)]

    def row(self, i: int) -> torch.Tensor:
        """(P,) view of the i-th committed update."""
        return self._buf[self._committed[i][1]]

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
