"""Downlink payload of the legacy whole-model broadcast.

With ``FLConfig.dispatch_compression=None`` (the only downlink this port
carries) the server ships no wire object: ``SeaflServer.encode_dispatch``
returns a marker :class:`DispatchPayload` whose ``nbytes`` is the raw f32
model size, which is what the simulator's bandwidth model charges.  The
version-tracked, delta-coded ``DispatchSession`` of the JAX package is not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.runtime.codecs import Chunk

__all__ = ["DispatchPayload"]


@dataclass
class DispatchPayload:
    """One server->client model transfer as it travels on the wire.

    ``base_version is None`` marks a full snapshot; otherwise the chunks
    carry a delta against that ring version.  ``scheme == 'raw'`` is the
    legacy broadcast marker: no wire object at all, just the f32 model size
    for the bandwidth model.  ``ratio`` is the top-k ratio the payload
    shipped at (None for non-topk schemes), ``encode_cost_bytes`` the f32
    source bytes its encode processed server-side (the simulator's
    encode-time model prices it), and ``batched`` marks a payload from a
    coalesced resync encode."""
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
