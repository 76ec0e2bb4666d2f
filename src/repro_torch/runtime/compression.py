"""Per-leaf tree update compression -- the reference's legacy substrate.

The port of the JAX package's ``runtime/compression.py``.  The uplink does
not go through this module: client updates travel as flat chunks coded by
``runtime/codecs.py`` with a flat error-feedback residual.  This module
keeps the per-leaf formulation -- each leaf quantised separately,
tree-shaped EF residuals -- as an oracle for the compression math and as
the format of pre-transport checkpoints (``SeaflServer.load_state`` packs
such residuals into the flat EF).  The two differ exactly where per-leaf
and per-chunk granularity differ (top-k thresholds, int8 scales).

  * top-k sparsification with client-side error feedback (EF keeps the
    residual and adds it to the next update, preserving convergence);
  * int8 per-leaf symmetric quantisation.

Trees are nested dicts of tensors.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.runtime.codecs import INV_127, parse_spec
from repro_torch.tree import tree_leaves, tree_map


def _is_payload(node, key) -> bool:
    return isinstance(node, Mapping) and key in node


def _map_payloads(fn, payload, like, key):
    """``fn(leaf payload, like leaf)`` over a payload tree whose leaves are
    dicts holding ``key``, matched against the tree ``like``."""
    if _is_payload(payload, key):
        return fn(payload, like)
    return {k: _map_payloads(fn, payload[k], like[k], key) for k in payload}


def _payloads(payload, key):
    if _is_payload(payload, key):
        yield payload
        return
    for v in payload.values():
        yield from _payloads(v, key)


class Compressor:
    name = "identity"

    def compress(self, delta) -> Any:
        return delta

    def decompress(self, payload: Any, like) -> Any:
        return payload

    def compressed_bytes(self, payload: Any) -> int:
        return sum(t.numel() * t.element_size()
                   for _, t in tree_leaves(payload))

    def roundtrip(self, delta) -> tuple[Any, int]:
        payload = self.compress(delta)
        return self.decompress(payload, delta), self.compressed_bytes(payload)


@dataclass
class TopKCompressor(Compressor):
    """Keep the largest-magnitude ``ratio`` fraction of each leaf."""
    ratio: float = 0.1
    name: str = "topk"

    def compress(self, delta):
        def one(x):
            flat = x.to(torch.float32).reshape(-1)
            k = max(1, int(flat.numel() * self.ratio))
            # ties to the lower index first, as jax.lax.top_k
            order = torch.sort(flat.abs(), descending=True, stable=True)[1]
            idx = order[:k]
            return {"idx": idx.to(torch.int32), "val": flat[idx],
                    "shape": tuple(x.shape), "dtype": x.dtype}
        return tree_map(one, delta)

    def decompress(self, payload, like):
        def one(p, x):
            n = 1
            for s in p["shape"]:
                n *= s
            flat = torch.zeros(n or 1, dtype=torch.float32,
                               device=p["val"].device)
            flat[p["idx"].long()] = p["val"]
            return flat.reshape(p["shape"]).to(x.dtype)
        return _map_payloads(one, payload, like, "idx")

    def compressed_bytes(self, payload) -> int:
        return sum(p["idx"].numel() * 4 + p["val"].numel() * 4
                   for p in _payloads(payload, "idx"))


@dataclass
class Int8Compressor(Compressor):
    """Per-leaf symmetric int8 quantisation."""
    name: str = "int8"

    def compress(self, delta):
        def one(x):
            xf = x.to(torch.float32)
            scale = torch.clamp(xf.abs().max(), min=1e-12) * INV_127
            q = torch.clamp(torch.round(xf / scale), -127, 127)
            return {"q": q.to(torch.int8), "scale": scale}
        return tree_map(one, delta)

    def decompress(self, payload, like):
        def one(p, x):
            return (p["q"].to(torch.float32) * p["scale"]).to(x.dtype)
        return _map_payloads(one, payload, like, "q")

    def compressed_bytes(self, payload) -> int:
        return sum(p["q"].numel() + 4 for p in _payloads(payload, "q"))


class ErrorFeedback:
    """Client-side EF wrapper: residual e_k carries to the next round."""

    def __init__(self, compressor: Compressor):
        self.compressor = compressor
        self._residual = None

    def roundtrip(self, delta) -> tuple[Any, int]:
        if self._residual is not None:
            delta = tree_map(lambda d, e: d + e.to(d.dtype), delta,
                             self._residual)
        approx, nbytes = self.compressor.roundtrip(delta)
        self._residual = tree_map(
            lambda d, a: d.to(torch.float32) - a.to(torch.float32),
            delta, approx)
        return approx, nbytes


def make_compressor(spec: Optional[str]) -> Optional[Compressor]:
    """spec: None | 'topk:<ratio>' | 'int8', in the wire grammar of
    :func:`repro_torch.runtime.codecs.parse_spec` (same strings, same
    errors); raw schemes (f32, bf16) have no per-leaf compressor."""
    if spec is None or spec == "none":
        return None
    scheme, ratio = parse_spec(spec)
    if scheme == "topk":
        return TopKCompressor(ratio=ratio)
    if scheme == "int8":
        return Int8Compressor()
    raise ValueError(f"wire scheme {scheme!r} has no per-leaf compressor "
                     f"(raw schemes are wire-level only)")
