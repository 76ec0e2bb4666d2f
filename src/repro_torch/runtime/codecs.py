"""Chunk-codec layer of the wire stack: the raw f32 scheme.

Every byte that moves between server and client travels as fixed-size chunks
of the flat ``(P,)`` ``ParamPacker`` vector, encoded by one of the codecs
registered here.  This port carries the ``f32`` codec (raw f32 chunks,
4 B/elem, bit-exact passthrough) — the uplink of the default configuration.
The spec grammar knows the JAX package's other schemes (``bf16``, ``topk``,
``int8``) and refuses them with ``NotImplementedError`` until they are
ported.

Every chunk carries ``CHUNK_HEADER_BYTES`` of framing (seq, offset, length,
scheme tag) counted into its wire size, so the simulator's bandwidth model
charges real bytes, not idealised payload bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = [
    "CHUNK_HEADER_BYTES",
    "DEFAULT_CHUNK_ELEMS",
    "SCHEMES",
    "Chunk",
    "ChunkCodec",
    "CODECS",
    "WireFormat",
    "parse_spec",
    "make_wire_format",
    "encode_chunk",
    "decode_chunk",
    "decode_concat",
    "encode_flat",
]

# seq:u32 | start:u64 | length:u32  — fixed framing per chunk
CHUNK_HEADER_BYTES = 16

DEFAULT_CHUNK_ELEMS = 1 << 16

#: every scheme the spec grammar accepts (the JAX package's set)
SCHEMES = ("bf16", "f32", "int8", "topk")


@dataclass
class Chunk:
    """One wire chunk: a contiguous [start, start+length) window of the
    flat (P,) vector, encoded per the carrying WireFormat."""
    seq: int
    start: int
    length: int
    payload: Any                 # scheme-specific tensor(s)
    nbytes: int                  # wire size incl. CHUNK_HEADER_BYTES


class ChunkCodec:
    """One wire scheme: encode/decode of a flat f32 window + its byte law."""

    name: str = ""
    delta_coded: bool = False

    def body_bytes(self, n: int, fmt: "WireFormat") -> int:
        """Wire bytes of one n-element chunk body (header excluded)."""
        raise NotImplementedError

    def encode(self, x: torch.Tensor, fmt: "WireFormat") -> Any:
        raise NotImplementedError

    def decode(self, payload: Any, length: int,
               fmt: "WireFormat") -> torch.Tensor:
        raise NotImplementedError


class _F32Codec(ChunkCodec):
    name = "f32"

    def body_bytes(self, n, fmt):
        return 4 * n

    def encode(self, x, fmt):
        return x                                  # bit-exact passthrough

    def decode(self, payload, length, fmt):
        return payload


CODECS: dict[str, ChunkCodec] = {"f32": _F32Codec()}


@dataclass(frozen=True)
class WireFormat:
    """Static description of one wire encoding."""
    scheme: str = "f32"                      # key into CODECS
    chunk_elems: int = DEFAULT_CHUNK_ELEMS   # elements per wire chunk
    topk_ratio: float = 0.1

    @property
    def codec(self) -> ChunkCodec:
        try:
            return CODECS[self.scheme]
        except KeyError:
            raise NotImplementedError(
                f"wire scheme {self.scheme!r} is not ported yet") from None

    @property
    def delta_coded(self) -> bool:
        """True when the wire carries delta-vs-base (needs base + EF)."""
        return self.codec.delta_coded

    def chunk_wire_bytes(self, n: int) -> int:
        """Wire bytes for one n-element chunk (header included)."""
        return self.codec.body_bytes(n, self) + CHUNK_HEADER_BYTES

    def payload_bytes(self, p: int) -> int:
        """Total wire bytes for a (p,)-element payload under this format."""
        total, off = 0, 0
        while off < p:
            n = min(self.chunk_elems, p - off)
            total += self.chunk_wire_bytes(n)
            off += n
        return total


def parse_spec(spec: Optional[str]) -> tuple[str, Optional[float]]:
    """Validate one wire-scheme spec -> ``(scheme, topk_ratio)``.

    Grammar: ``None`` | ``'none'`` | ``'f32'`` | ``'bf16'`` |
    ``'topk'`` | ``'topk:<ratio>'`` | ``'int8'``.  ``None``/``'none'``
    mean uncompressed and normalise to ``'f32'``."""
    if spec is None or spec == "none":
        return "f32", None
    if not isinstance(spec, str):
        raise ValueError(f"wire scheme spec must be a string or None, "
                         f"got {type(spec).__name__}")
    scheme, _, arg = spec.partition(":")
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown wire scheme spec {spec!r} (expected None, 'none', "
            f"{', '.join(repr(s) for s in SCHEMES)}, or 'topk:<ratio>')")
    if scheme != "topk":
        if arg:
            raise ValueError(f"wire scheme {scheme!r} takes no argument, "
                             f"got {spec!r}")
        return scheme, None
    if not arg:
        return "topk", 0.1
    try:
        ratio = float(arg)
    except ValueError:
        raise ValueError(f"topk ratio must be a number, got {arg!r}") \
            from None
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
    return "topk", ratio


def make_wire_format(spec: Optional[str],
                     chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> WireFormat:
    """spec grammar: see :func:`parse_spec`.  Raises NotImplementedError
    for a valid scheme this port does not carry yet."""
    scheme, ratio = parse_spec(spec)
    if scheme not in CODECS:
        raise NotImplementedError(
            f"wire scheme {scheme!r} is not ported yet (only 'f32')")
    if ratio is None:
        return WireFormat(scheme, chunk_elems)
    return WireFormat(scheme, chunk_elems, topk_ratio=ratio)


# --------------------------------------------------------- chunk plumbing

def encode_chunk(x: torch.Tensor, seq: int, start: int,
                 fmt: WireFormat) -> Chunk:
    """Encode one (n,) f32 window of the flat vector."""
    n = int(x.shape[0])
    return Chunk(seq=seq, start=start, length=n,
                 payload=fmt.codec.encode(x, fmt),
                 nbytes=fmt.chunk_wire_bytes(n))


def decode_chunk(chunk: Chunk, fmt: WireFormat) -> torch.Tensor:
    """Decode one chunk back to its (length,) f32 window."""
    return fmt.codec.decode(chunk.payload, chunk.length, fmt)


def decode_concat(chunks: list[Chunk], fmt: WireFormat) -> torch.Tensor:
    """Decode an in-order chunk sequence back to one flat f32 vector."""
    vals = [decode_chunk(c, fmt) for c in chunks if c.length]
    if not vals:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(vals) if len(vals) > 1 else vals[0]


def encode_flat(vec: torch.Tensor, fmt: WireFormat) -> list[Chunk]:
    """Split a flat (P,) vector into encoded wire chunks (f32 chunks are
    views of ``vec``, which the caller must not modify afterwards)."""
    p = int(vec.shape[0])
    chunks, off, seq = [], 0, 0
    while off < p:
        n = min(fmt.chunk_elems, p - off)
        chunks.append(encode_chunk(vec[off:off + n], seq, off, fmt))
        off += n
        seq += 1
    if not chunks:             # zero-parameter model: one empty sentinel
        chunks.append(Chunk(0, 0, 0, torch.zeros((0,), dtype=torch.float32),
                            CHUNK_HEADER_BYTES))
    return chunks
