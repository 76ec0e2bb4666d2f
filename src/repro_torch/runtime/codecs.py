"""Chunk-codec layer of the wire stack.

Every byte that moves between server and client travels as fixed-size chunks
of the flat ``(P,)`` ``ParamPacker`` vector, encoded by exactly one of the
codecs registered here (the JAX package's ``runtime/codecs.py``, scheme for
scheme and byte for byte):

  f32   -- raw f32 chunks (4 B/elem).  Bit-exact passthrough; the
           no-compression baseline.
  bf16  -- bf16 chunks (2 B/elem), rounded to nearest even.
  topk  -- per-chunk top-k sparsification (idx i32 + val f32 = 8 B per kept
           elem) of a *delta*; lossy, so carriers run error feedback.
  int8  -- per-chunk symmetric int8 quantisation of a delta (1 B/elem +
           4 B scale); lossy, EF-carried.

Delta-coded schemes (``delta_coded=True``) encode a difference against a
base both ends share (the dispatch-version global on the uplink), and their
encode error is what the per-client error-feedback residuals
(:class:`FlatErrorFeedback`) accumulate: :func:`encode_error` is the
per-payload EF hook.

Numerics held to the reference's: bf16 and int8 round half to even
(``torch.round`` as ``jnp.round``); int8 clips to +-127 and scales by
max|x| / 127 with a 1e-12 floor (as XLA computes it, times 1/127); top-k keeps indices in descending |x|,
ties to the lower index first (``jax.lax.top_k`` on XLA), so a payload is
the same bytes in both packages; a top-k decode scatters into zeros.

Every chunk carries ``CHUNK_HEADER_BYTES`` of framing (seq, offset, length,
scheme tag) counted into its wire size, so the simulator's bandwidth model
charges real bytes, not idealised payload bytes.

Spec strings (:func:`parse_spec`): ``None`` | ``'none'`` | ``'f32'`` |
``'bf16'`` | ``'topk[:<ratio>]'`` | ``'int8'``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.device import sync, timed

__all__ = [
    "CHUNK_HEADER_BYTES",
    "DEFAULT_CHUNK_ELEMS",
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
    "encode_flat_batch",
    "encode_error",
    "FlatErrorFeedback",
    "set_codec_timing",
]

# seq:u32 | start:u64 | length:u32  — fixed framing per chunk
CHUNK_HEADER_BYTES = 16

DEFAULT_CHUNK_ELEMS = 1 << 16

# full chunks encoded together by encode_flat: bounds the batch encode's
# transients (a top-k sort holds 12 B an element) to ~200 MB at 64 Ki
# elements a chunk
_ROWS_PER_BATCH = 256


@dataclass
class Chunk:
    """One wire chunk: a contiguous [start, start+length) window of the
    flat (P,) vector, encoded per the carrying WireFormat."""
    seq: int
    start: int
    length: int
    payload: Any                 # scheme-specific tensor(s)
    nbytes: int                  # wire size incl. CHUNK_HEADER_BYTES


# --------------------------------------------------------------- kernels
# Each takes a (B, n) stack of windows and encodes every row alone, so a row
# of a batch is bit-identical to that window encoded by itself.

def _enc_topk_rows(x: torch.Tensor, k: int) -> dict:
    xf = x.to(torch.float32)
    # a stable descending sort keeps equal |x| in index order: the lower
    # index first, as jax.lax.top_k
    order = torch.sort(xf.abs(), dim=1, descending=True, stable=True)[1]
    idx = order[:, :k]
    return {"idx": idx.to(torch.int32), "val": torch.gather(xf, 1, idx)}


# XLA folds the reference's ``/ 127.0`` into a product with the f32
# reciprocal, which differs from the division in the last ulp
INV_127 = 1.0 / 127.0


def _enc_int8_rows(x: torch.Tensor) -> dict:
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=1), min=1e-12) * INV_127
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


# --------------------------------------------------------------- registry

class ChunkCodec:
    """One wire scheme: encode/decode of a flat f32 window + its byte law.

    ``delta_coded`` marks lossy difference codecs: they need a shared base
    on both ends and an error-feedback carrier for their encode error.
    Stateless — per-payload parameters (the top-k ratio) ride on the
    :class:`WireFormat`.
    """

    name: str = ""
    delta_coded: bool = False

    def body_bytes(self, n: int, fmt: "WireFormat") -> int:
        """Wire bytes of one n-element chunk body (header excluded)."""
        raise NotImplementedError

    def encode(self, x: torch.Tensor, fmt: "WireFormat") -> Any:
        """Encode one (n,) window: row 0 of :meth:`encode_batch`."""
        return self.split_batch(self.encode_batch(x[None], fmt), 0)

    def decode(self, payload: Any, length: int,
               fmt: "WireFormat") -> torch.Tensor:
        raise NotImplementedError

    def encode_batch(self, x: torch.Tensor, fmt: "WireFormat") -> Any:
        """Encode a (B, n) stack of windows in one pass; row ``i`` of the
        result (via :meth:`split_batch`) is bit-identical to ``encode(x[i],
        fmt)``."""
        raise NotImplementedError

    def split_batch(self, payload: Any, i: int) -> Any:
        """Row ``i`` of an :meth:`encode_batch` result, in the layout
        :meth:`decode` expects for a single chunk."""
        return payload[i]


class _F32Codec(ChunkCodec):
    name = "f32"

    def body_bytes(self, n, fmt):
        return 4 * n

    def encode(self, x, fmt):
        return x                                  # bit-exact passthrough

    def decode(self, payload, length, fmt):
        return payload

    def encode_batch(self, x, fmt):
        return x                                  # rows pass through


class _Bf16Codec(ChunkCodec):
    name = "bf16"

    def body_bytes(self, n, fmt):
        return 2 * n

    def encode(self, x, fmt):
        return x.to(torch.bfloat16)

    def decode(self, payload, length, fmt):
        return payload.to(torch.float32)

    def encode_batch(self, x, fmt):
        return x.to(torch.bfloat16)               # elementwise: rank-free


class _TopkCodec(ChunkCodec):
    name = "topk"
    delta_coded = True

    def kept(self, n: int, fmt: "WireFormat") -> int:
        """Coefficients kept per n-element chunk (≥1: a chunk is never
        empty on the wire)."""
        return max(1, int(n * fmt.topk_ratio))

    def body_bytes(self, n, fmt):
        return 8 * self.kept(n, fmt)

    def decode(self, payload, length, fmt):
        out = torch.zeros((length,), dtype=torch.float32,
                          device=payload["val"].device)
        return out.index_put_((payload["idx"].long(),), payload["val"])

    def encode_batch(self, x, fmt):
        return _enc_topk_rows(x, self.kept(int(x.shape[1]), fmt))

    def split_batch(self, payload, i):
        return {"idx": payload["idx"][i], "val": payload["val"][i]}


class _Int8Codec(ChunkCodec):
    name = "int8"
    delta_coded = True

    def body_bytes(self, n, fmt):
        return n + 4

    def decode(self, payload, length, fmt):
        return payload["q"].to(torch.float32) * payload["scale"]

    def encode_batch(self, x, fmt):
        return _enc_int8_rows(x)

    def split_batch(self, payload, i):
        return {"q": payload["q"][i], "scale": payload["scale"][i]}


CODECS: dict[str, ChunkCodec] = {
    c.name: c for c in (_F32Codec(), _Bf16Codec(), _TopkCodec(), _Int8Codec())
}


# ------------------------------------------------------------ wire format

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
            raise ValueError(f"unknown wire scheme {self.scheme!r}") from None

    @property
    def delta_coded(self) -> bool:
        """True when the wire carries delta-vs-base (needs base + EF)."""
        return self.codec.delta_coded

    def chunk_wire_bytes(self, n: int) -> int:
        """Wire bytes for one n-element chunk (header included)."""
        return self.codec.body_bytes(n, self) + CHUNK_HEADER_BYTES

    def _windows(self, p: int):
        """Element counts of the chunks of a (p,)-element payload."""
        full, tail = divmod(p, self.chunk_elems)
        return [(self.chunk_elems, full)] + ([(tail, 1)] if tail else [])

    def payload_bytes(self, p: int) -> int:
        """Total wire bytes for a (p,)-element payload under this format."""
        return sum(count * self.chunk_wire_bytes(n)
                   for n, count in self._windows(p) if count)

    def kept_coeffs(self, p: int) -> Optional[int]:
        """Top-k coefficients a (p,)-element payload keeps (None for dense
        schemes) — the byte-budget resync policy's unit of account."""
        if self.scheme != "topk":
            return None
        return sum(count * self.codec.kept(n, self)
                   for n, count in self._windows(p) if count)


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
    if scheme not in CODECS:
        raise ValueError(
            f"unknown wire scheme spec {spec!r} (expected None, 'none', "
            f"{', '.join(repr(s) for s in sorted(CODECS))}, "
            f"or 'topk:<ratio>')")
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
    """spec grammar: see :func:`parse_spec`."""
    scheme, ratio = parse_spec(spec)
    if ratio is None:
        return WireFormat(scheme, chunk_elems)
    return WireFormat(scheme, chunk_elems, topk_ratio=ratio)


# --------------------------------------------------------- chunk plumbing

# Opt-in codec wall timing (FLConfig.telemetry_kernels): the clock of the
# aggregate entry points in kernels/seafl_agg/ops.py, so encoding and
# decoding record ``kernel.encode_<scheme>_us`` / ``kernel.decode_<scheme>
# _us`` histograms of finished results (on CUDA the device is synchronised
# before and after).  None / disabled (the default) leaves them untouched.
_KERNEL_TEL = None


def set_codec_timing(telemetry: Optional[object]) -> Optional[object]:
    """Install (or clear, with None) the Telemetry that times encoding and
    decoding; returns the one it replaces.  The server installs it for the
    length of each of its own calls (core/server.py)."""
    global _KERNEL_TEL
    prev, _KERNEL_TEL = _KERNEL_TEL, telemetry
    return prev


def _timing() -> bool:
    return _KERNEL_TEL is not None and getattr(_KERNEL_TEL, "enabled", False)


def _encode_rows(codec: ChunkCodec, rows: torch.Tensor,
                 fmt: WireFormat) -> Any:
    """``codec.encode_batch`` of (r, chunk_elems) rows.  Under codec timing
    the batched call is timed as it runs, and its time over r lands as r
    samples of ``kernel.encode_<scheme>_us``: one sample a chunk, as the
    JAX package's per-chunk clock counts, each the chunk's share of the
    batch."""
    if not _timing():
        return codec.encode_batch(rows, fmt)
    sync(rows.device)
    t0 = time.perf_counter()
    payload = codec.encode_batch(rows, fmt)
    sync(rows.device)
    r = int(rows.shape[0])
    _KERNEL_TEL.histogram_many(f"kernel.encode_{fmt.scheme}_us",
                               [(time.perf_counter() - t0) * 1e6 / r] * r)
    return payload


def _payload_device(payload: Any) -> torch.device:
    t = payload if isinstance(payload, torch.Tensor) \
        else next(iter(payload.values()))
    return t.device


def encode_chunk(x: torch.Tensor, seq: int, start: int,
                 fmt: WireFormat) -> Chunk:
    """Encode one (n,) f32 window of the flat vector."""
    n = int(x.shape[0])
    payload = timed(_KERNEL_TEL, f"encode_{fmt.scheme}", x.device,
                    fmt.codec.encode, x, fmt)
    return Chunk(seq=seq, start=start, length=n, payload=payload,
                 nbytes=fmt.chunk_wire_bytes(n))


def decode_chunk(chunk: Chunk, fmt: WireFormat) -> torch.Tensor:
    """Decode one chunk back to its (length,) f32 window."""
    return timed(_KERNEL_TEL, f"decode_{fmt.scheme}",
                 _payload_device(chunk.payload), fmt.codec.decode,
                 chunk.payload, chunk.length, fmt)


def decode_concat(chunks: list[Chunk], fmt: WireFormat) -> torch.Tensor:
    """Decode an in-order chunk sequence back to one flat f32 vector."""
    vals = [decode_chunk(c, fmt) for c in chunks if c.length]
    if not vals:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(vals) if len(vals) > 1 else vals[0]


def _empty_sentinel(device) -> Chunk:
    """The one chunk of a zero-parameter model."""
    return Chunk(0, 0, 0, torch.zeros((0,), dtype=torch.float32,
                                      device=device), CHUNK_HEADER_BYTES)


def encode_flat(vec: torch.Tensor, fmt: WireFormat) -> list[Chunk]:
    """Split a flat (P,) vector into encoded wire chunks (f32 chunks are
    views of ``vec``, which the caller must not modify afterwards).

    The full chunks are encoded a batch of rows at a time
    (``codec.encode_batch`` over a (rows, chunk_elems) view), the tail alone;
    each chunk is bit-identical to :func:`encode_chunk` of its window."""
    p, ce = int(vec.shape[0]), fmt.chunk_elems
    if p == 0:
        return [_empty_sentinel(vec.device)]
    codec = fmt.codec
    full = p // ce
    rows = vec[:full * ce].reshape(full, ce)
    chunks, nbytes = [], fmt.chunk_wire_bytes(ce)
    for r0 in range(0, full, _ROWS_PER_BATCH):
        r1 = min(r0 + _ROWS_PER_BATCH, full)
        payload = _encode_rows(codec, rows[r0:r1], fmt)
        chunks += [Chunk(seq=r, start=r * ce, length=ce,
                         payload=codec.split_batch(payload, r - r0),
                         nbytes=nbytes) for r in range(r0, r1)]
    if full * ce < p:
        chunks.append(encode_chunk(vec[full * ce:], full, full * ce, fmt))
    return chunks


def encode_flat_batch(vecs, fmt: WireFormat) -> list[list[Chunk]]:
    """Encode a stack of same-length flat vectors in one pass per chunk
    window.  ``vecs`` is a (B, P) tensor or a list of B (P,) tensors.
    Returns one chunk list per row, each bit-identical to
    ``encode_flat(vecs[i], fmt)``."""
    arr = vecs if isinstance(vecs, torch.Tensor) and vecs.ndim == 2 \
        else torch.stack(list(vecs))
    b, p = int(arr.shape[0]), int(arr.shape[1])
    if p == 0:
        return [[_empty_sentinel(arr.device)] for _ in range(b)]
    codec = fmt.codec
    out: list[list[Chunk]] = [[] for _ in range(b)]
    off, seq = 0, 0
    while off < p:
        n = min(fmt.chunk_elems, p - off)
        payload = codec.encode_batch(arr[:, off:off + n], fmt)
        nbytes = fmt.chunk_wire_bytes(n)
        for i in range(b):
            out[i].append(Chunk(seq=seq, start=off, length=n,
                                payload=codec.split_batch(payload, i),
                                nbytes=nbytes))
        off += n
        seq += 1
    return out


def encode_error(vec: torch.Tensor, chunks: list[Chunk],
                 fmt: WireFormat) -> Optional[torch.Tensor]:
    """What the encoded wire failed to deliver: ``vec - decode(chunks)``.
    The per-payload error-feedback hook; None for an empty vector
    (zero-parameter model)."""
    if not int(vec.shape[0]):
        return None
    return vec - decode_concat(chunks, fmt)


class FlatErrorFeedback:
    """Per-client error feedback on the flat (P,) delta.

    The residual the lossy wire dropped last round is added to this round's
    delta before encoding, preserving convergence of compressed uploads:
    one (P,) tensor.
    """

    def __init__(self, residual: Optional[torch.Tensor] = None):
        self.residual = residual

    def carry_in(self, delta: torch.Tensor) -> torch.Tensor:
        if self.residual is None:
            return delta
        return delta + self.residual

    def carry_out(self, sent: torch.Tensor, decoded: torch.Tensor) -> None:
        """sent = delta + old residual; decoded = what the wire delivered."""
        self.residual = sent - decoded
