"""Per-chip kernel autotuner: measured sweeps and a device-keyed tuning cache.

The port of the JAX package's ``runtime/autotune.py``, retargeted to the
card.  Three layers carry performance knobs with fixed defaults: the
aggregation kernels (kernels/seafl_agg: the grid over P), the chunk codecs
(runtime/codecs.py: ``chunk_elems``) and the streaming-ingest batcher
(runtime/transport.py: the flush size and the bypass verdict).  This module
measures them on the device the server runs on:

  * ``block_p`` is the elements of P that one CUDA block covers per
    grid-stride step, so it sets the grid (``nblocks = ceil(P / block_p)``)
    of B1-B3; ``DEFAULT_BLOCK_P`` is the kernels' own grid (256 threads x 16
    elements), so the default plan launches exactly the untuned grid.  B2
    writes each element from its own K-term sum, so its output does not
    depend on the grid; B1 sums its per-block partials in a fixed order over
    the blocks, so another grid is another summation order;

  * ``sweep_agg_entry`` times every ``block_p`` candidate and the plain
    twin (kernels/seafl_agg/ref.py, as ``oracle_us``) with the clock of the
    ``kernel.<name>_us`` histograms: a wall clock around a finished result
    (on CUDA the device is synchronised before the clock starts and after
    the call), best of ``reps`` after a warm call.  Unlike the JAX package,
    the port never routes a CUDA tensor to the plain twin (ops.py sends CUDA
    to the kernel and the CPU to the twin, with no fallback): a sweep's
    ``use_oracle`` is always false, ``oracle_faster`` records when the
    twin would have won, and a server's plan is the ``block_p`` alone.  On
    the CPU there is one route, so by default only the default ``block_p``
    is timed;

  * each sweep reports measured-vs-predicted against a byte/operation
    bound from the H100's spec-sheet rates (kernels/_common.py).  The JAX
    package raises that bound by a second prediction from compiled HLO
    (``predict_from_hlo``); the port's counterpart, ``predict_from_cost``
    (launch/op_cost.py's count of the ops the plain twin dispatches), is
    not in the bound or the record: eager PyTorch materialises every op,
    so its count is no lower bound on the fused kernel's time (folded in,
    it put the measured kernel below its "bound" on the H100);

  * winners are cached in a versioned JSON keyed by ``(device kind, dtype,
    scheme, P-bucket, K-bucket)``, the JAX package's schema with the
    framework version under ``torch_version``.  The user cache has its own
    path (``~/.cache/repro_torch_autotune/tuning_v1.json``), so the two
    packages never overwrite each other's file, and the port's default
    table is its own file beside this module, which the repository does not
    ship (a table swept on the card is written by ``--write-default``).  A
    version or device-kind mismatch invalidates a file entirely.

``FLConfig.autotune`` selects the mode at server construction:

  'off'    no tuner anywhere: the untuned code path, bit for bit;
  'cache'  the cached or default-table winners applied, no measurement;
  'sweep'  measure the shapes this server will run, persist the winners to
           the user cache (or ``cache_path``), then apply them.

The ingest verdict answers the batcher's bypass question without its
one-shot probe; the probe stays the cache-miss fallback.  Sweeps are
deterministic given their timer (injectable: ``timer(fn, label) ->
seconds``).

    python -m repro_torch.runtime.autotune --write-default [--out PATH]
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import cosine_from_partials
from repro_torch.core.buffer import UpdateBuffer
from repro_torch.device import resolve_device, sync
from repro_torch.kernels._common import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from repro_torch.kernels.seafl_agg import ops, ref
from repro_torch.kernels.seafl_agg.kernel import DEFAULT_BLOCK_P
from repro_torch.runtime.codecs import (
    decode_concat, encode_flat, make_wire_format, parse_spec,
)

__all__ = [
    "CACHE_VERSION",
    "AGG_ENTRY_POINTS",
    "BLOCK_P_CANDIDATES",
    "CHUNK_ELEMS_CANDIDATES",
    "FLUSH_CANDIDATES",
    "DEFAULT_BLOCK_P",
    "TuningTable",
    "ServerTuning",
    "device_kind",
    "user_cache_path",
    "default_table_path",
    "load_table",
    "make_key",
    "bucket",
    "sweep_agg_entry",
    "sweep_codec",
    "sweep_ingest",
    "predict_agg_seconds",
    "predict_from_cost",
    "partials_drift",
    "GRID_BOUND",
    "GRID_BOUNDED",
    "write_default_table",
]

# bump on any change to key grammar or entry schema: old files invalidate
# wholesale and re-sweep, they are never half-read
CACHE_VERSION = 1

BLOCK_P_CANDIDATES = (1024, 2048, 4096, 8192, 16384)
CHUNK_ELEMS_CANDIDATES = (1 << 14, 1 << 15, 1 << 16, 1 << 17)
FLUSH_CANDIDATES = (8, 16, 32)

# how far the math may move with block_p: B2 not at all (bit-identical);
# B1's |d|^2, |g|^2 and row cosine within this of the default grid's
# (partials_drift)
GRID_BOUND = 1e-6
GRID_BOUNDED = ("|d|^2", "|g|^2", "cosine")

# the four seafl_agg entry points the block_p sweep covers: the three raw
# kernels plus the fused delta-free server hot path
AGG_ENTRY_POINTS = (
    "similarity_partials",
    "similarity_partials_from_params",
    "weighted_aggregate",
    "seafl_aggregate_flat_from_params",
)

_DEFAULT_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "autotune_default.json")


# ------------------------------------------------------------ chip identity

def device_kind(device=None) -> str:
    """The cache's per-chip axis: the card's name on CUDA, ``"cpu"`` on the
    CPU.  It is the server's device, not the process's; ``None`` is the
    card (repro_torch.device.resolve_device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def user_cache_path() -> str:
    root = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(root, "repro_torch_autotune",
                        f"tuning_v{CACHE_VERSION}.json")


def default_table_path() -> str:
    """The port's default table (cold-start fallback; not shipped)."""
    return _DEFAULT_TABLE


# ------------------------------------------------------------------- keys

def dtype_name(dtype) -> str:
    """``torch.float32`` / ``"float32"`` -> ``"float32"`` (the key's form)."""
    return str(dtype).removeprefix("torch.")


def bucket(n: int) -> int:
    """ceil(log2 n): shapes within one power-of-two band share an entry."""
    return max(0, math.ceil(math.log2(max(1, int(n)))))


def make_key(kind: str, name: str, dtype, scheme: Optional[str],
             p: int, k: int, device: str) -> str:
    """One cache entry key: (device kind, dtype, scheme, P-bucket,
    K-bucket) plus the tuned surface (``kind:name``)."""
    return (f"{kind}:{name}|{device}|{dtype_name(dtype)}|{scheme or '-'}"
            f"|P{bucket(p)}|K{bucket(k)}")


def _split_key(key: str):
    head, dev, dt, scheme, pb, kb = key.split("|")
    return head, dev, dt, scheme, int(pb[1:]), int(kb[1:])


# ------------------------------------------------------------------ table

@dataclass
class TuningTable:
    """Versioned winning-config store, one JSON file on disk.

    A file whose ``version`` or ``device_kind`` does not match the device
    it is loaded for is *entirely* invalid (its winners were measured on a
    different schema or a different chip): the loader returns None so the
    caller re-sweeps instead of misapplying."""

    device: str = "cpu"
    torch_version: str = field(default_factory=lambda: torch.__version__)
    version: int = CACHE_VERSION
    entries: dict = field(default_factory=dict)
    source: str = "fresh"          # 'fresh' | 'user-cache' | 'default-table'

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, value: dict) -> None:
        self.entries[key] = value

    def lookup(self, kind: str, name: str, dtype, scheme: Optional[str],
               p: int, k: int) -> Optional[dict]:
        """Exact (P-bucket, K-bucket) hit, else the nearest swept bucket of
        the same (kind, name, device, dtype, scheme)."""
        key = make_key(kind, name, dtype, scheme, p, k, device=self.device)
        hit = self.entries.get(key)
        if hit is not None:
            return hit
        head, dev, dt, sch, pb, kb = _split_key(key)
        best, best_d = None, None
        for other, entry in self.entries.items():
            try:
                h2, d2, t2, s2, pb2, kb2 = _split_key(other)
            except ValueError:
                continue
            if (h2, d2, t2, s2) != (head, dev, dt, sch):
                continue
            d = abs(pb2 - pb) + abs(kb2 - kb)
            if best_d is None or d < best_d:
                best, best_d = entry, d
        return best

    def to_json(self) -> dict:
        return {"version": self.version, "device_kind": self.device,
                "torch_version": self.torch_version, "entries": self.entries}

    @classmethod
    def from_json(cls, data: dict, device: str, source: str = "fresh") \
            -> Optional["TuningTable"]:
        """None when the file is for another schema version or another
        chip than ``device`` (a device kind): the re-sweep contract."""
        if not isinstance(data, dict):
            return None
        if data.get("version") != CACHE_VERSION:
            return None
        if data.get("device_kind") != device:
            return None
        return cls(device=data["device_kind"],
                   torch_version=str(data.get("torch_version", "")),
                   version=int(data["version"]),
                   entries=dict(data.get("entries", {})),
                   source=source)

    @classmethod
    def load(cls, path: str, device: str, source: str = "user-cache") \
            -> Optional["TuningTable"]:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        return cls.from_json(data, device, source=source)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)


def load_table(device: str, prefer_user: bool = True,
               user_path: Optional[str] = None) -> TuningTable:
    """For a device kind: the user cache if valid, else the port's default
    table if there is one, else a fresh empty table (every lookup misses:
    the kernels' default grid, the configured chunk and flush sizes, the
    batcher's probe)."""
    if prefer_user:
        t = TuningTable.load(user_path or user_cache_path(), device,
                             source="user-cache")
        if t is not None:
            return t
    t = TuningTable.load(default_table_path(), device,
                         source="default-table")
    if t is not None:
        return t
    return TuningTable(device=device)


# ------------------------------------------------------------- measurement

def _wall_timer(fn: Callable[[], object], device: torch.device,
                label=None, reps: int = 3, telemetry=None) -> float:
    """The sweep clock: wall seconds of a finished result, best of ``reps``
    after a warm call, the device synchronised before the clock starts and
    after the call (on the CPU nothing is).  When a Telemetry is supplied
    the best time also lands in its ``kernel.<label[0]>_us`` histogram, the
    histogram kernel timing writes."""
    fn()                                               # warm (first launch)
    best = float("inf")
    for _ in range(max(1, reps)):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    if telemetry is not None and getattr(telemetry, "enabled", False) \
            and label:
        telemetry.histogram(f"kernel.{label[0]}_us", best * 1e6)
    return best


def _make_timer(timer, telemetry, reps: int, device: torch.device):
    """-> timer(fn, label) -> seconds.  ``label`` is ``(entry, knob,
    value)`` so an injected fake timer can be a pure function of the
    config."""
    if timer is not None:
        return timer
    return lambda fn, label=None: _wall_timer(fn, device, label=label,
                                              reps=reps, telemetry=telemetry)


def _ramp(p: int, period: int, device) -> torch.Tensor:
    """(p,) f32 ``(i % period) / period``: cheap, deterministic, and not a
    constant (values do not matter to the timing)."""
    i = torch.arange(int(p), dtype=torch.int32, device=device)
    i.remainder_(period)
    return i.to(torch.float32).div_(float(period))


# ------------------------------------------------------------- prediction

def predict_agg_seconds(entry: str, p: int, k: int, dtype) -> float:
    """The least time one entry point could take on an H100, from the
    spec-sheet HBM3 bandwidth and f32 rate (kernels/_common.py): max(bytes
    once over HBM, operations over the f32 rate), for K rows in ``dtype``
    and the f32 global the server passes."""
    item = torch.empty((), dtype=_torch_dtype(dtype)).element_size()
    rows, g = k * p * item, 4 * p
    if entry == "weighted_aggregate":
        nbytes = 4 * k + rows + g + g                   # read K+1, write 1
        flops = 2.0 * k * p + 3.0 * p
    elif entry in ("similarity_partials", "similarity_partials_from_params"):
        nbytes = rows + g + 16 * k
        flops = 5.0 * k * p + 2.0 * p
    else:  # the fused hot path: both passes over the buffer
        nbytes = 2 * (rows + g) + g + 16 * k
        flops = 7.0 * k * p + 5.0 * p
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def predict_from_cost(fn: Callable, *args) -> Optional[float]:
    """The counterpart of the JAX package's ``predict_from_hlo``: run
    ``fn(*args)`` once under the op cost model (``launch/op_cost.py``) and
    put its FLOPs and materialised bytes through the reference's roofline
    terms (2x the bytes over HBM, the FLOPs over the f32 rate; the H100's
    spec-sheet rates).  The seconds an eager run of ``fn`` would need at
    those rates, not a bound on a fused kernel; None when the call costs
    nothing."""
    from repro_torch.launch.op_cost import analyze_step
    cost = analyze_step(fn, *args)
    t = max(2.0 * cost["hbm_bytes"] / HBM_BYTES_PER_S,
            cost["flops"] / F32_FLOPS_PER_S)
    return t if t > 0 else None


def partials_drift(tuned: torch.Tensor, default: torch.Tensor) -> dict:
    """How far (K, 4) Eq. (5) partials at another grid move from the
    default grid's, the largest over the K rows: the plain relative change
    of d.g, |d|^2 and |g|^2, and the change of each row's cosine, what
    Eq. (5) makes of the three (computed here in f64).

    ``GRID_BOUND`` holds |d|^2, |g|^2 and the cosine.  d.g is read, not
    bounded: on rows near the global it cancels to a small fraction of
    sqrt(|d|^2 |g|^2), and its relative change then measures that
    cancellation, not the kernel."""
    a, b = tuned.double(), default.double()
    rel = ((a[:, :3] - b[:, :3]).abs()
           / b[:, :3].abs().clamp_min(1e-30)).amax(0)
    cos = [cosine_from_partials(x[:, 0], x[:, 1], x[:, 2]) for x in (a, b)]
    return {"d.g": float(rel[0]), "|d|^2": float(rel[1]),
            "|g|^2": float(rel[2]),
            "cosine": float((cos[0] - cos[1]).abs().max())}


# ------------------------------------------------------------- agg sweeps

def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, dtype_name(dtype))


def _agg_inputs(p: int, k: int, dtype, device):
    """The server's call at this shape: K rows in ``dtype``, an f32
    global, uniform weights, unit sizes, zero staleness."""
    g = _ramp(p, 97, device)
    offs = torch.arange(k, dtype=torch.float32, device=device)[:, None]
    stacked = (g[None, :] * 0.5 + offs * 0.01).to(_torch_dtype(dtype))
    return {"g": g, "stacked": stacked,
            "weights": torch.full((k,), 1.0 / k, dtype=torch.float32,
                                  device=device),
            "sizes": np.ones((k,), np.float32),
            "stale": np.zeros((k,), np.float32)}


def _plain_fused(g, stacked, sizes, stale):
    """The plain twin of the fused hot path (ref.py's two passes)."""
    part = ref.similarity_partials_from_params_ref(stacked, g)
    w = ops._weights_from_partials(part, sizes, stale, 3.0, 1.0, 10.0,
                                   True, True)
    return ref.weighted_agg_ref(w, stacked, g, 0.8), w


def _agg_call(entry: str, inputs: dict, block_p: Optional[int] = None,
              oracle: bool = False):
    """Zero-arg callable running one entry point at one grid, or its plain
    twin (``oracle=True``).  The fused entry runs undecorated, so kernel
    timing, if installed, records nothing for the sweep's calls."""
    bp = DEFAULT_BLOCK_P if block_p is None else int(block_p)
    g, stacked, w = inputs["g"], inputs["stacked"], inputs["weights"]
    sizes, stale = inputs["sizes"], inputs["stale"]
    if entry == "similarity_partials":
        if oracle:
            return lambda: ref.similarity_partials_ref(stacked, g)
        return lambda: ops.similarity_partials(stacked, g, block_p=bp)
    if entry == "similarity_partials_from_params":
        if oracle:
            return lambda: ref.similarity_partials_from_params_ref(stacked, g)
        return lambda: ops.similarity_partials_from_params(stacked, g,
                                                           block_p=bp)
    if entry == "weighted_aggregate":
        if oracle:
            return lambda: ref.weighted_agg_ref(w, stacked, g, 0.8)
        return lambda: ops.weighted_aggregate(w, stacked, g, 0.8, block_p=bp)
    if entry == "seafl_aggregate_flat_from_params":
        if oracle:
            return lambda: _plain_fused(g, stacked, sizes, stale)
        fused = ops.seafl_aggregate_flat_from_params.__wrapped__
        return lambda: fused(g, stacked, sizes, stale, 3.0, 1.0, 10.0, 0.8,
                             block_p=bp)
    raise ValueError(f"unknown agg entry point {entry!r}")


def sweep_agg_entry(entry: str, p: int, k: int, dtype="float32", *,
                    candidates=None, timer=None, telemetry=None,
                    device=None, reps: int = 3) -> dict:
    """Time every ``block_p`` candidate (the default always among them)
    and the plain twin for one entry point on ``device`` (``None`` is the
    card); return the winning grid with its measured-vs-predicted ratio.

    ``candidates`` defaults to ``BLOCK_P_CANDIDATES`` on CUDA and to the
    default alone on the CPU, where every grid is the same plain call.  No
    candidate is caught: a kernel that fails to launch is a fault, not a
    slow candidate.  Deterministic given ``timer``."""
    if entry not in AGG_ENTRY_POINTS:
        raise ValueError(f"unknown agg entry point {entry!r} "
                         f"(expected one of {AGG_ENTRY_POINTS})")
    dev = resolve_device(device)
    if candidates is None:
        candidates = (BLOCK_P_CANDIDATES if dev.type == "cuda"
                      else (DEFAULT_BLOCK_P,))
    clock = _make_timer(timer, telemetry, reps, dev)
    inputs = _agg_inputs(int(p), int(k), dtype, dev)
    cand_s: dict[int, float] = {}
    for bp in dict.fromkeys((DEFAULT_BLOCK_P, *candidates)):
        cand_s[int(bp)] = float(clock(
            _agg_call(entry, inputs, block_p=bp),
            (entry, "block_p", int(bp))))
    oracle_s = float(clock(_agg_call(entry, inputs, oracle=True),
                           (entry, "oracle", None)))
    del inputs
    best_bp = min(cand_s, key=lambda b: (cand_s[b], b))
    best_s = cand_s[best_bp]
    predicted = predict_agg_seconds(entry, int(p), int(k), dtype)
    return {
        "kind": "agg", "entry": entry, "p": int(p), "k": int(k),
        "dtype": dtype_name(dtype), "device": device_kind(dev),
        "use_oracle": False, "oracle_faster": bool(oracle_s < best_s),
        "block_p": int(best_bp),
        "default_us": round(cand_s[DEFAULT_BLOCK_P] * 1e6, 3),
        "tuned_us": round(best_s * 1e6, 3),
        "oracle_us": round(oracle_s * 1e6, 3),
        "candidates_us": {str(b): round(s * 1e6, 3)
                          for b, s in sorted(cand_s.items())},
        "predicted_us": round(predicted * 1e6, 3),
        "measured_vs_predicted": round(best_s / predicted, 3)
        if predicted > 0 else None,
    }


# ----------------------------------------------------------- codec sweeps

def sweep_codec(spec: str, p: int, *, candidates=CHUNK_ELEMS_CANDIDATES,
                timer=None, telemetry=None, device=None,
                reps: int = 3) -> dict:
    """Time an encode+decode round trip of a (p,) vector on ``device``
    (``None`` is the card) at each ``chunk_elems`` candidate; the winner
    minimises the wall time."""
    scheme, _ = parse_spec(spec)
    dev = resolve_device(device)
    clock = _make_timer(timer, telemetry, reps, dev)
    vec = _ramp(p, 1003, dev)
    cand_s: dict[int, float] = {}
    for ce in candidates:
        fmt = make_wire_format(spec, chunk_elems=int(ce))

        def roundtrip(fmt=fmt):
            return decode_concat(encode_flat(vec, fmt), fmt)

        cand_s[int(ce)] = float(clock(roundtrip,
                                      (f"codec_{scheme}", "chunk_elems",
                                       int(ce))))
    best = min(cand_s, key=lambda c: (cand_s[c], c))
    return {
        "kind": "codec", "scheme": scheme, "p": int(p),
        "chunk_elems": int(best),
        "tuned_us": round(cand_s[best] * 1e6, 3),
        "candidates_us": {str(c): round(s * 1e6, 3)
                          for c, s in sorted(cand_s.items())},
    }


# ---------------------------------------------------------- ingest sweeps

def sweep_ingest(length: int, dtype="float32", *,
                 flush_candidates=FLUSH_CANDIDATES, timer=None,
                 telemetry=None, device=None, reps: int = 3) -> dict:
    """Eager per-chunk writes against one batched indexed write per flush,
    at each flush-size candidate on ``device`` (``None`` is the card): the
    generalisation of the transport module's one-shot auto-bypass probe
    (the cache-miss fallback)."""
    dev = resolve_device(device)
    clock = _make_timer(timer, telemetry, reps, dev)
    length = int(length)
    rows = 8
    scratch = UpdateBuffer(rows, param_size=length * 2,
                           dtype=_torch_dtype(dtype), device=dev)
    vals = torch.ones((length,), dtype=torch.float32, device=dev)

    def eager(n):
        def run():
            for i in range(n):
                scratch.write_range(i % rows, (i % 2) * length, vals)
            return scratch._buf
        return run

    def batched(n):
        items = [(i % rows, (i % 2) * length, vals) for i in range(n)]

        def run():
            scratch.write_batch(list(items))
            return scratch._buf
        return run

    batch_s = {int(fc): float(clock(batched(int(fc)),
                                    ("ingest_batched", "flush_chunks",
                                     int(fc))))
               for fc in flush_candidates}
    eager_s = {int(fc): float(clock(eager(int(fc)),
                                    ("ingest_eager", "flush_chunks",
                                     int(fc))))
               for fc in flush_candidates}
    # per-chunk cost decides the route: flushes land the same chunk count
    best_fc = min(batch_s, key=lambda f: (batch_s[f] / f, f))
    bypass = all(eager_s[f] < batch_s[f] for f in batch_s)
    return {
        "kind": "ingest", "length": length,
        "dtype": dtype_name(dtype),
        "bypass": bool(bypass), "flush_chunks": int(best_fc),
        "eager_us": {str(f): round(s * 1e6, 3)
                     for f, s in sorted(eager_s.items())},
        "batched_us": {str(f): round(s * 1e6, 3)
                       for f, s in sorted(batch_s.items())},
    }


# --------------------------------------------------------- server binding

_ALGO_AGG_ENTRY = {
    "seafl": "seafl_aggregate_flat_from_params",
    "seafl2": "seafl_aggregate_flat_from_params",
    "fedavg": "weighted_aggregate",
    "fedbuff": "weighted_aggregate",
    "fedasync": "weighted_aggregate",
}


@dataclass
class ServerTuning:
    """One server's view of the tuning table, resolved at construction.

    ``SeaflServer`` holds this when ``FLConfig.autotune != 'off'`` and
    consults it per aggregate call and batcher verdict: no process-global
    state, so two servers with different modes coexist and ``'off'``
    servers never see a tuner at all."""

    mode: str
    table: TuningTable
    p: int
    k: int
    dtype: str
    scheme: str
    algorithm: str
    keys: dict = field(default_factory=dict)

    @classmethod
    def build(cls, mode: str, p: int, k: int, dtype, scheme: str,
              algorithm: str, chunk_elems: int,
              flush_chunks: int, telemetry=None,
              cache_path: Optional[str] = None,
              device=None) -> "ServerTuning":
        """Resolve ``mode`` for one server on ``device`` (``None`` is the
        card): read the table, sweep what it lacks under 'sweep'."""
        dev = resolve_device(device)
        table = load_table(device_kind(dev), user_path=cache_path)
        self = cls(mode=mode, table=table, p=int(p), k=int(k),
                   dtype=dtype_name(dtype), scheme=scheme,
                   algorithm=algorithm)
        agg_entries = dict.fromkeys(
            (_ALGO_AGG_ENTRY.get(algorithm,
                                 "seafl_aggregate_flat_from_params"),
             "weighted_aggregate"))
        if mode == "sweep":
            for entry in agg_entries:
                key = make_key("agg", entry, self.dtype, None,
                               self.p, self.k, device=table.device)
                if table.get(key) is None:
                    table.put(key, sweep_agg_entry(
                        entry, self.p, self.k, self.dtype,
                        telemetry=telemetry, device=dev))
            ckey = make_key("codec", self.scheme, "float32", self.scheme,
                            self.p, 0, device=table.device)
            if table.get(ckey) is None:
                table.put(ckey, sweep_codec(self.scheme, self.p,
                                            telemetry=telemetry, device=dev))
            ce = self.chunk_elems(int(chunk_elems))
            ikey = make_key("ingest", "bypass", self.dtype, self.scheme,
                            ce, int(flush_chunks), device=table.device)
            if table.get(ikey) is None:
                table.put(ikey, sweep_ingest(ce, self.dtype,
                                             telemetry=telemetry,
                                             device=dev))
            table.save(cache_path or user_cache_path())
        for entry in agg_entries:
            self.keys[f"agg:{entry}"] = make_key(
                "agg", entry, self.dtype, None, self.p, self.k,
                device=table.device)
        self.keys[f"codec:{self.scheme}"] = make_key(
            "codec", self.scheme, "float32", self.scheme, self.p, 0,
            device=table.device)
        return self

    # -------------------------------------------------------- aggregation
    def agg_plan(self, entry: str) -> Optional[int]:
        """-> the tuned ``block_p`` for ``entry``, or None (the default
        grid).  A table's ``use_oracle`` is not read: the port routes CUDA
        tensors to the kernels only."""
        hit = self.table.lookup("agg", entry, self.dtype, None,
                                self.p, self.k)
        if hit is None:
            return None
        return int(hit.get("block_p", DEFAULT_BLOCK_P))

    # -------------------------------------------------------------- codec
    def chunk_elems(self, default: int) -> int:
        hit = self.table.lookup("codec", self.scheme, "float32",
                                self.scheme, self.p, 0)
        if hit is None or hit.get("chunk_elems") is None:
            return int(default)
        return int(hit["chunk_elems"])

    # ------------------------------------------------------------- ingest
    def ingest_verdict(self, length: int, dtype,
                       flush_chunks: int) -> Optional[bool]:
        """Cached bypass verdict for the batcher (None -> probe fallback)."""
        hit = self.table.lookup("ingest", "bypass", dtype, self.scheme,
                                int(length), int(flush_chunks))
        if hit is None or hit.get("bypass") is None:
            return None
        return bool(hit["bypass"])

    def ingest_flush_chunks(self, default: int) -> int:
        hit = self.table.lookup("ingest", "bypass", self.dtype, self.scheme,
                                self.chunk_elems(1 << 16), int(default))
        if hit is None or hit.get("flush_chunks") is None \
                or hit.get("bypass"):
            return int(default)
        return int(hit["flush_chunks"])

    def active_keys(self) -> dict:
        """The cache keys this server resolved (provenance)."""
        return dict(self.keys)


# --------------------------------------------------- default-table writer

def write_default_table(path: Optional[str] = None,
                        p_values=(1 << 14, 1 << 16, 1 << 18),
                        k_values=(2, 8), timer=None,
                        device=None) -> TuningTable:
    """Sweep the standard shapes on ``device`` (the card unless the caller
    asks for the CPU) and write the result as the port's default table.

    ``p_values`` tops out at 2^18: nearest-bucket lookup extrapolates the
    winners to larger models."""
    dev = resolve_device(device)
    table = TuningTable(device=device_kind(dev))
    for p in p_values:
        for k in k_values:
            for entry in AGG_ENTRY_POINTS:
                for dt in ("float32", "bfloat16"):
                    key = make_key("agg", entry, dt, None, p, k,
                                   device=table.device)
                    if table.get(key) is None:
                        table.put(key, sweep_agg_entry(
                            entry, p, k, dt, timer=timer, device=dev,
                            reps=2))
    for spec in ("f32", "bf16", "topk:0.1", "int8"):
        scheme, _ = parse_spec(spec)
        for p in p_values:
            key = make_key("codec", scheme, "float32", scheme, p, 0,
                           device=table.device)
            table.put(key, sweep_codec(spec, p, timer=timer, device=dev,
                                       reps=2))
        # ingest verdicts: chunk lengths from 4 Ki (the probe floor) up to
        # the largest chunk candidate, per buffer dtype x wire scheme
        for length in (1 << 12, 1 << 14, 1 << 16, 1 << 17):
            for dt in ("float32", "bfloat16"):
                swept = sweep_ingest(length, dt, timer=timer, device=dev,
                                     reps=2)
                for fc in FLUSH_CANDIDATES:
                    key = make_key("ingest", "bypass", dt, scheme,
                                   length, fc, device=table.device)
                    table.put(key, swept)
    table.save(path or default_table_path())
    return table


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-default", action="store_true",
                    help="sweep standard shapes and write the port's "
                         "default table")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    if args.write_default:
        t = write_default_table(args.out, device=args.device)
        print(f"wrote {len(t.entries)} entries "
              f"(v{CACHE_VERSION}|{t.device}) -> "
              f"{args.out or default_table_path()}")
