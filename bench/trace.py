"""Spans and the device trace of a traced run (``--trace 1``).

The benchmark's own spans wrap, on the instances, the public calls the
simulator makes into the program: a client's ``local_train``, the upload's
encode (``encode_update``: the client's encoder, which the simulator runs
on the server object), the server's ingest, dispatch and aggregation, and
the evaluation.  Each
span is a ``torch.profiler.record_function`` range, so the profiler's trace
holds the host's spans and the device's work on one clock.

``reduce_trace`` turns the profiler's events over the traced stretch into
the record the per-layer metrics read (``bench/metrics``): the stretch,
every device activity (kernels, copies, fills) with the host time of its
launch, and the host ranges (the benchmark's spans and the program's own
named ranges).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

PREFIX = "bench."
STRETCH = PREFIX + "stretch"
# the program's own named ranges that metrics read
PROGRAM_RANGES = ("ssd_chunked_backward", "flash_attention_backward")
# the device activities that are work (not the ranges kineto mirrors onto
# the device's timeline)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")

SERVER_CALLS = ("ingest_payload", "begin_ingest", "finish_ingest",
                "dispatch_model", "encode_dispatch", "deliver_dispatch")


def span(name: str, fn):
    """``fn`` inside a profiler range named ``bench.<name>``."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.profiler.record_function(PREFIX + name):
            return fn(*args, **kw)
    return wrapped


def instrument(fed) -> None:
    """Wrap the federation's client, server and evaluation calls in spans
    (on the instances: the program's classes are untouched)."""
    for c in fed.clients.values():
        c.local_train = span("client.local_train", c.local_train)
    srv = fed.server
    for name in SERVER_CALLS:
        setattr(srv, name, span(f"server.{name}", getattr(srv, name)))
    srv.encode_update = span("encode", srv.encode_update)
    if fed.sim.eval_fn is not None:
        fed.sim.eval_fn = span("eval", fed.sim.eval_fn)


@dataclass
class Record:
    """What a traced stretch of whole rounds left: times in ns on the
    profiler's clock."""
    start: int
    end: int
    device: list = field(default_factory=list)   # (name, t0, t1, launch_ns)
    ranges: list = field(default_factory=list)   # (name, t0, t1)
    counts: dict = field(default_factory=dict)
    cell: dict = field(default_factory=dict)
    peak_bytes: int = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self, *patterns: str) -> list:
        return [d for d in self.device
                if any(p in d[0] for p in patterns)]

    def device_s(self, acts=None) -> float:
        """Summed device time of ``acts`` (default: all)."""
        acts = self.device if acts is None else acts
        return sum(t1 - t0 for _, t0, t1, _ in acts) / 1e9

    def busy_intervals(self) -> list:
        return union((t0, t1) for _, t0, t1, _ in self.device)

    def host_s(self, prefix: str) -> float:
        """Seconds of the stretch inside ranges whose name starts with
        ``prefix`` (overlaps counted once)."""
        return sum(b - a for a, b in union(
            (t0, t1) for n, t0, t1 in self.ranges
            if n.startswith(prefix))) / 1e9

    def launched_in(self, range_name: str, acts=None) -> list:
        """The device activities launched from inside a host range named
        ``range_name``."""
        spans = union((t0, t1) for n, t0, t1 in self.ranges
                      if n == range_name)
        acts = self.device if acts is None else acts
        return [d for d in acts
                if d[3] is not None and _inside(d[3], spans)]

    def count(self, name: str) -> int:
        """Host ranges named ``bench.<name>`` that lie in the stretch."""
        return sum(1 for n, _, _ in self.ranges if n == PREFIX + name)


def union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(t, spans) -> bool:
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][1] < t:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(spans) and spans[lo][0] <= t <= spans[lo][1]


def is_work(e, mirrored: set) -> bool:
    """Whether a device event is work (a kernel, a copy or a fill) and not
    a host range that kineto mirrors onto the device's timeline (named as
    a host event is)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return False
    return e.name() not in mirrored


def reduce_trace(prof) -> Record:
    """The stretch's record from a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    host_at, ranges, device, stretch = {}, [], [], None
    host_names = set()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host_names.add(e.name())
            # a host op: a device activity's linked id names the op that
            # launched it
            if e.linked_correlation_id() == 0:
                host_at.setdefault(e.correlation_id(), e.start_ns())
            name = e.name()
            if name == STRETCH:
                stretch = (e.start_ns(), e.end_ns())
            elif name.startswith(PREFIX) or name in PROGRAM_RANGES:
                ranges.append((name, e.start_ns(), e.end_ns()))
    if stretch is None:
        raise RuntimeError("the trace holds no stretch range")
    s0, s1 = stretch
    for e in events:
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or not is_work(e, host_names)):
            continue
        t0, t1 = max(e.start_ns(), s0), min(e.end_ns(), s1)
        if t1 <= t0:
            continue
        device.append((e.name(), t0, t1,
                       host_at.get(e.linked_correlation_id())))
    ranges = [(n, max(a, s0), min(b, s1)) for n, a, b in ranges
              if min(b, s1) > max(a, s0)]
    return Record(start=s0, end=s1, device=device, ranges=ranges)


def breakdown(rec: Record, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost span the host was in
    when the gap began."""
    by_name: dict[str, float] = {}
    for name, t0, t1, _ in rec.device:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = rec.busy_intervals()
    edges = [rec.start] + [x for iv in busy for x in iv] + [rec.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        inner = [r for r in rec.ranges
                 if r[0].startswith(PREFIX) and r[1] <= a <= r[2]]
        label = (max(inner, key=lambda r: r[1])[0][len(PREFIX):]
                 if inner else "simulator")
        named.append([label, (b - a) / 1e9])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": named}
