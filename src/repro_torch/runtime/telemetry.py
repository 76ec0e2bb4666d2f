"""Process-wide telemetry: counters/gauges/histograms + span tracing.

One `Telemetry` registry is threaded through every layer of the FL stack
(server, clients, dispatch, ingest, cohorts, policy, kernels, simulator).
It is **off by default** and, when disabled, every record call is a no-op
that touches no RNG, allocates nothing observable, and changes no bytes —
the same zero-behavioral-change discipline as ``cohorts='off'``.

Three clocks coexist:

* **wall clock** — `span(...)` measures real `perf_counter` time around
  host work (client SGD steps, the upload's encode, ingest, aggregation,
  evaluation, the simulator's events) and records each span with its
  parent span's name.
* **profiler clock** — while a ``torch.profiler`` records, every
  `span(...)` also opens a ``record_function`` range named
  ``seafl.<name>`` (its attributes as the range's args), whether or not
  the registry is enabled: the profiler's trace then holds the program's
  spans and the device work they launched on one timeline.  One
  ``gc.callbacks`` hook, installed once per process, opens a
  ``host.gc`` span for each collection of Python's garbage collector in
  the registry of the span the host is in (`current`).
* **simulated clock** — `sim_span(...)` / `sim_instant(...)` take explicit
  `t0`/`t1` from `FLSimulation`'s event heap, one track per client.

Exporters:

* `snapshot()` — JSON-able metrics dict (merged into simulator history
  records and checkpoint `state_dict`s; `load_snapshot` restores it).
* `export_chrome_trace()` — Chrome-trace / Perfetto-loadable JSON with a
  simulated-time process (one thread per client + a server thread) and a
  wall-time process for host compute.
* `iter_jsonl_events()` — per-span event stream for `launch/train.py`'s
  ``--log-jsonl`` run log.
"""
from __future__ import annotations

import gc
import json
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

# pid layout of the exported trace: Perfetto renders one "process" per
# clock domain so simulated seconds never share an axis with wall seconds.
SIM_PID = 1
WALL_PID = 2

# Bound on retained spans / histogram samples so telemetry stays cheap
# enough for tier-1 tests and long simulations; overflow is counted, not
# silently dropped.
MAX_SPANS = 200_000
MAX_HIST_VALUES = 65_536

# the profiler's name of a span: ``seafl.<name>``
PROFILER_PREFIX = "seafl."


def _labels(labels: Dict[str, Any]) -> str:
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _key(name: str, labels: Dict[str, Any]) -> str:
    return f"{name}[{_labels(labels)}]" if labels else name


class _NullSpan:
    """Reusable no-op context manager for disabled telemetry."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A span that records: with its registry enabled, a wall span (and
    its ``<name>_ms`` histogram); with a profiler recording, a
    ``record_function`` range ``seafl.<name>``.  For its length its
    registry is the current one (`current`)."""

    __slots__ = ("_tel", "name", "attrs", "_t0", "_on", "_range", "_prev",
                 "_parent")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any],
                 profiled: bool):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self._range = (torch.autograd.profiler.record_function(
            PROFILER_PREFIX + name, _labels(attrs) or None)
            if profiled else None)

    def __enter__(self):
        global _current
        if self._range is not None:
            self._range.__enter__()
        tel = self._tel
        self._prev, _current = _current, tel
        self._on = tel.enabled
        if self._on:
            stack = tel._wall_stack
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _current
        tel = self._tel
        if self._on:
            t1 = time.perf_counter()
            tel._wall_stack.pop()
            tel._push_span({
                "name": self.name,
                "ph": "X",
                "pid": WALL_PID,
                "tid": 1,
                "ts": (self._t0 - tel._wall_t0) * 1e6,
                "dur": (t1 - self._t0) * 1e6,
                "args": {**self.attrs, "depth": len(tel._wall_stack),
                         "parent": self._parent},
            })
            tel.histogram(f"{self.name}_ms", (t1 - self._t0) * 1e3)
        _current = self._prev
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Telemetry:
    """Registry of counters, gauges, histograms, and trace spans.

    All mutating methods are no-ops when ``enabled`` is False; callers can
    therefore instrument hot paths unconditionally.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}
        self._spans: List[Dict[str, Any]] = []
        self._dropped_spans = 0
        self._wall_t0 = time.perf_counter()
        self._wall_stack: List[str] = []
        # simulated-clock track name -> tid (tid 1 reserved for "server")
        self._sim_tids: Dict[str, int] = {"server": 1}
        # track -> span name -> cumulative simulated busy seconds; O(1)
        # per (track, name) pair regardless of run length, so the run
        # monitor's straggler detector can read per-client utilisation
        # without walking the span list
        self._sim_busy: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------- metrics
    def counter(self, name: str, value: float = 1, **labels) -> None:
        if not self.enabled:
            return
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self._gauges[_key(name, labels)] = float(value)

    def histogram(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        vals = self._hists.setdefault(_key(name, labels), [])
        if len(vals) < MAX_HIST_VALUES:
            vals.append(float(value))
        else:
            self.counter("telemetry.hist_overflow")

    def histogram_many(self, name: str, values, **labels) -> None:
        for v in values:
            self.histogram(name, float(v), **labels)

    # --------------------------------------------------------------- spans
    def span(self, name: str, **attrs):
        """Span around host work (context manager): a wall span with the
        registry enabled, a ``seafl.<name>`` range while a profiler
        records; with neither, the shared no-op span."""
        profiled = torch.autograd._profiler_enabled()
        if not (self.enabled or profiled):
            return _NULL_SPAN
        return _Span(self, name, attrs, profiled)

    def _sim_tid(self, track: str) -> int:
        tid = self._sim_tids.get(track)
        if tid is None:
            tid = len(self._sim_tids) + 1
            self._sim_tids[track] = tid
        return tid

    def sim_span(self, name: str, t0: float, t1: float, track: str,
                 **attrs) -> None:
        """Complete span on the simulated clock (seconds in, µs stored)."""
        if not self.enabled:
            return
        busy = self._sim_busy.setdefault(track, {})
        busy[name] = busy.get(name, 0.0) + max(t1 - t0, 0.0)
        self._push_span({
            "name": name,
            "ph": "X",
            "pid": SIM_PID,
            "tid": self._sim_tid(track),
            "ts": t0 * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "args": attrs,
        })

    def sim_instant(self, name: str, t: float, track: str, **attrs) -> None:
        if not self.enabled:
            return
        self._push_span({
            "name": name,
            "ph": "i",
            "pid": SIM_PID,
            "tid": self._sim_tid(track),
            "ts": t * 1e6,
            "s": "t",
            "args": attrs,
        })

    def sim_track_busy(self) -> Dict[str, Dict[str, float]]:
        """Cumulative simulated busy seconds per track per span name
        (e.g. ``{'client3': {'train': 41.2, 'upload': 3.1}}``) — the run
        monitor's straggler-dominance input.  Not checkpointed: a restored
        run re-warms it from its own spans."""
        return {track: dict(names) for track, names in self._sim_busy.items()}

    def _push_span(self, ev: Dict[str, Any]) -> None:
        if len(self._spans) < MAX_SPANS:
            self._spans.append(ev)
        else:
            self._dropped_spans += 1

    # ----------------------------------------------------------- exporters
    def snapshot(self, compact: bool = False) -> Dict[str, Any]:
        """JSON-able metrics snapshot.

        ``compact=True`` drops raw histogram samples and keeps a bounded
        summary (count/sum/min/max/mean/p50/p95) — O(1) per histogram, the
        form merged into per-round simulator history records so long runs
        don't grow per-round records with the sample count.
        """
        hists = {}
        for k, vals in self._hists.items():
            summ: Dict[str, Any] = {
                "count": len(vals),
                "sum": sum(vals),
                "min": min(vals) if vals else None,
                "max": max(vals) if vals else None,
                "mean": (sum(vals) / len(vals)) if vals else None,
            }
            if compact:
                if vals:
                    s = sorted(vals)
                    last = len(s) - 1
                    summ["p50"] = s[min(last, int(0.50 * len(s)))]
                    summ["p95"] = s[min(last, int(0.95 * len(s)))]
                else:
                    summ["p50"] = summ["p95"] = None
            else:
                summ["values"] = list(vals)
            hists[k] = summ
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": hists,
            "spans": len(self._spans),
            "dropped_spans": self._dropped_spans,
        }

    def load_snapshot(self, snap: Dict[str, Any]) -> None:
        """Restore metrics from a `snapshot()` dict (checkpoint resume).

        Spans are trace-only and are not checkpointed; compact snapshots
        restore histogram summaries as empty sample lists.
        """
        self._counters = dict(snap.get("counters", {}))
        self._gauges = dict(snap.get("gauges", {}))
        self._hists = {k: list(v.get("values", []))
                       for k, v in snap.get("histograms", {}).items()}

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace dict (Perfetto: open via ui.perfetto.dev)."""
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": SIM_PID, "name": "process_name",
             "args": {"name": "simulated time"}},
            {"ph": "M", "pid": WALL_PID, "name": "process_name",
             "args": {"name": "wall time"}},
            {"ph": "M", "pid": WALL_PID, "tid": 1, "name": "thread_name",
             "args": {"name": "host compute"}},
        ]
        for track, tid in sorted(self._sim_tids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": SIM_PID, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
        events.extend(self._spans)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> Dict[str, Any]:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace

    def iter_jsonl_events(self) -> Iterator[str]:
        """Spans as JSONL lines (the `--log-jsonl` event stream)."""
        for ev in self._spans:
            yield json.dumps(ev)

    def reset(self) -> None:
        self.__init__(enabled=self.enabled)


# Disabled singleton: layers that receive `telemetry=None` fall back to
# this so every record site can skip `if tel is not None` checks.
NULL = Telemetry(enabled=False)


def of(tel: Optional[Telemetry]) -> Telemetry:
    return tel if tel is not None else NULL


# the registry of the innermost span the host is in that records (NULL
# outside any): code that is handed no registry, such as a client's epoch
# function, records into it
_current: Telemetry = NULL


def current() -> Telemetry:
    """The registry of the innermost recording span the host is in."""
    return _current


_gc_span: Any = _NULL_SPAN


def _on_collection(phase: str, info: Dict[str, Any]) -> None:
    """``gc.callbacks`` hook: each collection is a ``host.gc`` span (and a
    ``gc.collections`` count) of the current registry, with its
    generation; nothing while no profiler records and no span of an
    enabled registry is open."""
    global _gc_span
    try:
        if phase == "start":
            gen = info["generation"]
            _current.counter("gc.collections", generation=gen)
            _gc_span = _current.span("host.gc", generation=gen)
            _gc_span.__enter__()
        else:
            span, _gc_span = _gc_span, _NULL_SPAN
            span.__exit__(None, None, None)
    except RuntimeError:
        # the profiler was starting or stopping: a collection must not
        # raise, and the next one starts clean
        _gc_span = _NULL_SPAN


# one hook a process, added on the module's import: registries add none
gc.callbacks.append(_on_collection)
