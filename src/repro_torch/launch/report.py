"""Offline run report: one self-contained HTML page from a JSONL run log.

Consumes the ``--log-jsonl`` stream written by `launch/train.py` — one
``round`` record per aggregation plus a final ``summary`` record — and
renders a single static HTML file with no external assets: accuracy /
wire-byte / staleness sparklines, the alert timeline from the run monitor,
the drift-band occupancy strip, per-client utilization and straggler
ranking (when a Perfetto trace is supplied), and any ``BENCH_*.json``
reports passed along.  ``--compare A B`` diffs two runs (time-to-accuracy,
bytes, alert deltas) into the same page.

The port of the JAX package's ``launch/report.py``, which it keeps line for
line: the two render equal HTML from equal logs, so a log of either
package's trainer renders here.

A truncated log from a killed run is fine: records are parsed line by line
and a partial trailing line is ignored (`JsonlLog` flushes per record, so
everything before the kill is intact).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report run.jsonl \
      --out report.html [--trace trace.json] [--bench BENCH_ingest.json ...]
  PYTHONPATH=src python -m repro_torch.launch.report --compare a.jsonl \
      b.jsonl --out diff.html
"""
from __future__ import annotations

import argparse
import html
import json
from typing import Any, Dict, List, Optional

# validated reference palette (dataviz defaults): categorical slots 1/2,
# sequential blue ramp (ordinal band >= step 250 on light), status steps.
# Light/dark pairs swap via CSS custom properties; marks wear series color,
# text wears ink tokens.
_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px 32px; background: var(--page);
  color: var(--ink); font: 14px/1.5 system-ui, -apple-system,
  "Segoe UI", sans-serif;
  --page: #f9f9f7; --surface: #fcfcfb; --ink: #0b0b0b;
  --ink-2: #52514e; --muted: #898781; --grid: #e1e0d9;
  --baseline: #c3c2b7; --border: rgba(11,11,11,0.10);
  --series-1: #2a78d6; --series-2: #eb6834;
  --warn: #fab219; --crit: #d03b3b; --good: #0ca30c;
  --band-0: #86b6ef; --band-1: #2a78d6; --band-2: #104281;
}
@media (prefers-color-scheme: dark) {
  body {
    --page: #0d0d0d; --surface: #1a1a19; --ink: #ffffff;
    --ink-2: #c3c2b7; --muted: #898781; --grid: #2c2c2a;
    --baseline: #383835; --border: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-2: #d95926;
    --band-0: #86b6ef; --band-1: #3987e5; --band-2: #184f95;
  }
}
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 28px 0 8px; color: var(--ink); }
.sub { color: var(--ink-2); margin: 0 0 20px; }
.cards { display: flex; flex-wrap: wrap; gap: 12px; }
.card {
  background: var(--surface); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 16px; min-width: 150px;
}
.card .label { color: var(--ink-2); font-size: 12px; }
.card .value { font-size: 22px; font-weight: 600; }
.card .trend { margin-top: 4px; }
.panel {
  background: var(--surface); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 16px; margin: 8px 0;
}
table { border-collapse: collapse; width: 100%; }
th {
  text-align: left; color: var(--ink-2); font-weight: 500;
  font-size: 12px; border-bottom: 1px solid var(--baseline);
  padding: 4px 10px 4px 0;
}
td {
  padding: 4px 10px 4px 0; border-bottom: 1px solid var(--grid);
  font-variant-numeric: tabular-nums;
}
.sev { display: inline-flex; align-items: center; gap: 6px; }
.dot { width: 8px; height: 8px; border-radius: 50%; display: inline-block; }
.sev-warn .dot { background: var(--warn); }
.sev-error .dot { background: var(--crit); }
.sev-info .dot { background: var(--series-1); }
.strip { display: flex; gap: 2px; }
.strip .cell {
  flex: 1; height: 14px; border-radius: 2px; min-width: 3px;
  background: var(--grid);
}
.legend { display: flex; gap: 16px; margin: 6px 0; color: var(--ink-2);
  font-size: 12px; align-items: center; }
.key { width: 14px; height: 3px; display: inline-block;
  border-radius: 2px; margin-right: 5px; vertical-align: middle; }
.ok { color: var(--good); font-weight: 600; }
.muted { color: var(--muted); }
svg text { fill: var(--ink-2); font-size: 10px; }
"""

SPARK_W, SPARK_H = 560, 64


def load_run(path: str) -> Dict[str, Any]:
    """Parse a JSONL run log into {rounds: [...], summary: {...}|None}.

    Tolerant of truncation: a partial trailing line (killed run) is
    dropped, everything parseable before it is kept.
    """
    rounds: List[dict] = []
    summary: Optional[dict] = None
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue        # torn final line of a killed run
            if rec.get("event") == "round":
                rounds.append(rec)
            elif rec.get("event") == "summary":
                summary = rec
    return {"rounds": rounds, "summary": summary, "path": path}


def _series(rounds: List[dict], key: str) -> List[Optional[float]]:
    return [r.get(key) for r in rounds]


def _per_round(cumulative: List[Optional[float]]) -> List[float]:
    out, prev = [], 0.0
    for v in cumulative:
        v = float(v or 0.0)
        out.append(max(v - prev, 0.0))
        prev = v
    return out


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "–"
    a = abs(v)
    if a >= 1e9:
        return f"{v / 1e9:.2f}G"
    if a >= 1e6:
        return f"{v / 1e6:.2f}M"
    if a >= 1e4:
        return f"{v / 1e3:.1f}K"
    if a == int(a) and a < 1e4:
        return f"{int(v):,}"
    return f"{v:.4g}"


def _spark(values: List[Optional[float]], xs: Optional[List[float]] = None,
           color: str = "var(--series-1)", width: int = SPARK_W,
           height: int = SPARK_H, unit: str = "") -> str:
    """Inline-SVG sparkline: 2px line, baseline hairline, end-dot with a
    surface ring, native-tooltip hit targets per point."""
    pts = [(i if xs is None else xs[i], float(v))
           for i, v in enumerate(values) if v is not None]
    if not pts:
        return '<span class="muted">no data</span>'
    x0, x1 = pts[0][0], pts[-1][0]
    ys = [p[1] for p in pts]
    lo, hi = min(ys), max(ys)
    pad = 6
    sx = (width - 2 * pad) / max(x1 - x0, 1e-9)
    sy = (height - 2 * pad) / max(hi - lo, 1e-9)

    def px(x):
        return pad + (x - x0) * sx

    def py(y):
        return height - pad - (y - lo) * sy

    path = " ".join(f"{'M' if i == 0 else 'L'}{px(x):.1f},{py(y):.1f}"
                    for i, (x, y) in enumerate(pts))
    ex, ey = px(pts[-1][0]), py(pts[-1][1])
    hits = "".join(
        f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" r="8" fill="transparent">'
        f"<title>{_fmt(x)}: {_fmt(y)}{unit}</title></circle>"
        for x, y in pts)
    return (
        f'<svg width="{width}" height="{height}" role="img">'
        f'<line x1="{pad}" y1="{height - pad}" x2="{width - pad}" '
        f'y2="{height - pad}" stroke="var(--baseline)" stroke-width="1"/>'
        f'<path d="{path}" fill="none" stroke="{color}" stroke-width="2" '
        f'stroke-linejoin="round" stroke-linecap="round"/>'
        f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="6" fill="var(--surface)"/>'
        f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="4" fill="{color}"/>'
        f'<text x="{width - pad}" y="12" text-anchor="end">'
        f"{_fmt(pts[-1][1])}{unit}</text>"
        f'<text x="{pad}" y="12">{_fmt(lo)}–{_fmt(hi)}{unit}</text>'
        f"{hits}</svg>")


def _band_occupancy(rounds: List[dict]) -> Optional[List[Optional[int]]]:
    """Dominant drift band per round from the cumulative ``policy.band``
    counters riding each record's compact telemetry snapshot (None for
    rounds with no band decisions)."""
    prev: Dict[str, float] = {}
    out: List[Optional[int]] = []
    saw_any = False
    for r in rounds:
        counters = (r.get("telemetry") or {}).get("counters", {})
        cur = {k: v for k, v in counters.items()
               if k.startswith("policy.band[")}
        delta = {k: v - prev.get(k, 0.0) for k, v in cur.items()}
        prev = cur
        live = {k: d for k, d in delta.items() if d > 0}
        if live:
            saw_any = True
            top = max(live, key=lambda k: live[k])
            out.append(int(top.split("band=")[1].rstrip("]")))
        else:
            out.append(None)
    return out if saw_any else None


def _band_strip_html(bands: List[Optional[int]]) -> str:
    nb = max((b for b in bands if b is not None), default=0) + 1
    cells = []
    for i, b in enumerate(bands):
        if b is None:
            style, tip = "", f"round {i + 1}: no band decision"
        else:
            var = f"--band-{min(b, 2)}"
            style = f' style="background:var({var})"'
            tip = f"round {i + 1}: band {b}"
        cells.append(f'<div class="cell" title="{tip}"{style}></div>')
    keys = "".join(
        f'<span><span class="key" '
        f'style="background:var(--band-{min(b, 2)})"></span>band {b}</span>'
        for b in range(nb))
    return (f'<div class="strip">{"".join(cells)}</div>'
            f'<div class="legend">{keys}'
            f'<span><span class="key" style="background:var(--grid)"></span>'
            f"no decision</span></div>")


def _alerts_of(run: Dict[str, Any]) -> List[dict]:
    out = []
    for r in run["rounds"]:
        out.extend(r.get("alerts", ()))
    return out


def _alert_section(run: Dict[str, Any]) -> str:
    alerts = _alerts_of(run)
    n = len(run["rounds"])
    if not alerts:
        return ('<div class="panel"><span class="ok">✓ healthy</span> '
                "— the run monitor raised no alerts"
                f" over {n} rounds.</div>")
    by_round: Dict[int, str] = {}
    for a in alerts:
        sev = a.get("severity", "warn")
        if by_round.get(a["round"]) != "error":
            by_round[a["round"]] = sev
    cells = []
    for i in range(1, n + 1):
        sev = by_round.get(i)
        if sev is None:
            cells.append(f'<div class="cell" title="round {i}: ok"></div>')
        else:
            var = "--crit" if sev == "error" else "--warn"
            cells.append(f'<div class="cell" title="round {i}: {sev}" '
                         f'style="background:var({var})"></div>')
    rows = "".join(
        f'<tr><td>{a["round"]}</td>'
        f'<td><span class="sev sev-{a.get("severity", "warn")}">'
        f'<span class="dot"></span>{a.get("severity", "warn")}</span></td>'
        f'<td>{html.escape(a.get("detector", "?"))}</td>'
        f'<td>{html.escape(a.get("message", ""))}</td></tr>'
        for a in alerts)
    return (f'<div class="panel"><div class="strip">{"".join(cells)}</div>'
            '<table style="margin-top:10px"><tr><th>round</th>'
            "<th>severity</th><th>detector</th><th>message</th></tr>"
            f"{rows}</table></div>")


def load_trace(path: str) -> Dict[str, Dict[str, float]]:
    """Per-track busy seconds by span name from a Perfetto/Chrome trace
    (simulated-time process only)."""
    with open(path, encoding="utf-8") as fh:
        trace = json.load(fh)
    events = trace.get("traceEvents", [])
    names = {ev.get("tid"): ev["args"]["name"] for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"
             and ev.get("pid") == 1}
    busy: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("pid") != 1:
            continue
        track = names.get(ev.get("tid"), f"tid{ev.get('tid')}")
        d = busy.setdefault(track, {})
        d[ev["name"]] = d.get(ev["name"], 0.0) + ev.get("dur", 0.0) / 1e6
    return busy


def _utilization_section(busy: Dict[str, Dict[str, float]],
                         span_s: float) -> str:
    clients = {t: s for t, s in busy.items() if t.startswith("client")}
    if not clients:
        return '<div class="panel muted">no client tracks in trace</div>'
    work = {t: s.get("train", 0.0) + s.get("upload", 0.0)
            for t, s in clients.items()}
    total = sum(work.values()) or 1e-9
    med = sorted(work.values())[len(work) // 2]
    rows = []
    for t, w in sorted(work.items(), key=lambda kv: -kv[1]):
        s = clients[t]
        util = w / span_s if span_s > 0 else 0.0
        flag = (' <span class="sev sev-warn"><span class="dot"></span>'
                "straggler</span>"
                if med > 0 and w > 4.0 * med else "")
        rows.append(
            f"<tr><td>{html.escape(t)}</td>"
            f'<td>{s.get("train", 0.0):.1f}</td>'
            f'<td>{s.get("upload", 0.0):.1f}</td>'
            f'<td>{s.get("dispatch", 0.0):.1f}</td>'
            f"<td>{util:.0%}</td>"
            f"<td>{w / total:.1%}{flag}</td></tr>")
    return ('<div class="panel"><table><tr><th>client</th>'
            "<th>train s</th><th>upload s</th><th>dispatch s</th>"
            "<th>busy / run</th><th>share of fleet work</th></tr>"
            f'{"".join(rows)}</table></div>')


def _bench_section(paths: List[str]) -> str:
    parts = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as fh:
                rep = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            parts.append(f'<div class="panel muted">'
                         f"{html.escape(p)}: unreadable ({e})</div>")
            continue
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(json.dumps(v)[:160])}</td></tr>"
            for k, v in (rep.items() if isinstance(rep, dict) else
                         enumerate(rep)))
        parts.append(f"<h2>bench: {html.escape(p)}</h2>"
                     f'<div class="panel"><table>{rows}</table></div>')
    return "".join(parts)


def _cards(run: Dict[str, Any]) -> str:
    rounds = run["rounds"]
    summ = run["summary"] or {}
    last = rounds[-1] if rounds else {}
    ces = [r["heldout_ce"] for r in rounds if r.get("heldout_ce") is not None]
    alerts = _alerts_of(run)
    mon = summ.get("monitor", {})
    cards = [
        ("rounds", _fmt(len(rounds)), ""),
        ("sim time", _fmt(last.get("sim_time")) + "s", ""),
        ("best held-out CE", _fmt(min(ces) if ces else None),
         _spark(ces, color="var(--series-1)", width=120, height=28)),
        ("uplink bytes", _fmt(summ.get("uplink_bytes",
                                       last.get("uplink_bytes"))), ""),
        ("downlink bytes", _fmt(summ.get("downlink_bytes",
                                         last.get("downlink_bytes"))), ""),
        ("alerts", _fmt(len(alerts)),
         '<span class="ok">SLO ok</span>'
         if not mon.get("slo_breached")
         else '<span class="sev sev-error"><span class="dot"></span>'
              "SLO breached</span>"),
    ]
    return '<div class="cards">' + "".join(
        f'<div class="card"><div class="label">{label}</div>'
        f'<div class="value">{value}</div>'
        f'<div class="trend">{trend}</div></div>'
        for label, value, trend in cards) + "</div>"


def _run_sections(run: Dict[str, Any],
                  busy: Optional[Dict[str, Dict[str, float]]]) -> str:
    rounds = run["rounds"]
    xs = [float(r.get("sim_time", i + 1)) for i, r in enumerate(rounds)]
    out = [_cards(run)]
    ce = _series(rounds, "heldout_ce")
    if any(v is not None for v in ce):
        out.append("<h2>held-out cross-entropy over simulated time</h2>"
                   f'<div class="panel">{_spark(ce, xs)}</div>')
    up = _series(rounds, "uplink_bytes")
    if any(v is not None for v in up):
        out.append(
            "<h2>wire bytes per round</h2>"
            '<div class="panel"><div class="legend">'
            '<span><span class="key" style="background:var(--series-1)">'
            "</span>uplink</span>"
            '<span><span class="key" style="background:var(--series-2)">'
            "</span>downlink</span></div>"
            f"{_spark(_per_round(up), xs)}<br>"
            f"{_spark(_per_round(_series(rounds, 'downlink_bytes')), xs, color='var(--series-2)')}"
            "</div>")
    out.append("<h2>max staleness per round</h2>"
               f'<div class="panel">'
               f'{_spark(_series(rounds, "staleness_max"), xs)}</div>')
    elig = _series(rounds, "eligible")
    if any(v is not None for v in elig):
        # availability/scheduler layer on: online fleet size + dispatches
        # parked for offline clients, per round (schedule_skew alerts, if
        # any, appear in the run-monitor alert timeline below)
        out.append(
            "<h2>participation: eligible fleet &amp; deferred "
            "dispatches</h2>"
            '<div class="panel"><div class="legend">'
            '<span><span class="key" style="background:var(--series-1)">'
            "</span>eligible clients</span>"
            '<span><span class="key" style="background:var(--series-2)">'
            "</span>deferred dispatches</span></div>"
            f"{_spark(elig, xs)}<br>"
            f"{_spark(_series(rounds, 'deferred'), xs, color='var(--series-2)')}"
            "</div>")
    mem = _series(rounds, "mem_server_array_bytes")
    if any(v is not None for v in mem):
        out.append("<h2>server-resident array bytes</h2>"
                   f'<div class="panel">{_spark(mem, xs, unit="B")}</div>')
    bands = _band_occupancy(rounds)
    out.append("<h2>drift-band occupancy</h2>")
    if bands is None:
        out.append('<div class="panel muted">no adaptive rate policy '
                   "decisions in this run (dispatch_ratio_policy="
                   "'static' or no telemetry snapshot)</div>")
    else:
        out.append(f'<div class="panel">{_band_strip_html(bands)}</div>')
    out.append("<h2>run-monitor alerts</h2>")
    out.append(_alert_section(run))
    if busy is not None:
        span_s = xs[-1] if xs else 0.0
        out.append("<h2>per-client utilization (simulated clock)</h2>")
        out.append(_utilization_section(busy, span_s))
    return "".join(out)


def _time_to_ce(rounds: List[dict], target: float) -> Optional[float]:
    for r in rounds:
        ce = r.get("heldout_ce")
        if ce is not None and ce <= target:
            return float(r.get("sim_time", 0.0))
    return None


def _compare_section(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    def best_ce(run):
        ces = [r["heldout_ce"] for r in run["rounds"]
               if r.get("heldout_ce") is not None]
        return min(ces) if ces else None

    ca, cb = best_ce(a), best_ce(b)
    target = max(v for v in (ca, cb) if v is not None) \
        if (ca is not None or cb is not None) else None
    rows = [
        ("rounds", len(a["rounds"]), len(b["rounds"])),
        ("final sim time (s)",
         (a["rounds"][-1].get("sim_time") if a["rounds"] else None),
         (b["rounds"][-1].get("sim_time") if b["rounds"] else None)),
        ("best held-out CE", ca, cb),
        (f"sim s to CE ≤ {target:.4g}" if target is not None
         else "sim s to common CE",
         _time_to_ce(a["rounds"], target) if target is not None else None,
         _time_to_ce(b["rounds"], target) if target is not None else None),
        ("uplink bytes",
         (a["summary"] or {}).get("uplink_bytes"),
         (b["summary"] or {}).get("uplink_bytes")),
        ("downlink bytes",
         (a["summary"] or {}).get("downlink_bytes"),
         (b["summary"] or {}).get("downlink_bytes")),
        ("alerts", len(_alerts_of(a)), len(_alerts_of(b))),
    ]
    body = "".join(
        f"<tr><td>{html.escape(str(metric))}</td><td>{_fmt(va)}</td>"
        f"<td>{_fmt(vb)}</td>"
        f"<td>{_fmt(vb - va) if (va is not None and vb is not None) else '–'}"
        "</td></tr>"
        for metric, va, vb in rows)
    det: Dict[str, List[int]] = {}
    for i, run in enumerate((a, b)):
        for al in _alerts_of(run):
            det.setdefault(al.get("detector", "?"), [0, 0])[i] += 1
    det_rows = "".join(
        f"<tr><td>{html.escape(d)}</td><td>{na}</td><td>{nb}</td>"
        f"<td>{nb - na:+d}</td></tr>"
        for d, (na, nb) in sorted(det.items())) or \
        '<tr><td colspan="4" class="muted">no alerts in either run</td></tr>'
    pa = html.escape(a["path"])
    pb = html.escape(b["path"])
    return (
        f"<h2>A/B diff — A = {pa}, B = {pb}</h2>"
        f'<div class="panel"><table><tr><th>metric</th><th>A</th>'
        f"<th>B</th><th>B − A</th></tr>{body}</table></div>"
        "<h2>alert deltas by detector</h2>"
        f'<div class="panel"><table><tr><th>detector</th><th>A</th>'
        f"<th>B</th><th>Δ</th></tr>{det_rows}</table></div>")


def render_report(run: Dict[str, Any],
                  busy: Optional[Dict[str, Dict[str, float]]] = None,
                  bench_paths: Optional[List[str]] = None,
                  compare: Optional[Dict[str, Any]] = None) -> str:
    title = ("SEAFL run comparison" if compare is not None
             else "SEAFL run report")
    body = [f"<h1>{title}</h1>",
            f'<p class="sub">{html.escape(run["path"])}'
            + (f' vs {html.escape(compare["path"])}'
               if compare is not None else "") + "</p>"]
    if compare is not None:
        body.append(_compare_section(run, compare))
        body.append(f"<h2>run A — {html.escape(run['path'])}</h2>")
        body.append(_run_sections(run, None))
        body.append(f"<h2>run B — {html.escape(compare['path'])}</h2>")
        body.append(_run_sections(compare, None))
    else:
        body.append(_run_sections(run, busy))
    if bench_paths:
        body.append(_bench_section(bench_paths))
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{title}</title><style>{_CSS}</style></head>"
            f'<body>{"".join(body)}</body></html>')


def generate(log_path: str, out_path: str, trace: Optional[str] = None,
             bench: Optional[List[str]] = None,
             compare_with: Optional[str] = None) -> str:
    """Render a report (or an A/B comparison) to ``out_path``; returns the
    HTML string (tests assert on it directly)."""
    run = load_run(log_path)
    busy = load_trace(trace) if trace else None
    cmp_run = load_run(compare_with) if compare_with else None
    doc = render_report(run, busy=busy, bench_paths=bench, compare=cmp_run)
    with open(out_path, "w", encoding="utf-8") as fh:
        fh.write(doc)
    return doc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log", nargs="?", default=None,
                    help="JSONL run log (from --log-jsonl)")
    ap.add_argument("--out", default="run_report.html")
    ap.add_argument("--trace", default=None,
                    help="Perfetto/Chrome trace JSON for the per-client "
                         "utilization table")
    ap.add_argument("--bench", action="append", default=[],
                    metavar="BENCH.json",
                    help="append a BENCH_*.json report table (repeatable)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                    help="diff two JSONL run logs instead of reporting one")
    args = ap.parse_args()
    if args.compare is not None:
        a, b = args.compare
        generate(a, args.out, bench=args.bench, compare_with=b)
    elif args.log is not None:
        generate(args.log, args.out, trace=args.trace, bench=args.bench)
    else:
        ap.error("give a run log or --compare A B")
    print(f"[report] wrote {args.out}")


if __name__ == "__main__":
    main()
