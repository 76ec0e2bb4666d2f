"""The port's HTML run report against the JAX package's.

``render_report`` of both gives equal HTML for the same loaded run (one
log, with a trace, with bench files, or two logs compared), and the logs
of the two trainers on the same run render with the same sections.
"""
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_monitor import _write_log  # noqa: E402

import repro.launch.train as JT  # noqa: E402
from repro.launch import report as JR  # noqa: E402
from repro_torch.launch import report as TR  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.runtime.telemetry import Telemetry  # noqa: E402


def _trace(path):
    tel = Telemetry(enabled=True)
    tel.sim_span("train", 0.0, 20.0, track="client0")
    tel.sim_span("upload", 20.0, 21.0, track="client0")
    for cid in range(1, 5):
        tel.sim_span("train", 0.0, 2.0, track=f"client{cid}")
    tel.export_chrome_trace(str(path))
    return str(path)


@pytest.mark.parametrize("case", ["plain", "alerts-bands", "trace", "bench",
                                  "compare", "truncated"])
def test_render_report_equals_jax(tmp_path, case):
    log = tmp_path / "run.jsonl"
    _write_log(str(log), alerts_at=(2, 5) if case != "plain" else (),
               band_counters=case == "alerts-bands",
               summary=case != "truncated")
    if case == "truncated":
        with open(log, "a") as fh:
            fh.write('{"event": "round", "round": 99, "sim')
    kw = {}
    if case == "trace":
        trace = _trace(tmp_path / "trace.json")
        assert TR.load_trace(trace) == JR.load_trace(trace)
        kw["busy"] = TR.load_trace(trace)
    if case == "bench":
        bench = tmp_path / "BENCH_x.json"
        bench.write_text(json.dumps({"rows": [1, 2], "name": "<x>"}))
        kw["bench_paths"] = [str(bench), str(tmp_path / "missing.json")]
    run = TR.load_run(str(log))
    assert run == JR.load_run(str(log))
    if case == "compare":
        other = tmp_path / "b.jsonl"
        _write_log(str(other), n=10, alerts_at=(3, 7))
        kw["compare"] = TR.load_run(str(other))
    doc = TR.render_report(run, **kw)
    assert doc == JR.render_report(run, **kw)
    assert doc.startswith("<!doctype html>") and doc.endswith("</html>")
    assert "http://" not in doc and "https://" not in doc
    assert "src=" not in doc


def _sections(doc):
    return [re.sub(r"—.*", "", h) for h in re.findall(r"<h2>(.*?)</h2>", doc)]


def test_the_two_trainers_logs_render_the_same_sections(monkeypatch,
                                                        tmp_path):
    """One run, once through each trainer's CLI with the monitor on, a
    byte budget that fires and a trace: both logs render, with the same
    sections, and each report names the alert."""
    docs = []
    for name, mod, extra in (("jax", JT, []),
                             ("torch", TT, ["--device", "cpu"])):
        log, trace = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json"
        monkeypatch.setattr("sys.argv", [
            "train", "--arch", "mamba2-1.3b", "--rounds", "2", "--clients",
            "4", "--concurrency", "2", "--buffer", "2", "--seq-len", "16",
            "--monitor", "on", "--byte-budget", "700000", "--log-jsonl",
            str(log), "--trace", str(trace), *extra])
        mod.main()
        run = TR.load_run(str(log))
        assert len(run["rounds"]) == 2 and run["summary"]["monitor"]
        docs.append(TR.generate(str(log), str(tmp_path / f"{name}.html"),
                                trace=str(trace)))
    assert _sections(docs[0]) == _sections(docs[1])
    assert all("byte_budget" in d and "per-client utilization" in d
               and "run-monitor alerts" in d for d in docs)


def test_report_cli(tmp_path):
    log = tmp_path / "run.jsonl"
    _write_log(str(log))
    out = tmp_path / "cli.html"
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(log),
         "--out", str(out)], env={**os.environ, "PYTHONPATH": src},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert out.read_text() == JR.render_report(JR.load_run(str(log)))
