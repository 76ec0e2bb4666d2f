"""The port's run-health monitor against the JAX package's.

The monitor is host code, so on equal records the two raise equal alerts:
the same detector, severity, round, sim time, message and evidence.  On
the tiny task with ``monitor='on'`` the two simulations hold equal event
times, contributors, ``mem_*`` fields and alerts (weights within 1e-5), an
SLO breach stops both at the same round with the same next event queued,
and ``monitor='off'`` leaves the port's history as it was.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_integration_fl import exp_cfg  # noqa: E402
from test_monitor import feed, healthy_rec  # noqa: E402
from test_torch_slice import _port_cfg, _record_events  # noqa: E402

from repro.experiment import build_experiment as jax_build  # noqa: E402
from repro.runtime import monitor as JM  # noqa: E402
from repro.runtime.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch.core.server import FLConfig, SeaflServer  # noqa: E402
from repro_torch.experiment import build_experiment  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.runtime import monitor as TM  # noqa: E402
from repro_torch.runtime.telemetry import Telemetry  # noqa: E402


def _stragglers(tel):
    """client0 owns the fleet's simulated clock; five healthy peers."""
    tel.sim_span("train", 0.0, 500.0, track="client0")
    tel.sim_span("upload", 500.0, 501.0, track="client0")
    for cid in range(1, 6):
        tel.sim_span("train", 0.0, 1.0, track=f"client{cid}")
        tel.sim_span("upload", 1.0, 1.2, track=f"client{cid}")


# (records, MonitorConfig overrides, sim spans?, the detector that fires)
STREAMS = {
    "healthy": ([healthy_rec(r) for r in range(1, 31)], {}, False, None),
    "plateau": ([healthy_rec(r, acc=0.55) for r in range(1, 21)], {}, False,
                "plateau"),
    "divergence": ([healthy_rec(r, acc=0.9 - 0.02 * r) for r in range(1, 21)],
                   {}, False, "divergence"),
    "staleness_blowup": ([healthy_rec(r) for r in range(1, 10)]
                         + [healthy_rec(10, staleness_max=50.0)], {}, False,
                         "staleness_blowup"),
    "straggler_dominance": ([healthy_rec(r) for r in range(1, 10)], {}, True,
                            "straggler_dominance"),
    "buffer_starvation": ([healthy_rec(r) for r in range(1, 9)]
                          + [healthy_rec(9, time=200.0)], {}, False,
                          "buffer_starvation"),
    "spill_pressure": ([healthy_rec(r, telemetry={"counters": {
        "buffer.spill_grow": float(r)}}) for r in range(1, 8)], {}, False,
        "spill_pressure"),
    "band_saturation": ([healthy_rec(r, telemetry={"counters": {
        "policy.band[band=1]": float(2 * r)}}) for r in range(1, 9)], {},
        False, "band_saturation"),
    "band_mix": ([healthy_rec(r, telemetry={"counters": {
        "policy.band[band=0]": float(r), "policy.band[band=1]": float(r)}})
        for r in range(1, 15)], {}, False, None),
    "byte_budget": ([healthy_rec(r) for r in range(1, 15)],
                    {"byte_budget": 10_000}, False, "byte_budget"),
    "cohort_fragmentation": ([healthy_rec(r, cohorts=12,
                                          mem_tracking_entries=12)
                              for r in range(1, 8)], {}, False,
                             "cohort_fragmentation"),
    "cohort_sharing": ([healthy_rec(r, cohorts=3, mem_tracking_entries=12)
                        for r in range(1, 15)], {}, False, None),
    "resync_storm": ([healthy_rec(r, telemetry={"counters": {
        "dispatch.resync": float(3 * r)}}) for r in range(1, 8)], {}, False,
        "resync_storm"),
    "resync_burst": ([healthy_rec(r, telemetry={"counters": {
        "dispatch.resync": 25.0 if r >= 4 else 0.0}}) for r in range(1, 12)],
        {}, False, None),
    "schedule_skew": ([healthy_rec(r, sched_max_wait=400.0 if r > 7 else 10.0,
                                   sched_policy="stragglers_last")
                       for r in range(1, 20)], {}, False, "schedule_skew"),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_detectors_raise_the_alerts_jax_raises(name):
    """Each detector's firing stream, and the healthy and near-miss ones,
    through both monitors: equal alerts, field for field, and equal
    summaries (an SLO on every severity, so the violations compare too)."""
    recs, over, spans, fires = STREAMS[name]
    out = []
    for mod, tel_cls in ((JM, JTelemetry), (TM, Telemetry)):
        tel = tel_cls(enabled=True)
        if spans:
            _stragglers(tel)
        mon = mod.RunMonitor(tel, mod.MonitorConfig(**over), slo="warn")
        fired = feed(mon, recs)
        out.append(([a.to_dict() for a in fired], mon.summary()))
    (j_alerts, j_sum), (t_alerts, t_sum) = out
    assert t_alerts == j_alerts
    assert t_sum == j_sum
    assert {a["detector"] for a in t_alerts} == ({fires} if fires else set())


SLO_CASES = [None, "", "warn", "error", "error,staleness_blowup, plateau",
             "error,warn", " , warn,", "plateau,resync_storm,schedule_skew",
             "warn,not_a_detector", "info", "byte_budget,Error"]


@pytest.mark.parametrize("spec", SLO_CASES)
def test_parse_slo_equals_jax(spec):
    def parse(mod):
        try:
            p = mod.parse_slo(spec)
        except ValueError as e:
            return "error", str(e)
        return None if p is None else (p.min_severity, p.detectors)
    assert parse(TM) == parse(JM)
    assert TM.DETECTOR_NAMES == JM.DETECTOR_NAMES
    assert dataclasses.asdict(TM.MonitorConfig()) == \
        dataclasses.asdict(JM.MonitorConfig())


def _both(algorithm, rounds, **fl_kw):
    """The tiny task in both packages from one set of initial params."""
    jc = exp_cfg(algorithm, **fl_kw)
    jsim, jmodel, _ = jax_build(jc)
    params0 = jax.tree.map(np.asarray,
                           jmodel.init(jax.random.PRNGKey(jc.seed)))
    j_events = _record_events(jsim)
    j_hist = jsim.run(max_rounds=rounds)
    tsim, _, _ = build_experiment(_port_cfg(jc), params=params0)
    t_events = _record_events(tsim)
    t_hist = tsim.run(max_rounds=rounds)
    return (jsim, j_hist, j_events), (tsim, t_hist, t_events)


@pytest.mark.parametrize("algorithm,fl_kw", [
    ("seafl", {"monitor_byte_budget": 450_000}),
    ("seafl2", {"dispatch_compression": "topk:0.1", "cohorts": "on"}),
], ids=["byte-budget-alert", "topk-downlink-cohorts"])
def test_tiny_task_with_the_monitor_replays_jax(algorithm, fl_kw):
    (jsim, j_hist, j_ev), (tsim, t_hist, t_ev) = _both(
        algorithm, 4, monitor="on", **fl_kw)
    assert len(t_hist) == len(j_hist) == 4
    for j, t in zip(j_hist, t_hist):
        assert t["time"] == j["time"]
        mem = {k: v for k, v in j.items() if k.startswith("mem_")}
        assert mem and {k: t[k] for k in mem} == mem
        assert set(t) == set(j)
        assert t.get("alerts") == j.get("alerts")
    for je, te in zip(j_ev, t_ev):
        assert te.contributors == je.contributors
        np.testing.assert_allclose(te.weights, np.asarray(je.weights),
                                   atol=1e-5)
    assert [a.to_dict() for a in tsim.server.monitor.alerts] == \
        [a.to_dict() for a in jsim.server.monitor.alerts]
    if "monitor_byte_budget" in fl_kw:
        assert tsim.server.monitor.alert_counts() == {"byte_budget": 1}


def test_slo_breach_stops_both_at_the_same_round():
    (jsim, j_hist, _), (tsim, t_hist, _) = _both(
        "seafl", 50, monitor="on", slo="byte_budget", monitor_byte_budget=1)
    assert len(t_hist) == len(j_hist) == 1
    assert tsim.server.monitor.slo_breached
    assert jsim.server.monitor.slo_breached
    assert t_hist[0]["alerts"] == j_hist[0]["alerts"]
    assert t_hist[0]["alerts"][0]["detector"] == "byte_budget"
    # the next event stays queued in both, and it is the same event
    assert tsim._heap and jsim._heap
    tn, jn = tsim._heap[0], jsim._heap[0]
    assert (tn.time, tn.kind, tn.data.get("cid")) == \
        (jn.time, jn.kind, jn.data.get("cid"))


def test_monitor_off_leaves_history_as_it_was():
    """Off is the monitor-free stack: no mem_* or alerts keys, and on only
    adds keys (telemetry, mem_*): equal times, wire bytes, RNG stream and a
    bit-identical global."""
    def run(**kw):
        jc = exp_cfg("seafl", dispatch_compression="topk:0.1", **kw)
        sim, _, _ = build_experiment(_port_cfg(jc))
        return sim, sim.run(max_rounds=4)

    off, h_off = run()
    on, h_on = run(monitor="on")
    assert off.server.monitor is None and not off.server.tel.enabled
    for a, b in zip(h_off, h_on):
        assert not any(k.startswith("mem_") or k == "alerts" for k in a)
        assert set(b) - set(a) == {"telemetry"} | {
            k for k in b if k.startswith("mem_")}
        assert all(a[k] == b[k] for k in a)
    assert torch.equal(off.server.global_flat, on.server.global_flat)
    assert (off.server.bytes_uploaded, off.server.bytes_downloaded) == \
        (on.server.bytes_uploaded, on.server.bytes_downloaded)
    assert off._rng.bit_generator.state == on._rng.bit_generator.state
    # never checkpointed: a restored server's detectors start cold
    srv = on.server
    assert "monitor" not in srv.state_dict()
    fresh = SeaflServer(srv.cfg, srv.packer.unpack(srv.global_flat),
                        dict(srv.client_sizes), device="cpu")
    fresh.load_state(srv.state_dict(), srv.checkpoint_trees())
    assert fresh.monitor is not None and fresh.monitor.alerts == []


def test_bad_slo_fails_at_construction():
    params = {"w": torch.zeros(8)}
    with pytest.raises(ValueError, match="unknown SLO token"):
        SeaflServer(FLConfig(monitor="on", slo="no_such_detector"), params,
                    {0: 1}, device="cpu")
    with pytest.raises(ValueError, match="monitor must be"):
        SeaflServer(FLConfig(monitor="maybe"), params, {0: 1}, device="cpu")


def test_cli_slo_breach_exits_non_zero(monkeypatch, tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "mamba2-1.3b", "--device", "cpu", "--rounds", "4",
        "--clients", "4", "--concurrency", "2", "--buffer", "2",
        "--seq-len", "16", "--slo", "byte_budget", "--byte-budget", "1",
        "--log-jsonl", str(log)])
    with pytest.raises(SystemExit) as exc:
        TT.main()
    assert exc.value.code == 2
    out = capsys.readouterr().out
    assert "SLO violation: round 1 byte_budget (error)" in out
    assert "ALERT[error:byte_budget]" in out and "SLO-BREACHED" in out
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["round", "summary"]
    assert recs[0]["alerts"][0]["detector"] == "byte_budget"
    assert recs[0]["mem_server_array_bytes"] > 0
    assert recs[-1]["monitor"]["slo_breached"] is True
