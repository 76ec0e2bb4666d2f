"""The slice as a whole: the port's simulation replays the JAX package's on
the integration workload (``test_integration_fl.exp_cfg``: tiny task, mlp,
16 clients) from the same initial params.

Held equal: event times, contributors (an edge partial's merged ones
included), staleness and dispatch lists of every aggregation, the bytes up
and down, and under a version-tracked downlink the full/delta/resync
counts, the encode cache's counters and the ratio each dispatch shipped
at.  Held close: aggregation weights (<= 1e-5) and accuracy (within
0.02); training runs in another framework, so params differ in the last
f32 bits and the weights' cosine terms with them.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_integration_fl import exp_cfg  # noqa: E402
from test_torch_dispatch import watch_decisions  # noqa: E402

from repro.data.partition import dirichlet_partition as jax_partition  # noqa: E402
from repro.data.synthetic import make_image_dataset as jax_dataset  # noqa: E402
from repro.experiment import build_experiment as jax_build  # noqa: E402
from repro.runtime.scheduler import make_scheduler as jax_scheduler  # noqa: E402
from repro_torch.core.server import FLConfig, SeaflServer  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.experiment import ExperimentConfig, build_experiment  # noqa: E402
from repro_torch.runtime.scheduler import make_scheduler  # noqa: E402
from repro_torch.runtime.simulator import SimConfig  # noqa: E402

ROUNDS = 4


def _record_events(sim):
    events = []
    agg = sim.server._aggregate

    def wrapped(now):
        ev = agg(now)
        events.append(ev)
        return ev

    sim.server._aggregate = wrapped
    return events


# the port's own spans (each a ``<name>_ms`` histogram) and counts, which
# the JAX package does not record (runtime/telemetry.py)
PORT_SPANS = {"client.local_train", "client.batches", "client.step",
              "client.forward", "client.backward", "client.update",
              "client.loss_sync", "encode", "encode.pack", "encode.chunks",
              "ingest", "ingest.write", "ingest.commit", "dispatch.model",
              "sim.eval", "host.gc"} | {
    f"sim.{kind}" for kind in ("upload", "arrive", "deliver", "notify",
                               "fail", "recover", "avail_off", "avail_on")}
PORT_COUNTS = {"client.sgd_steps", "client.tokens", "sim.evals",
               "encode.chunks", "encode.bytes", "gc.collections"}


def _port_only(kind: str, key: str) -> bool:
    if kind == "histograms":
        return key.removesuffix("_ms") in PORT_SPANS
    return kind == "counters" and key.split("[")[0] in PORT_COUNTS


def _port_cfg(jc):
    return ExperimentConfig(
        dataset=jc.dataset, model=jc.model, n_train=jc.n_train,
        n_test=jc.n_test, dirichlet_alpha=jc.dirichlet_alpha,
        fl=FLConfig(**dataclasses.asdict(jc.fl)),
        sim=SimConfig(**dataclasses.asdict(jc.sim)), eval_every=jc.eval_every,
        seed=jc.seed, device="cpu")


CHURN = dict(fail_prob=0.2, recover_after=5.0, availability="longtail",
             avail_mean_on=20.0, avail_mean_off=5.0, bandwidth_model="pareto")
# the downlink's bytes and encode cost move the event times
WIRE = dict(bandwidth_model="pareto", encode_mbps=400.0, fail_prob=0.1,
            recover_after=5.0)


@pytest.mark.parametrize("algorithm,fl_kw,sim_kw", [
    ("seafl", {}, {}), ("fedasync", {}, {}), ("seafl2", {}, {}),
    ("fedbuff", {}, {}), ("fedavg", {}, {}),
    ("seafl", {"buffer_dtype": "bfloat16", "telemetry": True}, {}),
    ("seafl", {"scheduler": "rate_staleness"}, CHURN),
    ("seafl2", {}, dict(CHURN, speed_model="zipf")),
    ("seafl", {"dispatch_compression": "bf16"}, WIRE),
    ("seafl", {"dispatch_compression": "int8", "compression": "int8"}, WIRE),
    ("seafl", {"dispatch_compression": "topk:0.1", "dispatch_resync": 0.5,
               "compression": "topk:0.2", "telemetry": True}, WIRE),
    ("seafl2", {"dispatch_compression": "topk:0.1", "cohorts": "on",
                "resync_batching": True, "dispatch_resync": 0.5}, WIRE),
    ("fedbuff", {"dispatch_compression": "topk:0.1",
                 "dispatch_ratio_policy": "drift",
                 "dispatch_resync_mode": "bytes"}, WIRE),
    ("seafl", {"cohorts": "on"}, {}),
], ids=["seafl", "fedasync", "seafl2", "fedbuff", "fedavg",
        "seafl-bf16-telemetry", "seafl-churn-ranked", "seafl2-churn-zipf",
        "down-bf16", "down-int8-up-int8", "down-topk-resync-up-topk",
        "down-topk-cohorts-batched", "down-topk-drift-bytes",
        "cohorts-broadcast"])
def test_simulation_replays_jax(algorithm, fl_kw, sim_kw, monkeypatch):
    """Crashes, churn, the bandwidth model and the ranked scheduler run in
    the churn cases: their RNG streams and events must replay too.  With
    telemetry on, the JAX package's metrics are recorded, and beside them
    only the port's own spans and counts (values of wall-clock metrics
    differ).  The ``down-*`` cases run the version-tracked
    downlink (the held reconstruction is then the uplink's base), the
    cohort table with its edge merges, resync batching and the drift
    bands; the resync and band decisions read f32 norms that sum in
    another order than XLA's, and the smallest margin to a threshold is
    printed (``pytest -s``)."""
    margins = watch_decisions(monkeypatch)
    jc = exp_cfg(algorithm, **fl_kw)
    jc.sim = dataclasses.replace(jc.sim, **sim_kw)
    jsim, jmodel, _ = jax_build(jc)
    params0 = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(jc.seed)))
    j_events = _record_events(jsim)
    j_hist = jsim.run(max_rounds=ROUNDS)

    tsim, _, _ = build_experiment(_port_cfg(jc), params=params0)
    t_events = _record_events(tsim)
    t_hist = tsim.run(max_rounds=ROUNDS)
    if margins:
        print(f"smallest relative margin of {len(margins)} decisions: "
              f"{min(margins):.3e}")

    assert len(t_hist) == len(j_hist) == ROUNDS
    for j, t in zip(j_hist, t_hist):
        assert t["time"] == j["time"] and t["round"] == j["round"]
        assert t["bytes"] == j["bytes"] and t["bytes_down"] == j["bytes_down"]
        assert abs(t["acc"] - j["acc"]) <= 0.02
        assert t.keys() == j.keys()
        if "telemetry" in j:
            for kind in ("counters", "gauges", "histograms"):
                tk, jk = t["telemetry"][kind].keys(), j["telemetry"][kind].keys()
                assert jk <= tk, kind
                assert all(_port_only(kind, k) for k in tk - jk), \
                    (kind, sorted(tk - jk))
            assert t["telemetry"]["counters"]["ingest.commits"] == \
                j["telemetry"]["counters"]["ingest.commits"]
    for j, t in zip(j_events, t_events):
        assert t.contributors == j.contributors
        assert t.dispatch == j.dispatch and t.notify == j.notify
        np.testing.assert_array_equal(t.staleness, j.staleness)
        if j.weights is None:
            assert t.weights is None
        else:
            np.testing.assert_allclose(t.weights, j.weights, atol=1e-5)
    np.testing.assert_allclose(tsim.server.global_flat.numpy(),
                               np.asarray(jsim.server.global_flat),
                               atol=1e-4)
    jd, td = jsim.server.dispatch, tsim.server.dispatch
    assert (jd is None) == (td is None)
    assert tsim.ratio_log == jsim.ratio_log
    assert tsim.server.cohort_stats() == jsim.server.cohort_stats()
    if jd is not None:
        assert td.cache_info() == jd.cache_info()
        assert (td.full_dispatches, td.delta_dispatches,
                td.resync_dispatches) == (jd.full_dispatches,
                                          jd.delta_dispatches,
                                          jd.resync_dispatches)
        assert td.versions == jd.versions
        assert tsim.server.resident_state_bytes() == \
            jsim.server.resident_state_bytes()
        if fl_kw.get("cohorts") == "on":
            assert td.table.stats() == jd.table.stats()
            assert td.table.member == jd.table.member
    if fl_kw.get("dispatch_compression") == "topk:0.1" and "drift" not in \
            str(fl_kw):
        assert jd.delta_dispatches > 0 and jd.cache_hits > 0
    if fl_kw.get("dispatch_resync") == 0.5:
        assert jd.resync_dispatches > 0
    if fl_kw.get("cohorts") == "on":
        assert jsim.server.cohort_stats()["edge_merges_total"] > 0


def test_data_is_array_equal():
    for name in ("tiny", "cifar-like"):
        jt, jv, jm = jax_dataset(name, 300, 50, seed=4)
        tt, tv, tm = make_image_dataset(name, 300, 50, seed=4)
        assert jm == tm
        for a, b in ((jt, tt), (jv, tv)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        for alpha in (0.3, 5.0):
            for a, b in zip(jax_partition(jt["y"], 7, alpha, seed=4),
                            dirichlet_partition(tt["y"], 7, alpha, seed=4)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["random", "stragglers_last",
                                    "rate_staleness"])
def test_scheduler_draws_like_jax(policy):
    js, ts = jax_scheduler(policy), make_scheduler(policy)
    jr, tr = np.random.default_rng(2), np.random.default_rng(2)
    pool = list(range(30))
    for step in range(20):
        for s in (js, ts):
            s.observe_round(step % 30, 1.0 + (step * 7) % 5)
            s.observe_aggregation(step, 10.0 * step)
        assert ts.select(pool, 4, tr, step) == js.select(pool, 4, jr, step)
    assert tr.bit_generator.state == jr.bit_generator.state


def test_unported_options_raise(monkeypatch, tmp_path):
    """Every option of ``FLConfig`` is ported: the compressed uplink, the
    version-tracked downlink, cohorts, the drift ratio policy, resync
    batching, the run monitor with its SLO, the autotuner and kernel timing
    construct; bad values still raise."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    params = {"w": torch.zeros(4)}
    for spec in ("topk:0.1", "bf16", "int8"):
        SeaflServer(FLConfig(compression=spec), params, {0: 1}, device="cpu")
    for spec in ("topk:0.1", "bf16", "f32", "int8"):
        SeaflServer(FLConfig(dispatch_compression=spec, cohorts="on",
                             resync_batching=True), params, {0: 1},
                    device="cpu")
    SeaflServer(FLConfig(dispatch_compression="topk:0.1",
                         dispatch_ratio_policy="drift"), params, {0: 1},
                device="cpu")
    with pytest.raises(ValueError, match="dispatch_ratio_policy"):
        SeaflServer(FLConfig(dispatch_compression="int8",
                             dispatch_ratio_policy="drift"), params, {0: 1},
                    device="cpu")
    for kw in ({"monitor": "on", "slo": "error,byte_budget"},
               {"autotune": "cache"},
               {"telemetry": True, "telemetry_kernels": True}):
        srv = SeaflServer(FLConfig(**kw), params, {0: 1}, device="cpu")
        assert (srv.monitor is not None) == ("monitor" in kw)
        assert (srv.tuning is not None) == ("autotune" in kw)
    with pytest.raises(ValueError):
        SeaflServer(FLConfig(compression="zstd"), params, {0: 1},
                    device="cpu")
    SeaflServer(FLConfig(compression="f32", buffer_dtype="bfloat16"), params,
                {0: 1}, device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SeaflServer(FLConfig(), {"w": torch.zeros(4)}, {0: 1})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_experiment(ExperimentConfig())
