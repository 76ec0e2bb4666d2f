"""The update buffer and the cohort residuals on 'pod' shards: the SEAFL
simulation on 4 gloo ranks of the CPU.

One spawn of 4 ranks (``torch_pod_ranks.py``, which imports no JAX, over a
``FileStore``) runs the integration workload
(``test_integration_fl.exp_cfg``: the tiny task, mlp, K = 4, 16 clients)
for ``test_torch_slice.py``'s 4 rounds inside ``axis_rules`` of a (2, 2,
1) and a (4, 1, 1) ('pod', 'data', 'model') mesh: seafl, seafl2, fedbuff,
fedavg (K = 8), seafl with bf16 slots, cohorts with the edge tier's merges
across pods, a top-k downlink with cohorts (its residuals sharded over
'pod' where P = 4810 divides the pods: on (2, 2, 1)), a staleness limit
of 2 that spills the buffer from 4 rows to 8, and a checkpoint saved in
the middle of a run and restored.  The update buffer is a DTensor whose
rows shard over 'pod'; each rank writes its own rows, and each
aggregation runs B1 and B2 on its own rows and reduces across 'pod'.

Held against the port's one-device run of each case (the same
``run_case`` off a mesh, in this process): event times, rounds,
contributors, staleness, dispatch lists, bytes, ``cohort_stats``, the
downlink's counters and the resident bytes identical; the aggregation
weights within 1e-6 and the final global within 1e-5 absolute (a pod's
sum of its own rows, summed across pods, is another order than one
device's sum over K, so the last bits differ, and training from the new
global carries that on; with bf16 slots also 2^-8 relative, one bf16
step, where a client's param a few ulps off rounds to the other bf16
neighbour).  The checkpoint's trees have the one-device
run's keys, shapes and dtypes, their values within 1e-5 for the same
reason.  The seafl case is also held against JAX with
``test_simulation_replays_jax``'s tolerances (weights 1e-5, global 1e-4,
accuracy 0.02).

The ranks label every collective with the phase it ran in: each
aggregation issues the (k, 4) partials' sum (seafl, seafl2) and one (P,)
sum across 'pod', nothing else; a collective handed a block of buffer
rows comes only at a growth, one handed a (P,) row only at an edge
merge across pods or a checkpoint save.  The slot protocol alone (writes,
a batched write, growth, merges within and across pods, the reads) runs
on the ranks in f32 and bf16 slots, each rank's rows bit-equal to its
pod's rows of one device's buffer.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_integration_fl import exp_cfg  # noqa: E402
from test_torch_slice import ROUNDS, WIRE, _record_events  # noqa: E402
from torch_pod_ranks import (_flat, buffer_protocol,  # noqa: E402
                             run_case)

from repro.experiment import build_experiment as jax_build  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
MESHES = ((2, 2, 1), (4, 1, 1))
P = 4810                           # the mlp's parameters
TOPK_COHORTS = dict(dispatch_compression="topk:0.1", cohorts="on",
                    resync_batching=True, dispatch_resync=0.5)
SIM_CASES = [
    ("seafl", "seafl", {}, {}),
    ("seafl2", "seafl2", {}, {}),
    ("fedbuff", "fedbuff", {}, {}),
    ("fedavg", "fedavg", {}, {}),
    ("seafl-bf16", "seafl", {"buffer_dtype": "bfloat16"}, {}),
    ("cohorts-broadcast", "seafl", {"cohorts": "on"}, {}),
    ("down-topk-cohorts-batched", "seafl2", TOPK_COHORTS, WIRE),
    ("spill", "seafl", {"staleness_limit": 2, "telemetry": True}, {}),
    ("checkpoint", "seafl2", TOPK_COHORTS, WIRE),
]
CASES = [{"name": f"{n}@{'x'.join(map(str, m))}", "mesh": list(m),
          "algorithm": a, "fl": fl, "sim": sim, "rounds": ROUNDS,
          **({"checkpoint": True} if n == "checkpoint" else {})}
         for m in MESHES for n, a, fl, sim in SIM_CASES]
PROTOCOL = [{"name": f"protocol-{d}@{'x'.join(map(str, m))}", "mesh": list(m),
             "protocol": True, "dtype": d}
            for m in MESHES for d in ("float32", "bfloat16")]
NAMES = [c["name"] for c in CASES]
# rows (or elements) over 'pod', replicated over 'data' and 'model'
OVER_POD = [str(Shard(0)), str(Replicate()), str(Replicate())]


def _spawn(work):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_pod_ranks.py"),
         str(work), str(r), str(WORLD)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{"ranks": each rank's report, "held": each rank's protocol rows,
    "got": rank 0's outputs, "one": the one-device runs, "jax": JAX's
    seafl run, "protocol": one device's protocol rows}."""
    work = tmp_path_factory.mktemp("dist_pod")
    jc = exp_cfg("seafl")
    jsim, jmodel, _ = jax_build(jc)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(
        jc.seed)))
    np.savez(work / "params.npz", **_flat(params))
    (work / "cases.json").write_text(json.dumps(CASES + PROTOCOL))
    procs = _spawn(work)
    try:
        # the reference runs here while the ranks run
        j_events = _record_events(jsim)
        j_hist = jsim.run(max_rounds=ROUNDS)
        one = {c["name"]: run_case(c, params, str(work)) for c in CASES}
        protocol = {c["name"]: buffer_protocol(None, getattr(
            torch, c["dtype"])) for c in PROTOCOL}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {"ranks": [json.loads((work / f"rank.{r}.json").read_text())
                      for r in range(WORLD)],
            "held": [dict(np.load(work / f"rank.{r}.npz"))
                     for r in range(WORLD)],
            "got": {n: dict(np.load(work / f"{n}.out.npz")) for n in NAMES},
            "one": one, "jax": (j_events, j_hist, jsim.server.global_flat),
            "protocol": protocol}


def _case(name):
    return next(c for c in CASES if c["name"] == name)


@pytest.mark.parametrize("name", NAMES)
def test_the_pod_run_replays_one_device(run, name):
    got, summary = run["got"][name], run["ranks"][0][name]
    one, want = run["one"][name]
    assert [{k: h[k] for k in ("time", "round", "bytes", "bytes_down")}
            for h in summary["history"]] == \
        [{k: h[k] for k in ("time", "round", "bytes", "bytes_down")}
         for h in want["history"]]
    assert len(summary["history"]) >= ROUNDS
    assert summary["events"] == want["events"]
    for key in ("cohort_stats", "resident", "dispatch", "spill_grow"):
        assert summary[key] == want[key], key
    np.testing.assert_allclose(got["weights"], one["weights"], rtol=0,
                               atol=1e-6)
    # bf16 slots: a client's param a few ulps off may round to the other
    # bf16 neighbour, one bf16 step (2^-8 of its value) times its weight
    bf16 = _case(name)["fl"].get("buffer_dtype") == "bfloat16"
    np.testing.assert_allclose(got["global"], one["global"],
                               rtol=2.0**-8 if bf16 else 0, atol=1e-5)
    for r in range(1, WORLD):      # every rank holds the same global
        assert run["ranks"][r][name]["events"] == summary["events"]
    if _case(name).get("checkpoint"):
        ck, ck_one = summary["checkpoint"], want["checkpoint"]
        assert ck["keys"] == ck_one["keys"]
        kinds = {k.rstrip("0123456789") for k in ck["keys"]}
        assert {"slot", "cr", "v"} <= kinds, ck["keys"]
        for k in ck["keys"]:
            a, b = got[f"ck/{k}"], one[f"ck/{k}"]
            assert a.shape == b.shape, k
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)
        state, state_one = ck["state"], ck_one["state"]
        assert state["buffer"] == state_one["buffer"]
        assert state["active"] == state_one["active"]
        assert state["dispatch"]["versions"] == \
            state_one["dispatch"]["versions"]
        assert state["dispatch"]["cohort"]["member"] == \
            state_one["dispatch"]["cohort"]["member"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_the_seafl_pod_run_replays_jax(run, mesh):
    name = f"seafl@{'x'.join(map(str, mesh))}"
    got, summary = run["got"][name], run["ranks"][0][name]
    j_events, j_hist, j_global = run["jax"]
    for j, t in zip(j_hist, summary["history"]):
        assert t["time"] == j["time"] and t["round"] == j["round"]
        assert t["bytes"] == j["bytes"]
        assert abs(t["acc"] - j["acc"]) <= 0.02
    for j, t in zip(j_events, summary["events"]):
        assert t["contributors"] == j.contributors
        assert t["dispatch"] == j.dispatch
        np.testing.assert_array_equal(t["staleness"], j.staleness)
    np.testing.assert_allclose(
        got["weights"], np.concatenate([ev.weights for ev in j_events]),
        atol=1e-5)
    np.testing.assert_allclose(got["global"], np.asarray(j_global),
                               atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_the_buffer_and_residuals_are_placed_as_the_reference_places_them(
        run, name):
    """The buffer's rows over 'pod' on every rank (K = 4, or 8 for fedavg
    and after the spill, divide 2 and 4 pods); a cohort residual's elements
    over 'pod' where P divides the pods (2, not 4), else plain."""
    pods = _case(name)["mesh"][0]
    for rank in run["ranks"]:
        s = rank[name]
        assert s["buffer"]["type"] == "DTensor"
        assert s["buffer"]["placements"] == OVER_POD
        want = ["DTensor", OVER_POD] if P % pods == 0 else ["Tensor", []]
        assert all(r == want for r in s["residuals"]), s["residuals"]
        if "topk" in name or "checkpoint" in name:
            assert s["residuals"], "the case left no cohort residual"
        if name.startswith("spill"):
            assert s["spill_grow"] >= 1 and s["buffer"]["rows"] == 8


@pytest.mark.parametrize("name", NAMES)
def test_an_aggregation_reduces_across_pods_and_moves_no_row(run, name):
    """Each aggregation: the (k, 4) partials' sum (seafl, seafl2) and the
    (P,) sum of the pods' mixes, all-reduces, nothing else.  Outside the
    aggregations, a collective handed a block of rows (2-D, P wide) comes
    only at a growth, a broadcast of a (P,) row only at an edge merge
    across pods or a checkpoint save."""
    case = _case(name)
    partials = case["algorithm"] in ("seafl", "seafl2")
    for rank in run["ranks"]:
        s = rank[name]
        assert len(s["aggregations"]) >= ROUNDS
        for agg in s["aggregations"]:
            want = {kind: 0 for kind in agg["counts"]}
            want["all-reduce"] = 2 if partials else 1
            assert agg["counts"] == want
            shapes = sorted(map(tuple, agg["shapes"]["all-reduce"]))
            assert shapes == sorted({(P,), *([(agg["k"], 4)]
                                             if partials else [])})
        log = s["collectives"]
        assert [c for c in log if c[0] == "aggregate"
                and c[1] != "all_reduce"] == []
        for phase, op, shapes in log:
            if any(len(sh) == 2 and sh[-1] == P for sh in shapes):
                assert phase == "growth", (phase, op, shapes)
            if op == "broadcast":
                assert phase in ("merge", "checkpoint"), (phase, shapes)
                assert shapes == [[P]]
        phases = {c[0] for c in log}
        if name.startswith("spill"):
            assert "growth" in phases
        if name.startswith("cohorts"):
            assert "merge" in phases


@pytest.mark.parametrize("case", PROTOCOL, ids=[c["name"] for c in PROTOCOL])
def test_each_rank_holds_its_pods_rows_of_the_protocol(run, case):
    """Every step of the slot protocol leaves each rank its own pod's rows
    of one device's buffer, bit for bit; ``row`` hands every rank each
    committed row whole; ``stacked_flat`` each rank its own committed rows
    at their arrival indices."""
    name, pods = case["name"], case["mesh"][0]
    one = run["protocol"][name]
    assert int(one["grown_rows"]) == 8
    for r, held in enumerate(run["held"]):
        pod = r // (WORLD // pods)
        for step in ("alloc", "written", "grown", "merged"):
            mine = held[f"{name}/{step}"]
            per = mine.shape[0]
            np.testing.assert_array_equal(
                mine, one[step][pod * per:(pod + 1) * per], err_msg=step)
        assert per * pods == 8
        np.testing.assert_array_equal(held[f"{name}/rows"], one["rows"])
        index = held[f"{name}/index"]
        np.testing.assert_array_equal(held[f"{name}/stacked"],
                                      one["stacked"][index])
        assert list(held[f"{name}/placements"]) == OVER_POD
    every = np.concatenate([h[f"{name}/index"] for h in run["held"]
                            [::WORLD // pods]])
    assert sorted(every) == list(range(len(one["rows"])))


def test_the_ranks_import_no_jax(run):
    assert not any(r["jax_imported"] for r in run["ranks"])
