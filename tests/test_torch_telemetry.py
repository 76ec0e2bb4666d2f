"""The port's spans and counts (``runtime/telemetry.py``) in a tiny
federation of its ``SeaflServer``, ``Client`` and ``FLSimulation`` on the
CPU: under ``torch.profiler`` every span is a ``seafl.<name>`` range, nested
where the work nests; the registry's counts equal the work done; one
``gc.callbacks`` hook a process turns each collection into a span; and no
span changes a byte of the run."""
from __future__ import annotations

import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.client import make_epoch_fn
from repro_torch.core.server import FLConfig
from repro_torch.experiment import ExperimentConfig, build_experiment
from repro_torch.runtime import telemetry
from repro_torch.runtime.simulator import SimConfig
from repro_torch.runtime.telemetry import PROFILER_PREFIX, Telemetry

ROUNDS = 3
EPOCHS = 2
BATCH = 16

# each span and the span it runs inside
PARENT = {
    "client.batches": "client.local_train",
    "client.step": "client.local_train",
    "client.forward": "client.step",
    "client.backward": "client.step",
    "client.update": "client.step",
    "client.loss_sync": "client.local_train",
    "encode.pack": "encode",
    "encode.chunks": "encode",
    "ingest.write": "ingest",
    "ingest.commit": "ingest",
    "server.aggregate": "ingest.commit",
    "dispatch.model": "sim.upload",
    "client.local_train": "sim.upload",
    "encode": "sim.upload",
    "ingest": "sim.deliver",
    "sim.eval": "sim.deliver",
}


class Federation:
    """A tiny federation with the work it did logged: each upload's client
    and epochs, and each encoded payload's chunks and bytes."""

    def __init__(self, telemetry_on: bool = False):
        cfg = ExperimentConfig(
            dataset="tiny", n_train=360, n_test=60, device="cpu", seed=5,
            fl=FLConfig(n_clients=6, concurrency=3, buffer_size=2,
                        local_epochs=EPOCHS, batch_size=BATCH,
                        telemetry=telemetry_on),
            sim=SimConfig(seed=5))
        self.sim, _, _ = build_experiment(cfg)
        self.uploads: list[tuple[int, int]] = []
        self.payloads: list[tuple[int, int]] = []
        for c in self.sim.clients.values():
            c.local_train = self._logged_train(c)
        srv = self.sim.server
        encode = srv.encode_update

        def logged_encode(cid, params, n_epochs):
            payload = encode(cid, params, n_epochs)
            self.payloads.append((len(payload.chunks), payload.nbytes))
            return payload
        srv.encode_update = logged_encode

    def _logged_train(self, client):
        train = client.local_train

        def logged(params, n_epochs, lr):
            self.uploads.append((client.cid, n_epochs))
            return train(params, n_epochs, lr)
        return logged

    def run(self) -> list[dict]:
        return self.sim.run(max_rounds=ROUNDS)

    def steps(self, rows: bool = False) -> int:
        """SGD steps of the logged uploads (epochs x batches a shard), or
        the rows of their batches."""
        total = 0
        for cid, n_epochs in self.uploads:
            n = self.sim.clients[cid].n_samples
            bs = min(BATCH, n)
            total += max(1, n_epochs) * max(1, n // bs) * (bs if rows else 1)
        return total


def _ranges(prof) -> list[tuple[str, int, int]]:
    """The profile's ``seafl.`` ranges, prefix cut: (name, start, end)."""
    cut = len(PROFILER_PREFIX)
    return [(e.name()[cut:], e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PROFILER_PREFIX)]


@pytest.fixture(scope="module")
def profiled():
    """One federation run under the profiler, the registry off."""
    fed = Federation()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        history = fed.run()
    return fed, history, _ranges(prof)


@pytest.fixture(scope="module")
def recorded():
    """One federation run with the registry on and no profiler."""
    fed = Federation(telemetry_on=True)
    history = fed.run()
    return fed, history, fed.sim.server.tel


@pytest.mark.parametrize("child", sorted(PARENT))
def test_every_span_is_a_range_inside_its_parent(profiled, child):
    _, _, ranges = profiled
    parents = [(a, b) for n, a, b in ranges if n == PARENT[child]]
    inner = [(a, b) for n, a, b in ranges if n == child]
    assert inner, child
    for a, b in inner:
        assert any(pa <= a and b <= pb for pa, pb in parents), child


def test_each_handled_event_is_a_range(profiled):
    _, _, ranges = profiled
    kinds = {n for n, _, _ in ranges if n.startswith("sim.")}
    assert {"sim.upload", "sim.arrive", "sim.deliver", "sim.eval"} <= kinds


def test_the_ranges_count_the_work(profiled):
    fed, history, ranges = profiled
    names = [n for n, _, _ in ranges]
    assert len(history) == ROUNDS
    assert names.count("client.local_train") == len(fed.uploads) > 0
    assert names.count("client.batches") == sum(
        max(1, e) for _, e in fed.uploads)
    assert names.count("client.step") == fed.steps()
    for step_part in ("client.forward", "client.backward", "client.update"):
        assert names.count(step_part) == fed.steps()
    assert names.count("encode") == len(fed.payloads)
    assert names.count("sim.eval") == len(history)
    assert names.count("server.aggregate") == len(history)


def test_the_registry_counts_the_work(recorded):
    fed, history, tel = recorded
    counters = tel.snapshot()["counters"]
    assert counters["client.sgd_steps"] == fed.steps()
    # the tiny task's batches have no tokens leaf: a row counts
    assert counters["client.tokens"] == fed.steps(rows=True)
    assert counters["sim.evals"] == len(history) == ROUNDS
    assert counters["encode.chunks"] == sum(c for c, _ in fed.payloads)
    assert counters["encode.bytes"] == sum(b for _, b in fed.payloads)
    hists = tel.snapshot()["histograms"]
    assert hists["client.step_ms"]["count"] == fed.steps()
    assert hists["sim.eval_ms"]["count"] == ROUNDS


def test_the_registry_keeps_each_spans_parent(recorded):
    _, _, tel = recorded
    wall = [ev for ev in tel._spans if ev["pid"] == telemetry.WALL_PID]
    seen = set()
    for ev in wall:
        name, parent = ev["name"], ev["args"]["parent"]
        if name in PARENT:
            assert parent == PARENT[name], (name, parent)
            seen.add(name)
        elif name.startswith("sim."):
            assert parent is None
    assert seen == set(PARENT)
    uploads = [ev["args"] for ev in wall if ev["name"] in ("encode", "ingest")]
    assert uploads and all({"cid", "version"} <= set(a) for a in uploads)


def test_a_token_batch_counts_its_tokens():
    """With a ``tokens`` leaf the epoch counts its elements, into the
    registry of the span it runs in."""
    tel = Telemetry(enabled=True)
    epoch = make_epoch_fn(lambda p, b: (p["w"] * b["tokens"].float()).sum())
    data = {"tokens": torch.ones(3, 2, 5, dtype=torch.int32),
            "labels": torch.zeros(3, 2, 5, dtype=torch.int32)}
    with tel.span("client.local_train", cid=0):
        epoch({"w": torch.ones(())}, data, 0.1)
    assert (tel._counters["client.sgd_steps"],
            tel._counters["client.tokens"]) == (3, 30)
    assert telemetry.current() is telemetry.NULL


def test_with_neither_on_a_span_is_the_shared_no_op():
    assert Telemetry().span("encode", cid=1) is telemetry._NULL_SPAN


def test_a_range_carries_the_spans_attributes():
    with profile(activities=[ProfilerActivity.CPU]):
        span = Telemetry().span("encode", version=7, cid=3)
    assert span._range.name == "seafl.encode"
    assert span._range.args == "cid=3,version=7"


def test_a_collection_is_a_range_and_registries_add_no_hook():
    n = len(gc.callbacks)
    regs = [Telemetry(enabled=bool(i % 2)) for i in range(4)]
    assert len(gc.callbacks) == n
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert ("host.gc" in {name for name, _, _ in _ranges(prof)})
    tel = regs[1]
    with tel.span("sim.deliver"):
        gc.collect()
    assert tel._counters["gc.collections[generation=2]"] >= 1
    gcs = [ev for ev in tel._spans if ev["name"] == "host.gc"]
    assert gcs and all(ev["args"]["parent"] == "sim.deliver"
                       and ev["args"]["generation"] == 2 for ev in gcs)
    # outside any span of an enabled registry nothing counts
    before = dict(tel._counters)
    gc.collect()
    assert tel._counters == before


def test_a_collection_as_the_profiler_starts_or_stops_does_not_raise():
    """The hook is called with the profiler half on: a collection's start
    before the profiler and its end after, and the other way round."""
    prof = profile(activities=[ProfilerActivity.CPU])
    telemetry._on_collection("start", {"generation": 0})
    prof.__enter__()
    telemetry._on_collection("stop", {"generation": 0})
    telemetry._on_collection("start", {"generation": 1})
    prof.__exit__(None, None, None)
    telemetry._on_collection("stop", {"generation": 1})
    assert telemetry._gc_span is telemetry._NULL_SPAN
    assert telemetry.current() is telemetry.NULL


@pytest.mark.parametrize("mode", ["profiler", "registry"])
def test_spans_change_no_byte_of_the_run(profiled, recorded, mode):
    """History, the global and the wire bytes are bit-identical with the
    registry off and no profiler, under the profiler, and with the
    registry on."""
    plain = Federation()
    h0 = plain.run()
    fed, h1, _ = profiled if mode == "profiler" else recorded
    assert [{k: v for k, v in r.items() if k != "telemetry"} for r in h1] \
        == h0
    assert torch.equal(fed.sim.server.global_flat,
                       plain.sim.server.global_flat)
    assert fed.payloads == plain.payloads and fed.uploads == plain.uploads
    assert (fed.sim.server.bytes_uploaded, fed.sim.server.bytes_downloaded) \
        == (plain.sim.server.bytes_uploaded,
            plain.sim.server.bytes_downloaded)
