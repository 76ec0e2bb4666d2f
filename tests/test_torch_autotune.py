"""The port's autotuner against the JAX package's, on the CPU.

Given one timer both packages pick the same codec and ingest winners; the
port's agg sweep is deterministic, its winner follows the clock, and its
plan never routes to the plain twin.  The cache round-trips, a version or
device mismatch invalidates it, and ``bucket``/``make_key``/the
nearest-bucket lookup equal the JAX package's.  ``autotune='off'`` never
touches a table; a table holding one codec winner gives the same wire
bytes and events in both packages; the port never opens the JAX package's
default table or cache file.  Kernel timing records the JAX package's
histogram names and counts.
"""
import builtins
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_autotune import fake_timer  # noqa: E402
from test_integration_fl import exp_cfg  # noqa: E402
from test_torch_slice import _port_cfg, _record_events  # noqa: E402

from repro.experiment import build_experiment as jax_build  # noqa: E402
from repro.kernels.seafl_agg import ops as JOPS  # noqa: E402
from repro.runtime import autotune as JA  # noqa: E402
from repro.runtime import codecs as JC  # noqa: E402
from repro_torch.core.buffer import Update, UpdateBuffer  # noqa: E402
from repro_torch.core.server import FLConfig, SeaflServer  # noqa: E402
from repro_torch.experiment import build_experiment  # noqa: E402
from repro_torch.kernels.seafl_agg import ops  # noqa: E402
from repro_torch.runtime import autotune as at  # noqa: E402
from repro_torch.runtime import codecs, transport  # noqa: E402
from repro_torch.runtime.telemetry import Telemetry  # noqa: E402
from repro_torch.runtime.autotune import (  # noqa: E402
    AGG_ENTRY_POINTS, BLOCK_P_CANDIDATES, CACHE_VERSION, DEFAULT_BLOCK_P,
    ServerTuning, TuningTable, bucket, make_key, sweep_agg_entry,
    sweep_codec, sweep_ingest,
)

P, K = 4096, 4


@pytest.fixture
def no_timing():
    """The JAX package's server installs kernel and codec timing for the
    whole process: clear it, and the hooks a test sets in the port."""
    yield
    for mod in (ops, JOPS):
        mod.set_kernel_timing(None)
    for mod in (codecs, JC):
        mod.set_codec_timing(None)


@pytest.fixture
def cache_home(monkeypatch, tmp_path):
    """Both packages' user caches under a fresh directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    return tmp_path


# ------------------------------------------------------ sweeps on a clock

CLOCKS = {
    "default": {},
    "mid-chunk": {("codec_topk", "chunk_elems", 1 << 15): 0.1,
                  ("ingest_batched", "flush_chunks", 32): 0.5},
    "eager-wins": {("ingest_eager", "flush_chunks", f): 0.1
                   for f in (8, 16, 32)},
}


@pytest.mark.parametrize("clock", list(CLOCKS))
@pytest.mark.parametrize("spec", ["f32", "topk:0.1", "int8"])
def test_codec_and_ingest_winners_equal_jax(clock, spec):
    sched = CLOCKS[clock]
    sched = {(k[0].replace("topk", spec.split(":")[0]), *k[1:]): v
             for k, v in sched.items()}
    assert sweep_codec(spec, P, timer=fake_timer(sched), device="cpu") == \
        JA.sweep_codec(spec, P, timer=fake_timer(sched))
    for dt in ("float32", "bfloat16"):
        assert sweep_ingest(P, dt, timer=fake_timer(sched),
                            device="cpu") == \
            JA.sweep_ingest(P, dt, timer=fake_timer(sched))


@pytest.mark.parametrize("entry", AGG_ENTRY_POINTS)
def test_agg_sweep_is_deterministic_and_follows_the_clock(entry):
    kw = dict(candidates=BLOCK_P_CANDIDATES, device="cpu")
    a = sweep_agg_entry(entry, P, K, timer=fake_timer(), **kw)
    assert a == sweep_agg_entry(entry, P, K, timer=fake_timer(), **kw)
    # the fake clock makes the twin fastest: recorded, never routed to
    assert a["use_oracle"] is False and a["oracle_faster"] is True
    assert a["block_p"] == min(BLOCK_P_CANDIDATES)
    assert a["tuned_us"] <= a["default_us"]
    fast = {(entry, "block_p", 8192): 0.5}
    b = sweep_agg_entry(entry, P, K, timer=fake_timer(fast), **kw)
    assert b["block_p"] == 8192 and b["oracle_faster"] is False
    assert set(b["candidates_us"]) == {str(c) for c in BLOCK_P_CANDIDATES}
    # on the CPU the default sweep times the one route once, at the default
    c = sweep_agg_entry(entry, P, K, timer=fake_timer(), device="cpu")
    assert list(c["candidates_us"]) == [str(DEFAULT_BLOCK_P)]
    assert c["predicted_us"] > 0 and c["device"] == "cpu"


def test_agg_sweep_rejects_unknown_entry():
    with pytest.raises(ValueError):
        sweep_agg_entry("not_an_entry", P, K, timer=fake_timer(),
                        device="cpu")


def test_agg_sweep_on_the_wall_clock_runs_the_plain_route():
    r = sweep_agg_entry("seafl_aggregate_flat_from_params", P, 2, reps=1,
                        device="cpu")
    assert np.isfinite(r["tuned_us"]) and np.isfinite(r["oracle_us"])
    assert r["use_oracle"] is False and r["block_p"] == DEFAULT_BLOCK_P


# -------------------------------------------------------------- the cache

def test_keys_buckets_and_lookup_equal_jax():
    for n in (0, 1, 2, 3, 4096, 65535, 65536, 65537, 1_344_052_224):
        assert bucket(n) == JA.bucket(n)
    for dt in ("float32", "bfloat16"):
        assert make_key("agg", "weighted_aggregate", dt, None, P, K,
                        device="cpu") == \
            JA.make_key("agg", "weighted_aggregate", dt, None, P, K,
                        device="cpu")
    assert make_key("ingest", "bypass", torch.bfloat16, "topk", 1 << 16, 16,
                    device="cpu") == \
        JA.make_key("ingest", "bypass", "bfloat16", "topk", 1 << 16, 16,
                    device="cpu")
    t, j = TuningTable(device="cpu"), JA.TuningTable(device="cpu")
    for i, (p, k) in enumerate([(1 << 14, 2), (1 << 16, 8), (1 << 20, 2)]):
        for table in (t, j):
            table.put(make_key("agg", "weighted_aggregate", "float32", None,
                               p, k, device="cpu"), {"block_p": 1024 << i})
    for p in (1, 1 << 12, 1 << 15, 1 << 17, 1 << 19, 1 << 24):
        for k in (1, 2, 4, 8, 64):
            for dt in ("float32", "bfloat16"):
                assert t.lookup("agg", "weighted_aggregate", dt, None, p,
                                k) == j.lookup("agg", "weighted_aggregate",
                                               dt, None, p, k)


def test_cache_round_trip(tmp_path):
    t = TuningTable(device="cpu")
    key = make_key("agg", "weighted_aggregate", "float32", None, P, K,
                   device="cpu")
    t.put(key, sweep_agg_entry("weighted_aggregate", P, K,
                               timer=fake_timer(), device="cpu"))
    path = str(tmp_path / "tuning.json")
    t.save(path)
    back = TuningTable.load(path, "cpu")
    assert back is not None and back.entries == t.entries
    assert back.version == CACHE_VERSION and back.device == "cpu"
    assert set(json.loads(open(path).read())) == {
        "version", "device_kind", "torch_version", "entries"}


@pytest.mark.parametrize("field,value", [("version", CACHE_VERSION + 1),
                                         ("device_kind", "NVIDIA H100")])
def test_cache_mismatch_invalidates_and_resweeps(tmp_path, monkeypatch,
                                                 field, value):
    path = str(tmp_path / "tuning.json")
    t = TuningTable(device="cpu")
    t.put("bogus", {"block_p": 1024})
    t.save(path)
    data = json.loads(open(path).read())
    data[field] = value
    with open(path, "w") as f:
        json.dump(data, f)
    assert TuningTable.load(path, "cpu") is None
    calls = []
    monkeypatch.setattr(at, "sweep_agg_entry", lambda entry, *a, **kw:
                        calls.append(entry) or {"block_p": 2048})
    monkeypatch.setattr(at, "sweep_codec",
                        lambda *a, **kw: {"chunk_elems": 1 << 16})
    monkeypatch.setattr(at, "sweep_ingest", lambda *a, **kw: {
        "bypass": True, "flush_chunks": 16})
    tuning = ServerTuning.build(
        "sweep", p=P, k=K, dtype="float32", scheme="f32", algorithm="seafl",
        chunk_elems=1 << 16, flush_chunks=16, cache_path=path, device="cpu")
    assert calls == ["seafl_aggregate_flat_from_params",
                     "weighted_aggregate"]
    assert "bogus" not in tuning.table.entries
    saved = TuningTable.load(path, "cpu")
    assert saved is not None and saved.version == CACHE_VERSION
    assert tuning.agg_plan("weighted_aggregate") == 2048


def test_plans_never_route_to_the_plain_twin(cache_home):
    t = TuningTable(device="cpu")
    t.put(make_key("agg", "weighted_aggregate", "float32", None, P, K,
                   device="cpu"), {"use_oracle": True, "block_p": 8192})
    t.save(at.user_cache_path())
    tuning = ServerTuning.build("cache", p=P, k=K, dtype=torch.float32,
                                scheme="f32", algorithm="fedavg",
                                chunk_elems=1 << 16, flush_chunks=16,
                                device="cpu")
    assert tuning.agg_plan("weighted_aggregate") == 8192
    assert set(tuning.active_keys()) == {"agg:weighted_aggregate",
                                         "codec:f32"}


def test_the_port_never_opens_the_jax_tables(cache_home, monkeypatch):
    """The JAX package's committed default table is keyed to its CPU kind,
    ``cpu``, as the port's CPU is: the port must not read it, nor the JAX
    user cache."""
    j = JA.TuningTable(device="cpu")
    j.put(JA.make_key("codec", "f32", "float32", "f32", P, 0, device="cpu"),
          {"chunk_elems": 1024})
    j.save(JA.user_cache_path())
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.path.abspath(str(path)))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    tuning = ServerTuning.build("cache", p=P, k=K, dtype="float32",
                                scheme="f32", algorithm="seafl",
                                chunk_elems=1 << 16, flush_chunks=16,
                                device="cpu")
    monkeypatch.setattr(builtins, "open", real_open)
    forbidden = {os.path.abspath(JA.default_table_path()),
                 os.path.abspath(JA.user_cache_path())}
    assert opened and not forbidden & set(opened)
    assert at.user_cache_path() != JA.user_cache_path()
    assert "repro_torch" in at.default_table_path()
    assert tuning.table.entries == {} and tuning.chunk_elems(1 << 16) == \
        1 << 16


# ------------------------------------------------- the server, off and on

def _tiny_server(**kw):
    params = {"w": torch.zeros(32, 32), "b": torch.zeros(32)}
    cfg = FLConfig(algorithm=kw.pop("algorithm", "seafl"), n_clients=4,
                   concurrency=2, buffer_size=2, **kw)
    return SeaflServer(cfg, params, {i: 10 for i in range(4)}, device="cpu")


def _two_uploads(server, seed):
    rng = np.random.default_rng(seed)
    for i in range(2):
        upd = server.global_flat + 0.01 * torch.from_numpy(
            rng.normal(size=server.packer.size).astype(np.float32))
        server.active[i] = 0
        server.on_update(i, server.packer.unpack(upd), n_epochs=1)
    return server.global_flat


def test_off_never_touches_the_tuner_and_is_the_untuned_call(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("autotune='off' touched the tuning table")

    for name in ("load_table", "sweep_agg_entry", "sweep_codec",
                 "sweep_ingest"):
        monkeypatch.setattr(at, name, boom)
    monkeypatch.setattr(at.TuningTable, "load", boom)
    monkeypatch.setattr(at.ServerTuning, "build", boom)
    server = _tiny_server()
    assert server.tuning is None
    got = _two_uploads(server, 3)
    rng = np.random.default_rng(3)
    g0 = torch.zeros(server.packer.size)
    stacked = torch.stack([g0 + 0.01 * torch.from_numpy(
        rng.normal(size=g0.numel()).astype(np.float32)) for _ in range(2)])
    h = server.cfg.hyper()
    want, _ = ops.seafl_aggregate_flat_from_params(
        g0, stacked, np.full(2, 10, np.float32), np.zeros(2, np.float32),
        h.alpha, h.mu, h.beta, h.theta)
    assert torch.equal(got, want)


@pytest.mark.parametrize("algorithm", ["seafl", "seafl2", "fedavg",
                                       "fedbuff", "fedasync"])
def test_a_tuned_server_on_the_cpu_equals_the_untuned(cache_home,
                                                      algorithm):
    """On the CPU the plan is ignored: a table routing every entry to
    another grid changes no value."""
    t = TuningTable(device="cpu")
    for entry in AGG_ENTRY_POINTS:
        for k in (1, 2):
            t.put(make_key("agg", entry, "float32", None, 1056, k,
                           device="cpu"), {"block_p": 1024})
    t.save(at.user_cache_path())
    on = _tiny_server(algorithm=algorithm, autotune="cache")
    assert on.tuning.agg_plan("weighted_aggregate") == 1024
    off = _tiny_server(algorithm=algorithm)
    assert torch.equal(_two_uploads(on, 7), _two_uploads(off, 7))


def test_one_codec_winner_gives_the_same_run_in_both(cache_home):
    """A table holding a non-default ``chunk_elems`` for the top-k uplink,
    in each package's own user cache: both servers re-chunk the uplink and
    replay the same wire bytes and events."""
    jc = exp_cfg("seafl", compression="topk:0.2", autotune="cache")
    jsim, jmodel, _ = jax_build(exp_cfg("seafl"))
    p = jsim.server.packer.size
    j = JA.TuningTable(device=JA.device_kind())
    j.put(JA.make_key("codec", "topk", "float32", "topk", p, 0), {
        "chunk_elems": 4096})
    j.save(JA.user_cache_path())
    t = TuningTable(device="cpu")
    t.put(make_key("codec", "topk", "float32", "topk", p, 0, device="cpu"),
          {"chunk_elems": 4096})
    t.save(at.user_cache_path())
    params0 = jax.tree.map(np.asarray,
                           jmodel.init(jax.random.PRNGKey(jc.seed)))
    jsim, _, _ = jax_build(jc)
    j_events = _record_events(jsim)
    j_hist = jsim.run(max_rounds=3)
    tsim, _, _ = build_experiment(_port_cfg(jc), params=params0)
    t_events = _record_events(tsim)
    t_hist = tsim.run(max_rounds=3)
    assert tsim.server.wire.chunk_elems == jsim.server.wire.chunk_elems \
        == 4096
    assert [(h["time"], h["bytes"], h["bytes_down"]) for h in t_hist] == \
        [(h["time"], h["bytes"], h["bytes_down"]) for h in j_hist]
    assert [e.contributors for e in t_events] == \
        [e.contributors for e in j_events]


# ------------------------------------------------------ the ingest verdict

@pytest.mark.parametrize("verdict", [True, None])
def test_batcher_verdict_or_probe(monkeypatch, verdict):
    probed = []
    monkeypatch.setattr(transport, "_coalescing_loses",
                        lambda *a, **kw: probed.append(a) or False)
    buf = UpdateBuffer(2, 1 << 13, device="cpu")
    b = transport.IngestBatcher(buf, flush_chunks=4, auto_bypass=True,
                                tuned_verdict=lambda n, dtype, f: verdict)
    buf.reserve(Update(0, 1, 0, 1))
    b.enqueue(0, 0, torch.ones(1 << 12))
    if verdict:
        assert not probed and b.chunks_bypassed == 1 and b.pending == 0
    else:
        assert probed and b._bypass is False and b.pending == 1


# ------------------------------------------------------------ kernel timing

@pytest.mark.parametrize("algorithm,fl_kw", [
    ("seafl", {}), ("fedbuff", {"compression": "topk:0.2"}),
    ("seafl", {"compression": "int8", "dispatch_compression": "bf16"}),
], ids=["seafl-f32", "fedbuff-topk", "seafl-int8-bf16-down"])
def test_kernel_timing_records_what_jax_records(no_timing, algorithm, fl_kw):
    jc = exp_cfg(algorithm, telemetry=True, telemetry_kernels=True, **fl_kw)
    jsim, jmodel, _ = jax_build(jc)
    params0 = jax.tree.map(np.asarray,
                           jmodel.init(jax.random.PRNGKey(jc.seed)))
    jsim.run(max_rounds=2)
    j = {k: v["count"] for k, v in jsim.server.tel.snapshot()[
        "histograms"].items() if k.startswith("kernel.")}
    tsim, _, _ = build_experiment(_port_cfg(jc), params=params0)
    tsim.run(max_rounds=2)
    t = {k: v["count"] for k, v in tsim.server.tel.snapshot()[
        "histograms"].items() if k.startswith("kernel.")}
    assert t == j and t


def test_timing_changes_no_value(no_timing):
    tel = Telemetry(enabled=True)
    vec = torch.linspace(-1, 1, 10_000)
    fmt = codecs.make_wire_format("topk:0.1", chunk_elems=1024)
    plain = codecs.encode_flat(vec, fmt)
    codecs.set_codec_timing(tel)
    timed = codecs.encode_flat(vec, fmt)
    back = codecs.decode_concat(timed, fmt)
    codecs.set_codec_timing(None)
    assert torch.equal(back, codecs.decode_concat(plain, fmt))
    for a, b in zip(plain, timed):
        assert all(torch.equal(a.payload[k], b.payload[k])
                   for k in a.payload)
    h = tel.snapshot()["histograms"]
    assert h["kernel.encode_topk_us"]["count"] == len(plain) == 10
    assert h["kernel.decode_topk_us"]["count"] == 10


def test_timed_encode_runs_the_batched_path(no_timing, monkeypatch):
    """Codec timing times the path an untimed encode takes: the full
    chunks through one ``encode_batch`` call, the tail alone; the batch's
    time is spread over its rows, one sample a chunk."""
    vec = torch.linspace(-1, 1, 10_000)
    fmt = codecs.make_wire_format("int8", chunk_elems=1024)
    calls = []
    for name in ("encode", "encode_batch"):
        real = getattr(fmt.codec, name)

        def spy(x, *a, _real=real, _name=name, **kw):
            calls.append((_name, tuple(x.shape)))
            return _real(x, *a, **kw)
        monkeypatch.setattr(fmt.codec, name, spy)
    codecs.encode_flat(vec, fmt)
    untimed = list(calls)
    calls.clear()
    tel = Telemetry(enabled=True)
    codecs.set_codec_timing(tel)
    codecs.encode_flat(vec, fmt)
    assert calls == untimed and untimed[0] == ("encode_batch", (9, 1024))
    assert ("encode", (784,)) in untimed
    vals = tel._hists["kernel.encode_int8_us"]
    assert len(vals) == 10 and len(set(vals[:9])) == 1


def test_a_servers_kernel_timing_stays_its_own():
    """A server installs its timing for its own calls only: nothing is
    left installed after them, and a later server with telemetry but
    without telemetry_kernels times nothing."""
    hists = []
    for timed in (True, False):
        server = _tiny_server(telemetry=True, telemetry_kernels=timed)
        _two_uploads(server, 5)
        assert ops._KERNEL_TEL is None and codecs._KERNEL_TEL is None
        hists.append(sorted(k for k in server.tel.snapshot()["histograms"]
                            if k.startswith("kernel.")))
    assert hists == [["kernel.decode_f32_us", "kernel.encode_f32_us",
                      "kernel.seafl_aggregate_flat_from_params_us"], []]


@pytest.mark.parametrize("call", [
    lambda: at.device_kind(),
    lambda: sweep_agg_entry("weighted_aggregate", P, K, timer=fake_timer()),
    lambda: sweep_codec("f32", P, timer=fake_timer()),
    lambda: sweep_ingest(P, timer=fake_timer()),
    lambda: ServerTuning.build("cache", p=P, k=K, dtype="float32",
                               scheme="f32", algorithm="seafl",
                               chunk_elems=1 << 16, flush_chunks=16),
], ids=["device_kind", "sweep_agg_entry", "sweep_codec", "sweep_ingest",
        "ServerTuning.build"])
def test_without_a_device_the_tuner_asks_for_the_card(monkeypatch,
                                                      cache_home, call):
    """The tuner follows the port's device policy: no device means the
    card, which raises here instead of quietly timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()


# ------------------------------------------------------------ the knob

def test_block_p_sets_the_grid():
    from repro_torch.kernels.seafl_agg import kernel as K
    assert K.DEFAULT_BLOCK_P == DEFAULT_BLOCK_P == 4096
    assert K._grid(1_344_052_224) == K._grid(1_344_052_224, 4096) == 328_138
    assert [K._grid(70_001, bp) for bp in BLOCK_P_CANDIDATES] == \
        [69, 35, 18, 9, 5]
    assert K._grid(1, 16384) == 1
    for bad in (0, -4096):
        with pytest.raises(ValueError, match="block_p"):
            K._grid(4096, bad)


def test_partials_drift_is_relative_to_each_partials_scale():
    """|d|^2 and |g|^2 move relative to themselves; d.g's plain relative
    change is read; each row's cosine moves by d.g's change over its
    Cauchy-Schwarz scale sqrt(|d|^2 |g|^2)."""
    base = torch.tensor([[1e-3, 4.0, 9.0, 0.0], [-2.0, 1.0, 16.0, 0.0]],
                        dtype=torch.float64)
    assert at.partials_drift(base, base) == {
        "d.g": 0.0, "|d|^2": 0.0, "|g|^2": 0.0, "cosine": 0.0}
    moved = base + torch.tensor([[6e-7, 0, 0, 0], [0, 0, 1.6e-5, 0]],
                                dtype=torch.float64)
    d = at.partials_drift(moved, base)
    assert d["d.g"] == pytest.approx(6e-4, rel=1e-6)
    assert d["|d|^2"] == 0.0 and d["|g|^2"] == pytest.approx(1e-6, rel=1e-6)
    # row 0: 6e-7 / 6; row 1: cos -0.5 -> -2 / sqrt(16 + 1.6e-5)
    assert d["cosine"] == pytest.approx(2.5e-7, rel=1e-3)
    assert at.GRID_BOUNDED == ("|d|^2", "|g|^2", "cosine") and \
        max(d[k] for k in at.GRID_BOUNDED) <= at.GRID_BOUND
