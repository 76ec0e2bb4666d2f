"""The port's cohorted fleet state and edge tier against the JAX package's.

``CohortDispatchSession`` (runtime/cohorts.py) runs in lockstep with the
JAX one on the seeded ring of ``test_torch_dispatch`` (P = 3000, chunks of
512): clients that reach one cohort by different hops accrue mismatch
bounds, members share fold encodes, a mismatch outgrowing its hop forces a
full snapshot.  Held equal: payload bytes, ``CohortTable.stats``,
membership, ``cache_info``, the cohort residuals and ``held_flat``, and
``state_dict`` both ways; mismatch bounds (sums of f32 norms) within 1e-6
of each other.  Then the server: the edge tier merges same-version uploads
into one buffer slot exactly as the JAX server does, and ``cohorts='off'``
keeps the per-client state and the checkpoint shape.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.server import FLConfig as JFLConfig  # noqa: E402
from repro.core.server import SeaflServer as JServer  # noqa: E402
from repro.runtime import cohorts as JC  # noqa: E402
from repro_torch.core.server import FLConfig, SeaflServer  # noqa: E402
from repro_torch.runtime import cohorts as TC  # noqa: E402
from test_torch_dispatch import (  # noqa: E402
    P, STEPS, assert_states_equal, lockstep, make_rings, sessions,
    swap_states,
    watch_decisions,
)


def cohort_sessions(spec, **kw):
    return sessions(spec, JC.CohortDispatchSession, TC.CohortDispatchSession,
                    **kw)


def assert_tables_equal(jt, tt):
    assert tt.stats() == jt.stats()
    assert tt.member == jt.member
    assert tt._count == jt._count and tt._gen == jt._gen
    assert sorted(tt.mismatch) == sorted(jt.mismatch)
    for c, m in jt.mismatch.items():
        assert abs(tt.mismatch[c] - m) <= 1e-6 * m, c
    assert list(tt._residual) == list(jt._residual)
    for k, v in jt._residual.items():
        np.testing.assert_array_equal(tt._residual[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("spec,kw,batch", [
    ("topk:0.1", {"resync": 1.0}, False),
    ("topk:0.1", {"resync": 1.0}, True),
    ("topk:0.1", {"resync": 0.3, "resync_mode": "bytes"}, False),
    ("int8", {"resync": 0.02}, False),
    ("int8", {"multicast": False}, True),
    ("f32", {}, False),
], ids=["topk", "topk-batched", "topk-bytes", "int8", "int8-folds-batched",
        "f32"])
def test_cohort_session_replays_jax(spec, kw, batch, monkeypatch):
    """The dispatch steps of ``test_torch_dispatch`` under cohort state,
    one half in each package's restored state."""
    margins = watch_decisions(monkeypatch)
    jring, tring = make_rings()
    js, ts = cohort_sessions(spec, **kw)
    lockstep(js, ts, jring, tring, STEPS[:5], batch=batch)
    assert_tables_equal(js.table, ts.table)
    js, ts = swap_states(js, ts, lambda: cohort_sessions(spec, **kw))
    assert_tables_equal(js.table, ts.table)
    lockstep(js, ts, jring, tring, STEPS[5:], batch=batch)
    assert_tables_equal(js.table, ts.table)
    assert_states_equal(js.state_dict(), ts.state_dict())
    info = js.cache_info()
    if js.fmt.delta_coded:
        assert info["cohorts"] > 0 and js.delta_dispatches > 0
        assert js.table.cohort_births > 0
    if "resync" in kw and kw.get("resync_mode") != "bytes":
        assert js.resync_dispatches + info["mismatch_resyncs"] > 0, info
    if margins:
        print(f"{spec} {kw}: {info}; smallest relative margin of "
              f"{len(margins)} decisions {min(margins):.3e}")


def test_co_moving_members_share_one_residual_and_one_fold():
    """Members on the same hop from the same cohort share one residual
    (O(cohorts) bytes, whatever the member count) and one fold encode,
    as in JAX."""
    jring, tring = make_rings(4)
    js, ts = cohort_sessions("topk:0.1", resync=0.0)
    steps = [(0, list(range(6)), []), (1, list(range(6)), []),
             (2, list(range(6)), [])]
    lockstep(js, ts, jring, tring, steps)
    assert_tables_equal(js.table, ts.table)
    assert ts.table.n_cohorts() == 1 and ts.table.n_members() == 6
    assert ts.table.resident_bytes() == 4 * P
    assert ts.cache_info()["fold_hits"] == js.cache_info()["fold_hits"] > 0


def test_table_state_round_trips_between_packages():
    jring, tring = make_rings()
    js, ts = cohort_sessions("topk:0.1", resync=1.0)
    lockstep(js, ts, jring, tring, STEPS)
    jt, tt = JC.CohortTable(), TC.CohortTable()
    tt.load_state(json.loads(json.dumps(js.table.state_dict())),
                  {k: np.asarray(v)
                   for k, v in js.table.residual_trees().items()})
    jt.load_state(json.loads(json.dumps(ts.table.state_dict())),
                  {k: jnp.asarray(v.numpy())
                   for k, v in ts.table.residual_trees().items()})
    assert_tables_equal(jt, tt)


def test_shard_cohort_state_is_the_identity_off_a_mesh():
    v = torch.arange(5.0)
    assert TC.shard_cohort_state(v) is v


# ------------------------------------------------------------------ server

def servers(algorithm="seafl", **kw):
    """A JAX and a port server over the same 3-leaf params, 12 clients,
    6 in flight, K = 3."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(11, 7)).astype(np.float32)
    c = rng.normal(size=(13,)).astype(np.float32)
    sizes = {i: 10 * (i + 1) for i in range(12)}
    base = dict(algorithm=algorithm, n_clients=12, concurrency=6,
                buffer_size=3, staleness_limit=4.0, seed=0, **kw)
    js = JServer(JFLConfig(**base), {"w": jnp.asarray(w),
                                     "b": {"c": jnp.asarray(c)}}, sizes)
    ts = SeaflServer(FLConfig(**base), {"w": torch.from_numpy(w),
                                        "b": {"c": torch.from_numpy(c)}},
                     sizes, device="cpu")
    return js, ts


def upload_round(js, ts, rng, scale=0.1):
    """Every in-flight client trains (a seeded perturbation of the model
    it holds) and uploads, in cid order; returns the two event lists."""
    jev, tev = [], []
    for cid in sorted(js.active):
        assert ts.active[cid] == js.active[cid]
        for s, ev in ((js, jev), (ts, tev)):
            s.deliver_dispatch(cid, s.encode_dispatch(cid))
        step = {k: scale * rng.normal(size=v).astype(np.float32)
                for k, v in (("w", (11, 7)), ("c", (13,)))}
        jm, tm = js.dispatch_model(cid), ts.dispatch_model(cid)
        jev.append(js.on_update(cid, {"w": jm["w"] + step["w"],
                                      "b": {"c": jm["b"]["c"] + step["c"]}},
                                js.cfg.local_epochs))
        tev.append(ts.on_update(cid, {
            "w": tm["w"] + torch.from_numpy(step["w"]),
            "b.c": tm["b.c"] + torch.from_numpy(step["c"])},
            ts.cfg.local_epochs))
    return jev, tev


@pytest.mark.parametrize("kw", [
    {"cohorts": "on"},
    {"cohorts": "on", "dispatch_compression": "topk:0.2",
     "compression": "topk:0.3"},
    {"cohorts": "off", "dispatch_compression": "int8"},
], ids=["edge-broadcast", "edge-topk-both-ways", "off-int8"])
def test_server_rounds_match_jax(kw):
    """Same-version uploads merge into one slot (contributors listed
    through ``merged_cids``), the trigger counts uploads, and the
    aggregation sees the merged mass; the uplink is measured against the
    delivered reconstruction.  Weights within 1e-5 (the merge's f32 mean
    differs from XLA's fused one in the last ulp), the global within
    1e-5; everything else equal."""
    js, ts = servers(**kw)
    assert ts.start() == js.start()
    rng = np.random.default_rng(1)
    for _ in range(4):
        jev, tev = upload_round(js, ts, rng)
        for je, te in zip(jev, tev):
            assert (je is None) == (te is None)
            if je is not None:
                assert te.contributors == je.contributors
                assert te.dispatch == je.dispatch
                np.testing.assert_array_equal(te.staleness, je.staleness)
                np.testing.assert_allclose(te.weights, je.weights, atol=1e-5)
        assert ts.cohort_stats() == js.cohort_stats()
        assert ts.resident_state_bytes() == js.resident_state_bytes()
        assert (ts.bytes_uploaded, ts.bytes_downloaded) == \
            (js.bytes_uploaded, js.bytes_downloaded)
    np.testing.assert_allclose(ts.global_flat.numpy(),
                               np.asarray(js.global_flat), atol=1e-5)
    if kw["cohorts"] == "on":
        assert js.cohort_stats()["edge_merges_total"] > 0
    state = ts.state_dict()
    assert state.keys() == js.state_dict().keys()
    assert ("edge_slots" in state) == (kw["cohorts"] == "on")


def test_edge_merge_is_the_sample_weighted_mean():
    """Two same-version uploads land in one slot holding their n-weighted
    mean; the second upload's row goes back to the free pool."""
    _, ts = servers(cohorts="on")
    ts.start()
    a, b = sorted(ts.active)[:2]
    flat = ts.global_flat
    ua, ub = flat + 1.0, flat - 3.0
    ts.on_update(a, ts.packer.unpack(ua), 1)
    ts.on_update(b, ts.packer.unpack(ub), 1)
    assert len(ts.buffer) == 1 and ts._updates_since_agg == 2
    head = ts.buffer.updates()[0]
    assert head.meta["merged_cids"] == [a, b]
    na, nb = ts.client_sizes[a], ts.client_sizes[b]
    assert head.n_samples == na + nb
    want = (na * ua + nb * ub) / (na + nb)
    torch.testing.assert_close(ts.buffer.row(0), want, rtol=0, atol=1e-6)


def test_off_mode_has_no_edge_tier_and_the_old_state_shape():
    """``cohorts='off'``: no merge, the trigger counts committed slots, and
    the state_dict has no edge keys, as the JAX server's."""
    js, ts = servers()
    ts.start()
    js.start()
    for cid in sorted(ts.active)[:2]:
        ts.on_update(cid, ts.dispatch_model(cid), 1)
        js.on_update(cid, js.dispatch_model(cid), 1)
    assert len(ts.buffer) == 2 and ts.cohort_stats() is None
    assert ts.state_dict().keys() == js.state_dict().keys()
    assert "edge_slots" not in ts.state_dict()
    assert ts.dispatch is None and ts.state_dict()["dispatch"] is None


def test_checkpoint_under_another_mode_drops_tracking_with_a_warning():
    """A cohort-mode dispatch state cannot seed a per-client session (or
    the reverse), nor one of another scheme: tracking is dropped and every
    client re-requests a full snapshot, as in the JAX server."""
    js, ts = servers(cohorts="on", dispatch_compression="topk:0.2")
    ts.start()
    js.start()
    upload_round(js, ts, np.random.default_rng(1))
    state, trees = ts.state_dict(), ts.checkpoint_trees()
    for kw in ({"cohorts": "off", "dispatch_compression": "topk:0.2"},
               {"cohorts": "on", "dispatch_compression": "int8"}):
        _, other = servers(**kw)
        with pytest.warns(UserWarning, match="dropping tracking state"):
            other.load_state(state, trees)
        assert other.dispatch.versions == {}
    _, plain = servers()
    with pytest.warns(UserWarning, match="dispatch_compression=None"):
        plain.load_state(state, trees)
    assert plain.dispatch is None
