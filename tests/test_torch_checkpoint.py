"""The port's checkpointer and server state against the JAX package's.

* The reference's eight ``tests/test_checkpoint.py`` tests, run against
  ``repro_torch.checkpoint``.
* The on-disk format is shared: a tree saved by either package loads in the
  other, bf16 leaves included; a JAX checkpoint restores onto DTensor
  placements on a fake 8-rank mesh (``load_tree(shardings=...)``), and the
  update buffer and a cohort residual stay plain tensors on every mesh.
* The reference's server-state cases (``tests/test_transport.py``): the
  buffer kept under sync-wait, a mid-stream upload dropped while committed
  slots are kept, stale EF residuals guarded, legacy tree residuals packed.
* A JAX server checkpointed mid-round under the top-k uplink restores into
  both packages' servers, and both replay the same 3 aggregations: event
  times, contributors and staleness identical, weights and globals within
  1e-5 (the slice's gates, PERF.md section 2).  Saved again by the port,
  its manifest and extra state equal the JAX package's.
* A JAX checkpoint of internvl2-1b's cohort trainer (a vlm: its flat ends
  with ``patch_proj.w``) restores in the port's trainer, and both go on
  alike.
"""
import contextlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_integration_fl import exp_cfg  # noqa: E402
from test_torch_slice import _port_cfg, _record_events  # noqa: E402

from repro import checkpoint as J  # noqa: E402
from repro.experiment import build_experiment as jax_build  # noqa: E402
from repro_torch.checkpoint import Checkpointer, load_tree, save_tree  # noqa: E402
from repro_torch.core.server import FLConfig, SeaflServer  # noqa: E402
from repro_torch.experiment import build_experiment  # noqa: E402


# ----------------------------------------- the reference's eight, on the port

@pytest.fixture
def tree():
    return {"a": torch.ones((3, 4), dtype=torch.bfloat16),
            "b": {"c": torch.arange(5), "d": torch.linspace(0, 1, 7)}}


def test_roundtrip_with_structure(tmp_path, tree):
    p = str(tmp_path / "ck")
    save_tree(p, tree, {"round": 7})
    out, extra = load_tree(p, like=tree)
    assert extra["round"] == 7
    assert out["a"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["b"]["d"].numpy(), tree["b"]["d"].numpy())


def test_roundtrip_without_like(tmp_path, tree):
    p = str(tmp_path / "ck")
    save_tree(p, tree)
    out, _ = load_tree(p)
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(5))


def test_crc_detects_corruption(tmp_path, tree):
    p = str(tmp_path / "ck")
    save_tree(p, tree)
    # corrupt the arrays file
    f = os.path.join(p, "arrays.npz")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(Exception):
        load_tree(p, like=tree)


def test_atomic_commit_never_corrupts_latest(tmp_path, tree):
    """A stale .tmp dir from a crashed save must not break a later save."""
    p = str(tmp_path / "ck")
    os.makedirs(p + ".tmp")
    open(os.path.join(p + ".tmp", "junk"), "w").write("crash residue")
    save_tree(p, tree)
    out, _ = load_tree(p, like=tree)
    assert out["a"].shape == (3, 4)


def test_keep_last_k_gc(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in [1, 2, 3, 4]:
        ck.save(s, tree, {"s": s})
    assert ck.steps() == [3, 4]
    step, out, extra = ck.restore(like=tree)
    assert step == 4 and extra["s"] == 4


def test_async_save_then_restore(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=True)
    ck.save(1, tree, {"s": 1})
    ck.wait()
    step, out, extra = ck.restore(like=tree)
    assert step == 1
    np.testing.assert_allclose(out["a"].float().numpy(), 1.0)


def test_restore_specific_step(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=5, async_save=False)
    for s in [1, 2, 3]:
        t = {"a": tree["a"] * s, "b": {k: v * s for k, v in tree["b"].items()}}
        ck.save(s, t, {"s": s})
    step, out, extra = ck.restore(step=2, like=tree)
    assert step == 2
    np.testing.assert_allclose(out["a"].float().numpy(), 2.0)


def test_empty_restore(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    step, out, extra = ck.restore(like=tree)
    assert step is None and out is None


def test_async_save_copies_before_it_returns(tmp_path):
    """The server overwrites its tensors in place while the thread writes:
    the checkpoint holds the values at save()."""
    x = torch.arange(1000, dtype=torch.float32)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, {"x": x})
    x.fill_(-1.0)
    ck.wait()
    _, out, _ = ck.restore()
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(1000))


def test_shardings_are_refused(tmp_path, tree):
    """Restoring onto a mesh needs ``like`` and a sharding record for every
    leaf; anything less is refused."""
    save_tree(str(tmp_path / "ck"), tree)
    with pytest.raises(ValueError, match="like"):
        load_tree(str(tmp_path / "ck"), shardings={})
    with pytest.raises(ValueError, match="no sharding"):
        load_tree(str(tmp_path / "ck"), like=tree, shardings={})


def test_a_jax_checkpoint_restores_onto_placements(tmp_path):
    """A parameter tree saved by the JAX package restores onto the port's
    placements on a fake 8-rank (pod, data, model) mesh: on every rank each
    leaf is a DTensor whose local shard is that rank's slice of the saved
    array, by the reference's parameter specs."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro.configs import smoke_config as jsmoke
    from repro.models.model import LM as JLM
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    from repro_torch.models.model import LM
    from repro_torch.sharding import axis_rules, named_sharding, param_pspecs

    jp = JLM(jsmoke("qwen3-32b")).init(jax.random.PRNGKey(4))
    J.save_tree(str(tmp_path / "ck"), jp)
    full = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    like = LM(smoke_config("qwen3-32b"), "meta").init()
    sharded = 0
    for rank in range(8):
        with fake_process_group(8, rank=rank):
            mesh = make_mesh((2, 2, 2), device_type="cpu")
            with axis_rules(mesh) as rules:
                sh = named_sharding(mesh, param_pspecs(like, rules))
            out, _ = load_tree(str(tmp_path / "ck"), like=like,
                               shardings=sh, device="cpu")
            for path, leaf in _flat(out).items():
                s = _flat(sh)[path]
                assert tuple(leaf.placements) == s.placements, path
                shape, off = compute_local_shape_and_global_offset(
                    leaf.shape, mesh, list(s.placements))
                want = _flat(full)[path][tuple(
                    slice(o, o + n) for o, n in zip(off, shape))]
                np.testing.assert_array_equal(
                    leaf.to_local().to(torch.float32).numpy(), want, path)
                sharded += tuple(shape) != tuple(leaf.shape)
    assert sharded > 0          # some leaves really were split


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh_shape", [None, (2, 4), (2, 2, 2)])
def test_the_buffer_is_placed_as_the_reference_places_it(mesh_shape):
    """The update buffer (allocated, then grown by a third add) and a cohort
    table's residual, placed as the reference places them
    (``shard_update_buffer``, ``shard_cohort_state``): plain tensors, bit
    for bit what was written, off a mesh and on one without a 'pod' axis;
    on a (pod, data, model) mesh DTensors whose rows (the residual's
    elements) shard over 'pod', the residual's shard on this rank exactly
    its half.  The buffer's bytes are the whole array's either way."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.buffer import Update, UpdateBuffer
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    from repro_torch.runtime.cohorts import CohortTable
    from repro_torch.sharding import axis_rules

    rows = [torch.linspace(-1, 1, 10) * (i + 1) for i in range(4)]
    with contextlib.ExitStack() as stack:
        if mesh_shape is not None:
            stack.enter_context(fake_process_group(8))
            stack.enter_context(axis_rules(make_mesh(mesh_shape,
                                                     device_type="cpu")))
        buf = UpdateBuffer(2, device="cpu")
        for r in rows[:3]:                     # the third add grows it
            buf.add(Update(0, 1, 0, 1), r)
        buf.merge_rows(0, 2, 1.0, 1.0)
        table = CohortTable()
        table.move(0, ("c", 1), implied=lambda: rows[3])
    assert buf.hbm_bytes == 4 * 10 * 4
    res = table.residual_vec(("c", 1))
    if mesh_shape == (2, 2, 2):
        over_pod = [Shard(0), Replicate(), Replicate()]
        assert isinstance(buf._buf, DTensor)
        assert list(buf._buf.placements) == over_pod
        assert buf._rows.shape == (2, 10)      # this pod's 2 of the 4 rows
        assert isinstance(res, DTensor) and list(res.placements) == over_pod
        assert torch.equal(res.to_local(), rows[3][:5])
        return
    assert type(buf.stacked_flat()) is torch.Tensor
    assert torch.equal(buf.stacked_flat(), torch.stack(
        [(rows[0] + rows[2]) / 2, rows[1], rows[2]]))
    assert type(res) is torch.Tensor and torch.equal(res, rows[3])


# ------------------------------------------------------ one format, both ways

def _jax_tree():
    return {"a": jnp.asarray(np.linspace(-2, 2, 12).reshape(3, 4),
                             jnp.bfloat16),
            "b": {"c": jnp.arange(5, dtype=jnp.int32),
                  "d": jnp.linspace(0, 1, 7)}}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(jnp.bfloat16)
        return x.numpy()
    return np.asarray(x)


def test_a_jax_checkpoint_loads_in_the_port_and_back(tmp_path):
    jt = _jax_tree()
    J.save_tree(str(tmp_path / "j"), jt, {"round": 3})
    got, extra = load_tree(str(tmp_path / "j"))
    assert extra == {"round": 3} and got["a"].dtype == torch.bfloat16
    for k, want in (("a", jt["a"]), ("c", jt["b"]["c"]), ("d", jt["b"]["d"])):
        g = got["a"] if k == "a" else got["b"][k]
        np.testing.assert_array_equal(_as_np(g), np.asarray(want))
    save_tree(str(tmp_path / "t"), got, extra)
    back, extra2 = J.load_tree(str(tmp_path / "t"), like=jt)
    assert extra2 == extra
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")


def _manifest(path):
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------------ server state

def make_server(algorithm="seafl", n=12, M=6, K=3, beta=4.0, **kw):
    params = {"w": torch.zeros((11, 7)), "b": {"c": torch.zeros((13,))}}
    cfg = FLConfig(algorithm=algorithm, n_clients=n, concurrency=M,
                   buffer_size=K, staleness_limit=beta, seed=0, **kw)
    return SeaflServer(cfg, params, {i: 10 * (i + 1) for i in range(n)},
                       device="cpu")


def perturbed(base, rng, scale=0.1):
    return {k: v + scale * torch.from_numpy(
        rng.normal(size=tuple(v.shape)).astype(np.float32))
        for k, v in base.items()}


def drive_to_nonempty_blocked_buffer(s, rng):
    """Freeze one client so sync-wait engages with a non-empty buffer."""
    frozen = sorted(s.active)[0]
    for _ in range(60):
        if len(s.buffer) >= s.buffer.capacity and s._blocked_by_stale():
            return frozen
        live = [c for c in sorted(s.active) if c != frozen]
        cid = min(live, key=lambda c: (s.active[c], c))
        s.on_update(cid, perturbed(s.params_at(s.active[cid]), rng), 5)
    raise AssertionError("never reached blocked+non-empty state")


def test_checkpoint_preserves_buffer_under_sync_wait():
    s = make_server(beta=2.0, K=3)
    s.start()
    rng = np.random.default_rng(6)
    frozen = drive_to_nonempty_blocked_buffer(s, rng)
    assert len(s.buffer) > 0
    state, trees = s.state_dict(), s.checkpoint_trees()
    assert any(k.startswith("slot") for k in trees)
    s2 = make_server(beta=2.0, K=3)
    s2.load_state(state, trees)
    assert len(s2.buffer) == len(s.buffer)
    assert torch.equal(s2.buffer.stacked_flat(), s.buffer.stacked_flat())
    assert [u.client_id for u in s2.buffer.updates()] == \
        [u.client_id for u in s.buffer.updates()]
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for srv, rng_x in ((s, rng_a), (s2, rng_b)):
        w = perturbed(srv.params_at(srv.active[frozen]), rng_x)
        assert srv.on_update(frozen, w, n_epochs=5) is not None
    np.testing.assert_allclose(s2.global_flat.numpy(), s.global_flat.numpy(),
                               atol=1e-6)


def test_checkpoint_mid_stream_drops_pending_keeps_committed():
    s = make_server(chunk_elems=13)
    s.start()
    rng = np.random.default_rng(8)
    cid0 = sorted(s.active)[0]
    s.on_update(cid0, perturbed(s.params_at(s.active[cid0]), rng), 5)
    cid1 = sorted(s.active)[0]
    payload = s.encode_update(
        cid1, perturbed(s.params_at(s.active[cid1]), rng), 5)
    s.begin_ingest(payload.cid, payload.version, payload.n_epochs)
    for c in payload.chunks[: len(payload.chunks) // 2]:
        s.ingest_chunk(payload.cid, c)
    assert s.buffer.streaming
    state, trees = s.state_dict(), s.checkpoint_trees()
    assert len(state["buffer"]) == 1          # committed only
    s2 = make_server(chunk_elems=13)
    s2.load_state(state, trees)
    assert len(s2.buffer) == 1 and not s2.buffer.streaming
    assert cid1 in s2.active                  # will be re-dispatched/re-sent
    s2.ingest_payload(s2.encode_update(
        cid1, perturbed(s2.params_at(s2.active[cid1]), rng), 5))
    assert len(s2.buffer) == 2


def test_load_state_guards_stale_ef_residuals():
    s = make_server(compression="topk:0.25")
    s.start()
    rng = np.random.default_rng(9)
    for _ in range(3):
        cid = sorted(s.active)[0]
        s.on_update(cid, perturbed(s.params_at(s.active[cid]), rng), 5)
    state, trees = s.state_dict(), s.checkpoint_trees()
    assert any(k.startswith("ef") for k in trees)
    s2 = make_server()                        # compression=None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s2.load_state(state, trees)
    assert any("residual" in str(w.message) for w in caught)
    assert not s2._ef
    cid = sorted(s2.active)[0]
    s2.on_update(cid, perturbed(s2.params_at(s2.active[cid]), rng), 5)


def test_load_state_restores_legacy_pytree_residuals():
    s = make_server(compression="topk:0.25")
    s.start()
    rng = np.random.default_rng(10)
    for _ in range(2):
        cid = sorted(s.active)[0]
        s.on_update(cid, perturbed(s.params_at(s.active[cid]), rng), 5)
    state, trees = s.state_dict(), s.checkpoint_trees()
    legacy = {k: (s.packer.unpack(v) if k.startswith("ef") else v)
              for k, v in trees.items()}
    s2 = make_server(compression="topk:0.25")
    s2.load_state(state, legacy)
    for cid in s._ef:
        np.testing.assert_allclose(s2._ef[cid].residual.numpy(),
                                   s._ef[cid].residual.numpy(), atol=1e-7)


# ------------------------------------------------ cross-package replay

def test_jax_checkpoint_replays_in_both_packages(tmp_path):
    """JAX's simulation under topk:0.25, stopped mid-round with committed
    slots and EF residuals, checkpointed to disk; restored into a fresh
    JAX server and a fresh port server, each run 3 more aggregations."""
    _replay_jax_checkpoint(tmp_path, exp_cfg("seafl", compression="topk:0.25"))


def test_jax_checkpoint_with_dispatch_and_cohorts_replays(tmp_path):
    """The same under a top-k downlink with cohort state: the checkpoint
    carries the versions, the cohort table and its residuals (``cr*``),
    the edge partials and the upload counter, and both packages go on
    from it alike (the downlink bytes and resync counts too)."""
    js, jsim2, tsim = _replay_jax_checkpoint(tmp_path, exp_cfg(
        "seafl", compression="topk:0.25", dispatch_compression="topk:0.1",
        cohorts="on", dispatch_resync=0.5))
    assert js.state_dict()["dispatch"]["cohort"]["res_keys"]
    assert "edge_slots" in js.state_dict()
    jd, td = jsim2.server.dispatch, tsim.server.dispatch
    assert td.cache_info() == jd.cache_info()
    assert (td.full_dispatches, td.delta_dispatches, td.resync_dispatches) \
        == (jd.full_dispatches, jd.delta_dispatches, jd.resync_dispatches)
    assert tsim.server.bytes_downloaded == jsim2.server.bytes_downloaded
    assert td.table.stats() == jd.table.stats()


def _replay_jax_checkpoint(tmp_path, jc):
    jsim, jmodel, _ = jax_build(jc)
    params0 = jax.tree.map(np.asarray,
                           jmodel.init(jax.random.PRNGKey(jc.seed)))
    jsim.run(max_rounds=2)
    js = jsim.server
    while len(js.buffer) == 0:                 # on, event by event
        jsim.run(max_time=jsim._heap[0].time)
    assert js.round == 2 and js._ef
    path = str(tmp_path / "jax")
    J.save_tree(path, js.checkpoint_trees(), js.state_dict())

    jsim2, _, _ = jax_build(jc)
    jt, jextra = J.load_tree(path)
    jsim2.server.load_state(jextra, jt)
    tsim, _, _ = build_experiment(_port_cfg(jc), params=params0)
    tt, textra = load_tree(path)
    tsim.server.load_state(textra, tt)
    assert tsim.server.state_dict() == jsim2.server.state_dict()

    # saved again by the port: the same manifest and extra as JAX's
    again = str(tmp_path / "port")
    save_tree(again, tsim.server.checkpoint_trees(), tsim.server.state_dict())
    assert _manifest(again) == _manifest(path)

    j_events, t_events = _record_events(jsim2), _record_events(tsim)
    j_hist = jsim2.run(max_rounds=js.round + 3)
    t_hist = tsim.run(max_rounds=js.round + 3)
    assert len(j_events) == len(t_events) == 3
    assert [(h["time"], h["round"], h["bytes"]) for h in t_hist] == \
        [(h["time"], h["round"], h["bytes"]) for h in j_hist]
    for j, t in zip(j_events, t_events):
        assert t.contributors == j.contributors and t.dispatch == j.dispatch
        np.testing.assert_array_equal(t.staleness, j.staleness)
        np.testing.assert_allclose(t.weights, j.weights, atol=1e-5)
    np.testing.assert_allclose(tsim.server.global_flat.numpy(),
                               np.asarray(jsim2.server.global_flat),
                               atol=1e-5)
    # and the port's checkpoint restores into a JAX server
    js3 = jax_build(jc)[0].server
    back, extra = J.load_tree(again)
    js3.load_state(extra, back)
    assert js3.state_dict() == js.state_dict()
    want, got = js.checkpoint_trees(), js3.checkpoint_trees()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    return js, jsim2, tsim


def test_jax_checkpoint_of_a_vlm_trainer_restores_in_the_port(tmp_path,
                                                              monkeypatch):
    """internvl2-1b's f32 smoke cohort trainer (image embeddings in every
    batch): the JAX server after one aggregation, checkpointed to disk,
    restores into the port's ``build_lm_fl`` server with the same state,
    the same trees and the same global bit for bit (``patch_proj.w``'s
    values last in the flat); then both go on for one more aggregation
    from it: event times, contributors and staleness identical, the global
    within 1e-4 (the cohort trainer's replay bound)."""
    import repro.launch.train as JT
    from repro.configs import smoke_config as j_smoke_config
    from repro.runtime.simulator import FLSimulation as JSim
    from repro.runtime.simulator import SimConfig as JSimConfig
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import build_lm_fl
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    f32 = dict(param_dtype="float32", dtype="float32")
    jc = j_smoke_config("internvl2-1b").replace(**f32)
    monkeypatch.setattr(JT, "smoke_config", lambda name: jc)
    kw = dict(n_clients=4, concurrency=2, buffer_size=2, seq_len=16,
              shard_seqs=8, local_epochs=1, seed=0)
    jmodel, js, jclients, jeval = JT.build_lm_fl("internvl2-1b", **kw)
    JSim(js, jclients, JSimConfig(seed=0), eval_fn=jeval).run(max_rounds=1)
    assert js.round == 1
    path = str(tmp_path / "jax")
    J.save_tree(path, js.checkpoint_trees(), js.state_dict())

    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    sims = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            _, s2, clients, ev = JT.build_lm_fl("internvl2-1b", **kw)
            trees, extra = J.load_tree(path)
            sim = JSim(s2, clients, JSimConfig(seed=0), eval_fn=ev)
        else:
            _, s2, clients, ev = build_lm_fl(
                smoke_config("internvl2-1b").replace(**f32), device="cpu",
                params=params, **kw)
            trees, extra = load_tree(path)
            sim = FLSimulation(s2, clients, SimConfig(seed=0), eval_fn=ev)
        s2.load_state(extra, trees)
        sims.append(sim)
    jsim, tsim = sims
    ts = tsim.server
    assert ts.state_dict() == jsim.server.state_dict() == js.state_dict()
    assert ts.packer.names[-1] == "patch_proj.w"
    np.testing.assert_array_equal(ts.global_flat.numpy(),
                                  np.asarray(js.global_flat))
    want = js.checkpoint_trees()
    got = ts.checkpoint_trees()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_as_np(got[k]), np.asarray(want[k]))

    j_events, t_events = _record_events(jsim), _record_events(tsim)
    j_hist = jsim.run(max_rounds=2)
    t_hist = tsim.run(max_rounds=2)
    assert [(h["time"], h["round"]) for h in t_hist] == \
        [(h["time"], h["round"]) for h in j_hist]
    assert len(j_events) == len(t_events) == 1
    for j, t in zip(j_events, t_events):
        assert t.contributors == j.contributors
        np.testing.assert_array_equal(t.staleness, j.staleness)
    np.testing.assert_allclose(ts.global_flat.numpy(),
                               np.asarray(jsim.server.global_flat),
                               atol=1e-4)
