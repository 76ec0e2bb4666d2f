"""The update buffer and the cohort residuals placed over 'pod', on the
fake process group of 8 (``launch.mesh.fake_process_group``): the
placement the reference gives them (``sharding.shard_update_buffer``,
``shard_cohort_state``), and the slot protocol on each rank's own rows.

On a (2, 2, 2) ('pod', 'data', 'model') mesh the (K, P) slot array is a
DTensor whose rows shard over 'pod' after allocation, chunked writes, a
batched write and a spill from 4 rows to 8, as
``tests/test_transport.py::test_buffer_sharded_over_pod_axis`` pins the
reference's; on (2, 4) ('data', 'model': no pod) and on a pod of one it
stays a plain tensor, and a run there is bit for bit the run off a mesh.
The fake group moves no data, so what a rank holds is checked where no
data crosses ranks: each of the 8 ranks writes only its own rows and holds
exactly them; an edge merge within a pod gives today's bits; across pods,
with the one row that moves handed over by a stand-in for the broadcast,
only the destination's pod writes, today's bits.  The gloo ranks of
``test_torch_dist_pod.py`` move the data for real.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.core.buffer import LocalRows, Update, UpdateBuffer  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.runtime.cohorts import CohortTable  # noqa: E402
from repro_torch.sharding import RowShards, axis_rules, placed_as  # noqa: E402

P_ = 10
OVER_POD = [Shard(0), Replicate(), Replicate()]


def _rows(n=8):
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.normal(size=P_).astype(np.float32))
            for _ in range(n)]


@contextlib.contextmanager
def _mesh(shape, rank=0):
    with fake_process_group(8, rank=rank):
        with axis_rules(make_mesh(shape, device_type="cpu")) as rules:
            yield rules.mesh


def _write_four(buf, vals):
    """Rows 0-2 in three chunked windows each, row 3 by one batched write
    of two windows: the transport's two write paths."""
    for i in range(3):
        s = buf.reserve(Update(i, 10 + i, 0, 1))
        for a, b in ((0, 4), (4, 7), (7, P_)):
            buf.write_range(s, a, vals[i][a:b])
        buf.commit(s)
    s = buf.reserve(Update(3, 13, 0, 1))
    buf.write_batch([(s, 0, vals[3][:5]), (s, 5, vals[3][5:])])
    buf.commit(s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_allocation_writes_and_growth_keep_the_rows_over_pod(dtype):
    vals = _rows()
    with _mesh((2, 2, 2)):
        buf = UpdateBuffer(4, P_, dtype=dtype, device="cpu")
        assert isinstance(buf._buf, DTensor)
        assert list(buf._buf.placements) == OVER_POD
        _write_four(buf, vals)
        assert list(buf._buf.placements) == OVER_POD
        for i in range(4, 6):           # the fifth add spills: 4 rows -> 8
            buf.add(Update(i, 1, 0, 1), vals[i])
        assert isinstance(buf._buf, DTensor) and buf._buf.shape == (8, P_)
        assert list(buf._buf.placements) == OVER_POD
        assert buf._rows.shape == (4, P_)        # each pod's own rows
        assert buf.hbm_bytes == 8 * P_ * buf._buf.element_size()
        local = buf.stacked_flat()
        assert isinstance(local, LocalRows) and local.k == 6


@pytest.mark.parametrize("shape", [None, (2, 4), (1, 2, 4)],
                         ids=["off-mesh", "2x4", "pod-of-one"])
def test_without_pods_the_buffer_is_the_plain_one(shape):
    vals = _rows()
    with (_mesh(shape) if shape else contextlib.nullcontext()):
        buf = UpdateBuffer(4, P_, device="cpu")
        _write_four(buf, vals)
        for i in range(4, 6):
            buf.add(Update(i, 1, 0, 1), vals[i])
        buf.merge_rows(0, 5, 1.0, 3.0)
        buf.uncommit(5)
        got = buf.stacked_flat()
    assert type(buf._buf) is torch.Tensor and type(got) is torch.Tensor
    want = torch.stack(vals[:5])
    want[0] = (1.0 * vals[0] + 3.0 * vals[5]) / 4.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("rank", range(8))
def test_each_rank_writes_and_holds_only_its_rows(rank):
    """Rank ``rank`` of the (2, 2, 2) mesh is pod ``rank // 4``: after the
    two write paths its shard is exactly rows [2 pod, 2 pod + 2) of what
    one device's buffer holds, and its committed rows are those rows, at
    their arrival indices."""
    vals = _rows()
    one = UpdateBuffer(4, P_, device="cpu")
    _write_four(one, vals)
    pod = rank // 4
    with _mesh((2, 2, 2), rank):
        buf = UpdateBuffer(4, P_, device="cpu")
        _write_four(buf, vals)
        held = buf._rows.clone()
        local = buf.stacked_flat()
    assert torch.equal(held, one._buf[2 * pod:2 * pod + 2])
    assert local.index == [2 * pod, 2 * pod + 1]
    assert torch.equal(local.rows, one.stacked_flat()[local.index])
    assert local.shards.index == pod and local.shards.n == 2


@pytest.mark.parametrize("rank", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_edge_merge_gives_todays_bits_within_and_across_pods(
        rank, dtype, monkeypatch):
    """Rows 0 and 1 lie on pod 0, row 3 on pod 1.  A merge within pod 0
    moves nothing; a merge of row 3 into row 0 moves one row (the stand-in
    for the broadcast hands over what pod 1 holds and counts it), and only
    pod 0 writes: its row 0 is one device's, bit for bit, and pod 1's rows
    stay as they were."""
    vals = _rows()
    one = UpdateBuffer(4, P_, dtype=dtype, device="cpu")
    _write_four(one, vals)
    moved = []

    def broadcast(shards, t, src):      # what pod ``src`` holds of row 3
        moved.append((src, tuple(t.shape)))
        return t if shards.index == src else one._buf[3].clone()

    monkeypatch.setattr(RowShards, "broadcast", broadcast)
    with _mesh((2, 2, 2), rank):
        buf = UpdateBuffer(4, P_, dtype=dtype, device="cpu")
        _write_four(buf, vals)
        before = buf._rows.clone()
        buf.merge_rows(0, 1, 10.0, 11.0)
        assert moved == []
        buf.merge_rows(0, 3, 21.0, 13.0)
        assert moved == [(1, (P_,))]
        held = buf._rows.clone()
    one.merge_rows(0, 1, 10.0, 11.0)
    one.merge_rows(0, 3, 21.0, 13.0)
    pod = rank // 4
    if pod == 0:
        assert torch.equal(held, one._buf[:2])
    else:
        assert torch.equal(held, before)


def test_the_row_moved_across_pods_is_the_sources(monkeypatch):
    """On the source's pod the broadcast is handed its own row."""
    vals = _rows()
    seen = []
    monkeypatch.setattr(RowShards, "broadcast",
                        lambda shards, t, src: seen.append(t.clone()) or t)
    with _mesh((2, 2, 2), rank=4):
        buf = UpdateBuffer(4, P_, device="cpu")
        _write_four(buf, vals)
        buf.merge_rows(0, 3, 1.0, 1.0)
    assert len(seen) == 1 and torch.equal(seen[0], vals[3])


@pytest.mark.parametrize("rank", [0, 4])
def test_a_cohort_residual_is_placed_over_pod_at_move_and_restore(rank):
    """A residual born at ``move`` and one read back by ``load_state`` are
    DTensors whose elements shard over 'pod', each rank holding its own
    half; the sum of a stored residual and a payload's plain error stays
    so (``placed_as``: no data moves)."""
    vec = torch.linspace(-1.0, 1.0, P_)
    pod = rank // 4
    with _mesh((2, 2, 2), rank):
        table = CohortTable()
        table.move(0, (1, None, "d"), implied=lambda: vec)
        born = table.residual_vec((1, None, "d"))
        restored = CohortTable()
        restored.load_state(table.state_dict(), {"cr0": vec.numpy()},
                            device="cpu")
        back = restored.residual_vec((1, None, "d"))
        summed = born + placed_as(vec, born)
        assert table.resident_bytes() == P_ * 4
    half = vec[pod * P_ // 2:(pod + 1) * P_ // 2]
    for r in (born, back, summed):
        assert isinstance(r, DTensor) and list(r.placements) == \
            [Shard(0), Replicate(), Replicate()]
    assert torch.equal(born.to_local(), half)
    assert torch.equal(back.to_local(), half)
    assert torch.equal(summed.to_local(), 2 * half)


@pytest.mark.parametrize("shape", [(2, 4), (1, 2, 4)],
                         ids=["2x4", "pod-of-one"])
def test_a_cohort_residual_stays_plain_without_pods(shape):
    vec = torch.linspace(-1.0, 1.0, P_)
    with _mesh(shape):
        table = CohortTable()
        table.move(0, (1, None, "d"), implied=lambda: vec)
    res = table.residual_vec((1, None, "d"))
    assert type(res) is torch.Tensor and torch.equal(res, vec)


def test_a_run_on_a_pod_of_one_is_the_run_off_a_mesh():
    """The SEAFL simulation (seafl2, a top-k downlink with cohorts, so
    that residuals and edge merges run too) inside the axis rules of a
    (1, 2, 4) mesh: nothing is placed, and every round's global and the
    downlink's bytes are bit for bit the run off a mesh's."""
    from test_integration_fl import exp_cfg
    from test_torch_slice import WIRE, _port_cfg
    import dataclasses
    from repro_torch.experiment import build_experiment

    jc = exp_cfg("seafl2", dispatch_compression="topk:0.1", cohorts="on",
                 resync_batching=True, dispatch_resync=0.5)
    jc.sim = dataclasses.replace(jc.sim, **WIRE)
    runs = []
    for shape in ((1, 2, 4), None):
        with (_mesh(shape) if shape else contextlib.nullcontext()):
            sim, _, _ = build_experiment(_port_cfg(jc))
            hist = sim.run(max_rounds=4)
            assert type(sim.server.buffer._buf) is torch.Tensor
            assert all(type(v) is torch.Tensor for v in
                       sim.server.dispatch.table._residual.values())
        runs.append((hist, sim.server))
    (h1, s1), (h2, s2) = runs
    assert [h["bytes_down"] for h in h1] == [h["bytes_down"] for h in h2]
    assert [h["time"] for h in h1] == [h["time"] for h in h2]
    for v in s2._history:
        assert torch.equal(s1._history[v], s2._history[v])
