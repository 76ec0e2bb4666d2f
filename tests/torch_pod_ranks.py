"""One rank of ``test_torch_dist_pod.py``: the SEAFL simulation
(``experiment.build_experiment`` and the simulator's ``run``, the path
``run_experiment`` takes) inside ``sharding.axis_rules`` of a ('pod',
'data', 'model') mesh of 4 gloo ranks on the CPU, where the update buffer's
rows and the cohort residuals shard over 'pod'.  It imports ``repro_torch``
and never JAX: the test hands it the JAX model's initial parameters as a
numpy file.

    python tests/torch_pod_ranks.py <workdir> <rank> <world>

``<workdir>/cases.json`` lists the cases, ``<workdir>/params.npz`` holds
the initial parameters (``<path>`` keys joined by ``/``).  Each rank runs
every case on the case's mesh; rank 0 writes a case's outputs to
``<workdir>/<case>.out.npz`` and ``<case>.out.json``, and every rank
writes its collectives and what it holds of the buffer to
``<workdir>/rank.<rank>.json`` and ``rank.<rank>.npz``.  The test runs
the same :func:`run_case` off a mesh, in its own process, as the
one-device run.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.checkpoint.checkpointer import load_tree, save_tree
from repro_torch.core.buffer import Update, UpdateBuffer
from repro_torch.core.server import FLConfig
from repro_torch.experiment import ExperimentConfig, build_experiment
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_cost import trace_step
from repro_torch.runtime.simulator import SimConfig
from repro_torch.sharding import axis_rules

# the integration workload (tests/test_integration_fl.py::exp_cfg)
FL = dict(n_clients=16, concurrency=8, buffer_size=4, staleness_limit=5,
          local_epochs=3, local_lr=0.1, batch_size=32, seed=1)
EXP = dict(dataset="tiny", n_train=1600, n_test=320, model="mlp",
           dirichlet_alpha=1.0, seed=1)


def experiment_config(case) -> ExperimentConfig:
    """The case's ``exp_cfg`` on the CPU."""
    return ExperimentConfig(
        **EXP, fl=FLConfig(**dict(FL, algorithm=case["algorithm"],
                                  **case.get("fl", {}))),
        sim=SimConfig(**dict(seed=1, **case.get("sim", {}))), device="cpu")


def load_params(path):
    """The JAX layout's nested numpy tree from ``path``."""
    tree: dict = {}
    with np.load(path) as z:
        for k in z.files:
            *parts, last = k.split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = z[k]
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _np(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().to(torch.float32).numpy()


class Collectives(TorchDispatchMode):
    """Every functional collective this rank issues, below DTensor: its
    name, the shapes it is handed and the phase it ran in."""

    def __init__(self):
        super().__init__()
        self.log, self.phase = [], "run"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and name != "wait_tensor" and not name.startswith("_"):
            self.log.append([self.phase, name, [
                list(t.shape) for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)]])
        return out


def _phase(colls, label, fn):
    def wrapped(*a, **kw):
        prev, colls.phase = colls.phase, label
        try:
            return fn(*a, **kw)
        finally:
            colls.phase = prev
    return wrapped


def _instrument(sim, colls, aggs, events):
    """The server's aggregations (their events into ``events``) run under
    ``trace_step`` (their collectives, per kind, into ``aggs``), and every
    collective is labelled with the phase it ran in: an aggregation, a
    buffer growth, an edge merge or a checkpoint save."""
    server = sim.server
    agg = server._aggregate

    def traced(now):
        ev, cost, _ = trace_step(_phase(colls, "aggregate", agg), now)
        aggs.append({"counts": cost["coll_counts"], "bytes": cost["coll"],
                     "shapes": cost["coll_shapes"], "k": len(ev.staleness)})
        events.append(ev)
        return ev

    server._aggregate = traced
    server.checkpoint_trees = _phase(colls, "checkpoint",
                                     server.checkpoint_trees)


def _buffer_phases(colls):
    """UpdateBuffer's growth and row merge, labelled (class-wide: a restore
    builds a new buffer)."""
    UpdateBuffer._grow = _phase(colls, "growth", UpdateBuffer._grow)
    UpdateBuffer.merge_rows = _phase(colls, "merge", UpdateBuffer.merge_rows)


def _checkpoint(sim, workdir, name, rank, mesh):
    """The server's state and trees saved (by rank 0, the one-device run's
    own process off a mesh) and read back by every rank."""
    trees, state = sim.server.checkpoint_trees(), sim.server.state_dict()
    path = os.path.join(workdir, f"{name}.ck")
    if rank == 0:
        save_tree(path, trees, extra=state)
    if mesh is not None:
        dist.barrier()
    return load_tree(path)


def run_case(case, params, workdir, mesh=None, rank=0, colls=None):
    """(arrays, summary) of one case: the simulation run for the case's
    rounds, on ``mesh`` (inside its axis rules) or off a mesh.  A
    checkpoint case runs to two rounds and 1.5 simulated seconds more,
    saves, restores into a fresh simulation and runs on."""
    cfg = experiment_config(case)
    name = case["name"] + ("" if mesh is not None else ".one")
    colls = colls if colls is not None else Collectives()
    aggs, events, out, summary = [], [], {}, {}
    with (axis_rules(mesh) if mesh is not None else _null()), colls:
        sim, _, _ = build_experiment(cfg, params=params)
        _instrument(sim, colls, aggs, events)
        rounds = case.get("rounds", 4)
        if case.get("checkpoint"):
            sim.run(max_rounds=2)
            hist = list(sim.run(max_time=sim.history[-1]["time"] + 1.5))
            trees, state = _checkpoint(sim, workdir, name, rank, mesh)
            summary["checkpoint"] = {"state": state, "keys": sorted(trees)}
            out.update({f"ck/{k}": v.to(torch.float32).numpy()
                        for k, v in trees.items()})
            sim, _, _ = build_experiment(cfg, params=params)
            sim.server.load_state(state, trees)
            _instrument(sim, colls, aggs, events)
            hist += sim.run(max_rounds=rounds)   # the new simulation's
        else:
            hist = sim.run(max_rounds=rounds)
        server = sim.server
        buf = server.buffer._buf
        summary["buffer"] = {"type": type(buf).__name__, "placements": [
            str(p) for p in getattr(buf, "placements", ())],
            "rows": int(buf.shape[0])}
        summary["residuals"] = (
            [[type(v).__name__, [str(p) for p in getattr(v, "placements",
                                                          ())]]
             for v in server.dispatch.table._residual.values()]
            if hasattr(server.dispatch, "table") else [])
        out["global"] = _np(server.global_flat)
        out["weights"] = np.concatenate(
            [ev.weights for ev in events if ev.weights is not None]
            or [np.zeros(0, np.float32)])
        summary["history"] = [{k: h[k] for k in ("time", "round", "bytes",
                                                 "bytes_down", "acc")}
                              for h in hist]
        summary["events"] = [
            {"round": ev.round, "contributors": ev.contributors,
             "dispatch": ev.dispatch, "notify": ev.notify,
             "staleness": [float(s) for s in ev.staleness],
             "weights": ev.weights is not None} for ev in events]
        summary["cohort_stats"] = server.cohort_stats()
        summary["resident"] = server.resident_state_bytes()
        d = server.dispatch
        summary["dispatch"] = None if d is None else {
            "cache": d.cache_info(), "versions": {
                str(c): v for c, v in sorted(d.versions.items())},
            "counts": [d.full_dispatches, d.delta_dispatches,
                       d.resync_dispatches]}
        summary["spill_grow"] = server.tel.snapshot()["counters"].get(
            "buffer.spill_grow") if server.tel.enabled else None
    summary["aggregations"] = aggs
    return out, summary


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


P_PROTOCOL = 10


def buffer_protocol(mesh, dtype):
    """The slot protocol alone on ``mesh`` (or off a mesh): allocation at
    K = 4, chunked writes, one batched write, a spill that grows 4 rows to
    8, edge merges within a pod and across pods, and the reads.  Returns
    {step: this rank's rows of the slot array, or what it read}."""
    rng = np.random.default_rng(7)
    vals = [torch.from_numpy(rng.normal(size=P_PROTOCOL).astype(np.float32))
            for _ in range(8)]
    out = {}

    def held(step, buf):
        out[step] = buf._rows.to(torch.float32).numpy().copy()

    with (axis_rules(mesh) if mesh is not None else _null()):
        buf = UpdateBuffer(4, P_PROTOCOL, dtype=dtype, device="cpu")
        held("alloc", buf)
        for i in range(3):      # chunked: three windows a row
            s = buf.reserve(Update(i, 10 + i, 0, 1))
            for a, b in ((0, 4), (4, 7), (7, P_PROTOCOL)):
                buf.write_range(s, a, vals[i][a:b])
            buf.commit(s)
        s = buf.reserve(Update(3, 13, 0, 1))
        buf.write_batch([(s, 0, vals[3][:5]), (s, 5, vals[3][5:])])
        buf.commit(s)
        held("written", buf)
        for i in range(4, 6):   # no free row: the first reserve grows it
            buf.add(Update(i, 10 + i, 0, 1), vals[i])
        held("grown", buf)
        out["grown_rows"] = np.asarray(buf._buf.shape[0])
        buf.merge_rows(0, 1, 10.0, 11.0)    # within pod 0 on (2, 2, 1)
        buf.uncommit(1)
        buf.merge_rows(0, 5, 10.0, 15.0)    # across pods (0 and 1, or 2)
        buf.uncommit(5)
        held("merged", buf)
        out["rows"] = np.stack([_np(buf.row(i)) for i in range(len(buf))])
        local = buf.stacked_flat()
        if isinstance(local, torch.Tensor):
            out["stacked"] = local.to(torch.float32).numpy()
        else:
            out["stacked"] = local.rows.to(torch.float32).numpy()
            out["index"] = np.asarray(local.index, np.int64)
        out["placements"] = np.asarray([str(p) for p in getattr(
            buf._buf, "placements", ())])
    return out


def main(workdir: str, rank: int, world: int) -> int:
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        with open(os.path.join(workdir, "cases.json")) as f:
            cases = json.load(f)
        params = load_params(os.path.join(workdir, "params.npz"))
        meshes, report, held = {}, {}, {}
        colls = Collectives()
        _buffer_phases(colls)
        for case in cases:
            shape = tuple(case["mesh"])
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, device_type="cpu")
            colls.log = []
            if case.get("protocol"):
                got = buffer_protocol(meshes[shape],
                                      getattr(torch, case["dtype"]))
                held.update({f"{case['name']}/{k}": v
                             for k, v in got.items()})
                report[case["name"]] = {"collectives": colls.log}
                continue
            out, summary = run_case(case, params, workdir, meshes[shape],
                                    rank, colls)
            summary["collectives"] = colls.log
            report[case["name"]] = summary
            if rank == 0:
                np.savez(os.path.join(workdir, f"{case['name']}.out.npz"),
                         **out)
        report["jax_imported"] = any(m.split(".")[0] in ("jax", "repro")
                                     for m in sys.modules)
        with open(os.path.join(workdir, f"rank.{rank}.json"), "w") as f:
            json.dump(report, f, default=str)
        np.savez(os.path.join(workdir, f"rank.{rank}.npz"), **held)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
