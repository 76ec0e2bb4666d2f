"""Dry run: trace every (arch x shape x mesh) cell on the meta device.

The port of the JAX package's ``launch/dryrun.py``.  Where the reference
lowers and compiles each cell on 512 fake host devices, the port sets up a
fake process group of the mesh's size (``launch/mesh.fake_process_group``,
in :func:`main` only: importing this module sets up nothing) and runs each
step once on meta tensors under ``launch/op_cost.trace_step``.  For each
cell it records:

  * ``op_cost``: flops, dot bytes, transcendentals, materialised bytes and
    collectives (``launch/op_cost.py``, the counterpart of ``hlo_cost``);
  * ``memory``: argument, output and alias (the donated argument) bytes per
    device, exact from each leaf's local shard shape; for an LM cell on a
    one-device mesh also ``peak_estimate_bytes``, the peak of live meta storage during the
    step (``torch.distributed._tools.mem_tracker.MemTracker``), arguments
    included.  The meta device runs each kernel route's plain translation
    (flash attention's chunked scores among them), so the estimate is the
    plain path's;
  * ``collectives``: per kind count and bytes.  An LM cell's step runs on
    whole tensors (the LM does not run on shards yet), so on a mesh of more
    than one device its collectives are not known: ``null``, with the
    reason.  The SEAFL aggregation cells run on DTensors with meta local
    shards and record the collectives they dispatch;
  * ``trace_seconds``, the counterpart of ``lower_seconds`` and
    ``compile_seconds``.

An LM cell's trace depends on the arch and shape, not on the mesh, so a run
over several meshes traces it once.

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all                # 16 x 16
    python -m repro_torch.launch.dryrun --all --multi-pod --agg
    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --agg \\
        --mesh 16x16 --mesh 2x16x16 --mesh 1x1

Records land in ``dryrun_out/<cell>.json`` at the repository's root (or
``--out``), one file a cell; ``--force`` re-runs cached cells.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "dryrun_out")

_PRODUCTION = {(16, 16): "pod16x16", (2, 16, 16): "pod2x16x16"}


def parse_mesh(text: str) -> tuple[int, ...]:
    return tuple(int(s) for s in text.lower().split("x"))


def mesh_tag(shape) -> str:
    shape = tuple(shape)
    return _PRODUCTION.get(shape, "mesh" + "x".join(map(str, shape)))


def cell_filename(arch: str, shape: str, mesh_shape) -> str:
    return f"{arch}__{shape}__{mesh_tag(mesh_shape)}.json"


def trace_cell(cell, peak: bool):
    """(outputs, op_cost, seconds, peak bytes or None) of one run of
    ``cell``'s step on its meta arguments."""
    import torch
    from repro_torch.launch.op_cost import trace_step
    from repro_torch.launch.specs import materialize
    args = materialize(cell, "meta")
    if not peak:
        out, cost, secs = trace_step(cell.step_fn, *args)
        return out, cost, secs, None
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*[t for t in torch.utils._pytree.tree_leaves(args)
                        if isinstance(t, torch.Tensor)])
    with mt:
        out, cost, secs = trace_step(cell.step_fn, *args)
    snap = mt.get_tracker_snapshot("peak")
    meta = [v for k, v in snap.items() if torch.device(k).type == "meta"]
    return out, cost, secs, int(meta[0]["Total"]) if meta else 0


def memory_record(cell, out) -> dict:
    """Per-device argument, output and alias bytes of ``cell`` (``out`` its
    step's outputs on the meta device)."""
    from repro_torch.launch.specs import device_bytes
    args = [device_bytes(a, s) for a, s in zip(cell.args, cell.in_shardings)]
    return {"argument_size_in_bytes": sum(args),
            "output_size_in_bytes": device_bytes(tuple(out),
                                                 cell.out_shardings),
            "alias_size_in_bytes": sum(args[i] for i in cell.donate_argnums)}


def collectives_record(cost: dict) -> dict:
    """Per kind count and bytes, their total, and the least time the total
    could take over one GPU's NVLink at its spec-sheet rate one way."""
    from repro_torch.kernels._common import NVLINK_BYTES_PER_S
    rec = {k: {"count": int(cost["coll_counts"][k]),
               "bytes": int(cost["coll"][k])} for k in cost["coll"]}
    rec["total_bytes"] = int(cost["coll_total_bytes"])
    rec["nvlink_bound_s"] = rec["total_bytes"] / NVLINK_BYTES_PER_S
    return rec


def run_cell(cell, mesh_shape, trace) -> dict:
    """The record of ``cell`` on a mesh of ``mesh_shape`` from its trace."""
    out, cost, secs, peak = trace
    n = math.prod(mesh_shape)
    rec = {"cell": cell.name, "batch": cell.extra.get("batch"),
           "mesh": {"shape": list(mesh_shape),
                    "axes": list(cell.mesh.mesh_dim_names)},
           "n_devices": n, "trace_seconds": round(secs, 3),
           "op_cost": cost, "memory": memory_record(cell, out)}
    if peak is not None and n == 1:
        rec["memory"]["peak_estimate_bytes"] = peak
    if cell.kind != "agg" and n > 1:
        rec["collectives"] = None
        rec["collectives_null_reason"] = (
            "the LM step runs on whole tensors, not on shards, so the "
            "collectives a sharded step needs are not known yet")
    else:
        rec["collectives"] = collectives_record(cost)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", action="append", default=None,
                    help="mesh shape such as 1x1 or 2x4 (repeatable); "
                         "default the production mesh")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut each shape's global batch to this (its "
                         "sequence length stays)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs at the published shapes")
    ap.add_argument("--agg", action="store_true",
                    help="also dry-run the SEAFL aggregation step per arch")
    ap.add_argument("--agg-slots", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=str, default=RESULTS_DIR)
    args = ap.parse_args(argv)

    from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                     list_configs, smoke_config)
    from repro_torch.launch.mesh import (fake_process_group, make_mesh,
                                         production_shape)
    from repro_torch.launch.specs import build_agg_cell, build_cell
    from repro_torch.sharding import axis_rules

    config = smoke_config if args.smoke else get_config
    meshes = ([parse_mesh(m) for m in args.mesh] if args.mesh
              else [production_shape(args.multi_pod)])
    os.makedirs(args.out, exist_ok=True)

    cells: list[tuple[str, str]] = []
    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        shapes = (applicable_shapes(config(arch))
                  if (args.all or args.shape is None) else [args.shape])
        cells += [(arch, s) for s in shapes]
        if args.agg:
            cells.append((arch, f"seafl_agg_k{args.agg_slots}"))

    traces: dict = {}
    failures = total = 0
    for mesh_shape in meshes:
        n = math.prod(mesh_shape)
        with fake_process_group(n):
            mesh = make_mesh(mesh_shape, device_type="cpu")
            for arch, shape in cells:
                total += 1
                fname = os.path.join(args.out,
                                     cell_filename(arch, shape, mesh_shape))
                if os.path.exists(fname) and not args.force:
                    print(f"[skip] {arch} x {shape} (cached)")
                    continue
                print(f"[cell] {arch} x {shape} ({mesh_tag(mesh_shape)}) "
                      "...", flush=True)
                try:
                    cfg = config(arch)
                    with axis_rules(mesh):
                        if shape.startswith("seafl_agg"):
                            cell = build_agg_cell(cfg, mesh, args.agg_slots)
                            trace = trace_cell(cell, peak=False)
                        else:
                            sh = SHAPES[shape]
                            if args.batch is not None:
                                sh = dataclasses.replace(
                                    sh, global_batch=args.batch)
                            cell = build_cell(cfg, sh, mesh)
                            if (arch, shape) not in traces:
                                traces[(arch, shape)] = trace_cell(cell, True)
                            trace = traces[(arch, shape)]
                        rec = run_cell(cell, mesh_shape, trace)
                    with open(fname, "w") as f:
                        json.dump(rec, f, indent=1)
                    m, c = rec["memory"], rec["collectives"]
                    print(f"   ok: flops={rec['op_cost']['flops']:.4e} "
                          f"arg/dev={m['argument_size_in_bytes']} "
                          f"out/dev={m['output_size_in_bytes']} "
                          f"alias/dev={m['alias_size_in_bytes']} "
                          f"peak={m.get('peak_estimate_bytes')} "
                          f"coll={None if c is None else c['total_bytes']} "
                          f"trace={rec['trace_seconds']}s", flush=True)
                except Exception as e:   # a failed cell is recorded, not fatal
                    failures += 1
                    print(f"   FAIL: {type(e).__name__}: {e}")
                    traceback.print_exc()
                    with open(fname + ".fail", "w") as f:
                        f.write(traceback.format_exc())
    print(f"done: {total - failures}/{total} cells ok")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
