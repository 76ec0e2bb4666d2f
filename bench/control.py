"""Readings that set a cell's limits: the program against the reference
over many seeds, and the control and the planted faults against the
reference over a few, at the cell's own size.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 ... [--control 3]

For each seed: the cell's federation is built as a run builds it, driven
through its warm round and to the first aggregation the check may keep,
and the program's numbers (``bench/check.py``) are read.  For the first
``--control`` seeds also: the control, the reference computed one
precision below the configuration's (fp8 products for bf16 training, TF32
operands for the f32 aggregation), put in the program's place; and the
planted faults the check has to catch: half of each batch left out
(training), the global returned unchanged and half of the rows left out
(aggregation).  One JSON line a seed; the runs of the harness itself do
not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent / "src"), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(cell: str, seed: int, control: bool, device,
             conf: dict | None = None, traffic: dict | None = None) -> dict:
    import torch

    from bench import check, federation

    dev = torch.device(device)
    fed = federation.build(cell, seed, dev, conf=conf, traffic=traffic)
    agg = check.AggregationProbe(fed, 2)
    probe = check.TrainingProbe(fed)
    probe.install()
    fed.sim.run(max_rounds=1)
    probe.remove()
    fed.sim.run(max_rounds=2)
    fed.server = fed.sim = fed.clients = fed.model = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"cell": cell, "seed": seed, "program": {}}
    model, tr = fed.conf["model"], fed.traffic
    ref = check.reference_training(model, seed, probe.batches, probe.lr,
                                   dev, keep=True)
    ref_grads, ref = ref[3], ref[:3]
    prog = (probe.loss, probe.grad, probe.change)
    diff = {n: float(torch.linalg.vector_norm(
        probe.grads[n].float() - ref_grads[n].float())) for n in ref_grads}
    out["program"].update(check.training_gaps(prog, ref, diff))
    keep = check.kept_leaves(ref[1])
    out["leaves"] = {what: check.leaf_gaps(prog[i], ref[i], keep)
                     for i, what in ((1, "grad"), (2, "change"))}
    out["losses"] = [probe.loss, ref[0]]
    if control:
        ctl = check.reference_training(model, seed, probe.batches,
                                       probe.lr, dev, precision="fp8",
                                       against=ref_grads)
        half = check.reference_training(model, seed, probe.batches,
                                        probe.lr, dev, half=True,
                                        against=ref_grads)
        out["control"] = check.training_gaps(ctl[:3], ref, ctl[3])
        out["control_leaves"] = {
            what: check.leaf_gaps(ctl[i], ref[i], keep)
            for i, what in ((1, "grad"), (2, "change"))}
        out["fault_half_batch"] = check.training_gaps(half[:3], ref, half[3])
        # a step that returns its state unchanged reads 1 by measure
    kept = agg.kept
    rows = list(kept["rows"].unbind(0))
    sizes = check.shard_sizes(fed)
    ref_new, ref_w = check.reference_aggregation(kept, rows, sizes, tr)
    out["program"].update(check.aggregation_gaps(
        kept["new"], kept["weights"], ref_new, ref_w))
    if control:
        c_new, c_w = check.reference_aggregation(kept, rows, sizes, tr,
                                                 precision="tf32")
        out["control"] = {**out["control"], **check.aggregation_gaps(
            c_new, c_w.cpu().numpy(), ref_new, ref_w)}
        out["fault_unchanged_global"] = check.aggregation_gaps(
            kept["g"], ref_w.cpu().numpy(), ref_new, ref_w)
        half = dict(kept, meta=kept["meta"][:len(rows) // 2])
        h_new, h_w = check.reference_aggregation(
            half, rows[:len(rows) // 2], sizes, tr)
        out["fault_half_rows"] = check.aggregation_gaps(
            h_new, h_w.cpu().numpy(), ref_new, ref_w)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(args.workload, seed, i < args.control,
                                  "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
