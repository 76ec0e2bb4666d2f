"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's federation (``bench/federation.py``: weights and
data from the seed, the program's kernels from the checkout's build cache)
and runs one whole aggregation round, which warms every shape the window
uses.  The window then drives the program's simulator
(``FLSimulation.run``) one aggregation at a time.  It opens and closes at
aggregations after which no trained upload waits to be aggregated, closing
at the first such one after ``--seconds``, so it holds whole rounds and
their whole work; ``fl_round_s`` is its elapsed time over its rounds.

``--trace 1`` wraps the program's calls in the benchmark's spans, profiles
a stretch of whole rounds inside the window and reports the cell's
per-layer metrics (``bench/metrics/<name>.py``) and the breakdown.

After the window the program's state is freed and the cell's products are
held against the plain references (``bench/check.py``); the numbers
compared are printed with their limits, last on standard error and last in
the result line.  The result is the last line of standard output.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SETTLE_ROUNDS = 50


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def manifest(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(man: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` (end_to_end or per_layer) that ``cell``
    reports."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = HERE):
    """The ``read`` function of ``<root>/metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_call
    from repro_torch.kernels.seafl_agg import kernel as agg
    from repro_torch.kernels.ssd.kernel import ssd_forward_call
    return {"b1_launches": agg.sim_partials_from_params_call.launches,
            "b2_launches": agg.weighted_agg_call.launches,
            "b4_launches": flash_attention_call.launches,
            "b6_launches": ssd_forward_call.launches}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             man: dict, conf: dict | None = None,
             traffic: dict | None = None, t_start: float = T_START,
             root: Path = HERE, log=print) -> dict:
    """One run of ``cell``: set-up, the window, the check.  Returns the
    result line's object."""
    import numpy as np
    import torch

    from bench import check, federation
    from bench import trace as T

    dev = torch.device(device)
    t_build = time.perf_counter()
    fed = federation.build(cell, seed, dev, root=root, conf=conf,
                           traffic=traffic)
    _sync(dev)
    t_warm = time.perf_counter()
    tr, srv, sim = fed.traffic, fed.server, fed.sim
    agg = check.AggregationProbe(fed, 0)
    trained = [0]
    for c in fed.clients.values():
        def counted(*a, _f=c.local_train, **k):
            trained[0] += 1
            return _f(*a, **k)
        c.local_train = counted
    probe = check.TrainingProbe(fed)
    probe.install()

    def backlog():
        # uploads trained but not yet aggregated
        return trained[0] - agg.rows_total

    sim.run(max_rounds=1)                     # the warm round
    probe.remove()
    # set-up ends, and the window will end, at an aggregation after which
    # no trained upload waits: the window then holds its rounds' whole work
    # (training is lazy, so a round's uploads can be trained in the round
    # before)
    for _ in range(SETTLE_ROUNDS):
        if backlog() == 0:
            break
        sim.run(max_rounds=srv.round + 1)
    else:
        raise RuntimeError(f"no aggregation in {SETTLE_ROUNDS} rounds left "
                           f"no upload waiting")
    # the aggregation the check keeps: one of the window's first rounds
    agg.target = srv.round + 1 + int(np.random.default_rng(
        (int(seed), 3)).integers(tr["check_rounds"]))
    if trace:
        T.instrument(fed)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    # where set-up went: imports, the federation (weights, data, model),
    # the warm round with the check's probe
    log(f"setup {setup_s:.3f} s: imports {t_build - t_start:.3f}, "
        f"federation {t_warm - t_build:.3f}, warm round "
        f"{t_start + setup_s - t_warm:.3f}", file=sys.stderr)
    cuda = dev.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    r0 = srv.round
    skip, span = tr["trace_skip"], tr["trace_rounds"]
    prof = rng_ctx = rec = launches0 = None
    t0 = time.perf_counter()
    while True:
        # the traced stretch, like the window, opens and closes where no
        # trained upload waits, so it holds its rounds' whole work
        if (trace and rec is None and prof is None and backlog() == 0
                and srv.round >= r0 + skip):
            _sync(dev)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            rng_ctx = torch.profiler.record_function(T.STRETCH)
            rng_ctx.__enter__()
            first = srv.round + 1
            launches0 = _launches()
        before = srv.round
        sim.run(max_rounds=srv.round + 1)
        if srv.round == before:
            raise RuntimeError("the simulation ran out of events")
        if (rng_ctx is not None and srv.round >= first - 1 + span
                and backlog() == 0):
            _sync(dev)
            rng_ctx.__exit__(None, None, None)
            rng_ctx = None
            prof.__exit__(None, None, None)
            rec = T.reduce_trace(prof)
            launches = _launches()
            rec.counts = {k: launches[k] - launches0[k] for k in launches}
            rounds = range(first, srv.round + 1)
            rec.counts["agg_rows"] = [agg.rows_by_round[r] for r in rounds]
            rec.counts["params"] = srv.packer.size
            prof = None
        elapsed = time.perf_counter() - t0
        if (elapsed >= seconds and backlog() == 0 and srv.round >= agg.target
                and rng_ctx is None and (rec is not None or not trace)):
            break
        if elapsed > 3 * seconds + 120:
            raise RuntimeError(f"the window did not close at a whole round "
                               f"in {elapsed:.0f} s")
    _sync(dev)
    window_s = time.perf_counter() - t0
    rounds = srv.round - r0
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    result = {"correct": False, "attempted": rounds, "failed": 0}
    if trace:
        steps = tr["local_epochs"] * (tr["shard_seqs"] // tr["batch"])
        rec.counts["sgd_steps"] = steps * rec.count("client.local_train")
        rec.counts["evals"] = rec.count("eval")
        rec.cell = {"model": fed.conf["model"], "traffic": tr}
        rec.peak_bytes = peak_window
        for m in cell_metrics(man, cell, "per_layer"):
            value = reader(m["name"], root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = sum(b - a for a, b in rec.busy_intervals()) / 1e9
        result["breakdown"] = T.breakdown(rec)
    else:
        for m in cell_metrics(man, cell, "end_to_end"):
            value = {"fl_round_s": window_s / rounds,
                     "setup_s": setup_s}[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, with the program's state freed but what the probes kept
    del sim, srv
    fed.server = fed.sim = fed.clients = fed.model = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = check.judge(fed, probe, agg, dev)
    limits = tr["limits"]
    checks = {k: {"value": gaps[k], "limit": v} for k, v in limits.items()}
    result["correct"] = all(math.isfinite(c["value"])
                            and c["value"] <= c["limit"]
                            for c in checks.values())
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}
    if trace:
        result["device"].update(busy_s=busy, window_s=rec.seconds)
    for name, c in checks.items():
        log(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}",
            file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", man)
    found = forbidden_modules()
    if found:
        print(f"modules the benchmark must not load: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
