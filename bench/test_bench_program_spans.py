"""The program's own spans (``seafl.<name>`` ranges, which the program
opens while a profiler records) change none of the benchmark's readings:
each per-layer metric and the breakdown read the same from a record with
them as from one without."""
from __future__ import annotations

import pytest

from bench import federation, run
from bench import trace as T

MS = 1_000_000
CELLS = ("mamba2-cohort", "phi4-cohort")
METRICS = [m["name"] for m in run.manifest()["per_layer"]]


def _record(cell: str, program_spans: bool) -> T.Record:
    """A hand-built stretch of 100 ms: the benchmark's spans, the
    program's two named backward ranges, kernels of every roofline with
    launch counts that match the traffic, gaps; with ``program_spans``
    the program's spans laid over it, some inside the benchmark's, some
    across their edges."""
    tr, conf = federation.load_cell(cell)
    n = conf["model"]["n_layers"]
    kernels = [("sim_partials_stage1", 80, 81, 80),
               ("weighted_agg", 81, 82, 81),
               ("flash_tc_kernel", 10, 14, 10),
               ("ssd_chunk_scan", 14, 18, 14),
               ("elementwise_kernel", 18, 30, 21),
               ("Memcpy DtoD", 40, 41, 39),
               ("reduce_kernel", 50, 60, None)]
    ranges = [("bench.client.local_train", 5, 35),
              ("flash_attention_backward", 20, 30),
              ("ssd_chunked_backward", 20, 30),
              ("bench.encode", 36, 45),
              ("bench.server.ingest_payload", 46, 85),
              ("bench.eval", 48, 62)]
    if program_spans:
        ranges += [("seafl.sim.upload", 4, 46),
                   ("seafl.client.local_train", 5, 35),
                   ("seafl.client.step", 9, 31),
                   ("seafl.host.gc", 31, 34),
                   ("seafl.encode", 36, 45),
                   ("seafl.encode.chunks", 41, 45),
                   ("seafl.sim.deliver", 46, 90),
                   ("seafl.sim.eval", 48, 62),
                   ("seafl.host.gc", 63, 70)]
    rec = T.Record(
        start=0, end=100 * MS,
        device=[(k, a * MS, b * MS, None if at is None else at * MS)
                for k, a, b, at in kernels],
        ranges=[(name, a * MS, b * MS) for name, a, b in ranges])
    rec.counts = {"b1_launches": 1, "b2_launches": 1, "b4_launches": 9 * n,
                  "b6_launches": 9 * n, "agg_rows": [tr["buffer"]],
                  "params": conf["P"], "sgd_steps": 4, "evals": 1}
    rec.cell = {"model": conf["model"], "traffic": tr}
    rec.peak_bytes = 3 * 2 ** 30
    return rec


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("metric", METRICS)
def test_a_reading_ignores_the_programs_spans(cell, metric):
    read = run.reader(metric)
    assert read(_record(cell, True)) == read(_record(cell, False))


@pytest.mark.parametrize("cell", CELLS)
def test_the_breakdown_ignores_the_programs_spans(cell):
    with_spans = T.breakdown(_record(cell, True))
    without = T.breakdown(_record(cell, False))
    assert with_spans == without
    # each gap keeps the benchmark span the host was in
    assert [label for label, _ in without["idle_gaps"]] == [
        "eval", "server.ingest_payload", "simulator", "client.local_train",
        "encode"]


def test_the_record_reads_something_in_each_cell():
    """The hand-built stretch gives every reader something to read in a
    cell it names, so the equalities above compare numbers."""
    man = run.manifest()
    for cell in CELLS:
        for m in run.cell_metrics(man, cell, "per_layer"):
            assert run.reader(m["name"])(_record(cell, False)) is not None, \
                (cell, m["name"])
