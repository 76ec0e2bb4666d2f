"""A cell, a configuration and a per-layer metric are added by new files
and new manifest entries alone: no file of the harness changes."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench import run
from bench.conftest import SMALL

ROOT = Path(__file__).resolve().parent


def test_new_files_alone(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    model = SMALL["dense"]
    (root / "configs" / "tiny-dense.json").write_text(json.dumps({
        "arch": "phi4-mini-3.8b", "source": "https://example.org/tiny",
        "reduced": [], "model": model,
        "changes": {k: v for k, v in model.items() if k != "family"}}))
    traffic = json.loads((root / "workloads" / "phi4-cohort.json").read_text())
    traffic.update(config="tiny-dense", seq_len=32, eval_seqs=4,
                   limits={"agg_gap": 1e-05})
    (root / "workloads" / "tiny-cohort.json").write_text(json.dumps(traffic))
    (root / "metrics" / "evals_per_round.py").write_text(
        "def read(rec):\n"
        "    return rec.counts['evals'] / len(rec.counts['agg_rows'])\n")
    man["configs"].append({"name": "tiny-dense", "source": "https://x",
                           "file": "bench/configs/tiny-dense.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny-cohort", "config": "tiny-dense",
                             "traffic": "tiny-cohort", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "evals_per_round", "unit": "1",
                             "better": "higher", "source": "program_span",
                             "layer": "round", "moves": "fl_round_s",
                             "workloads": ["tiny-cohort"]})
    quiet = lambda *a, **k: None  # noqa: E731
    res = run.run_cell("tiny-cohort", 11, 0.5, True, "cpu", man, root=root,
                       log=quiet)
    assert res["metrics"]["evals_per_round"]["value"] == 1.0
    assert res["correct"] is True
    res = run.run_cell("tiny-cohort", 12, 0.5, False, "cpu", man, root=root,
                       log=quiet)
    assert set(res["metrics"]) == {"fl_round_s", "setup_s"}
