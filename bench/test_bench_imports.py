"""The benchmark loads neither JAX nor the JAX package (top-level names
compared whole: ``repro_torch`` begins with ``repro``), its references
import nothing of the program, and nothing reads ``benchmarks/``."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_SMALL = """
import sys
sys.path[:0] = [{repo!r}, {src!r}]
import torch
torch.set_num_threads(2)
from bench import run
from bench.conftest import small_cell
conf, traffic = small_cell("mamba2-cohort")
res = run.run_cell("mamba2-cohort", 7, 0.5, True, "cpu", run.manifest(),
                   conf=conf, traffic=traffic, log=lambda *a, **k: None)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_a_run_loads_no_jax_and_no_jax_package():
    code = RUN_SMALL.format(repo=str(ROOT.parent),
                            src=str(ROOT.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN


def test_sources():
    for path in ROOT.rglob("*.py"):
        names = _imports(path)
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert "repro_torch" not in names, path
        if path.name != "test_bench_imports.py":
            assert "benchmarks" not in path.read_text(), path
