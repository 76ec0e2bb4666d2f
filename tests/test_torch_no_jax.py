"""The port stands alone: no module of ``repro_torch`` imports ``jax`` or the
JAX package ``repro``, and ``chip_smoke.py`` imports neither."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "repro")

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
for m in ("repro_torch.checkpoint.checkpointer", "repro_torch.runtime.codecs",
          "repro_torch.runtime.compression", "repro_torch.runtime.dispatch",
          "repro_torch.runtime.cohorts", "repro_torch.runtime.monitor",
          "repro_torch.runtime.autotune", "repro_torch.launch.report",
          "repro_torch.sharding", "repro_torch.launch.mesh",
          "repro_torch.launch.op_cost", "repro_torch.launch.dryrun"):
    assert m in names, m
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE % (BLOCKED,)],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 64        # every module was walked


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_or_repro():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & set(BLOCKED), roots & set(BLOCKED)


def test_port_sources_name_no_jax_import():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, (path, bad)
