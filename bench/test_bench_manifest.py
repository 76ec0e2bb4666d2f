"""BENCHMARK.json against the rules of its format, and every name it gives
file of the benchmark."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
MAN = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", *KEYS}
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(LINE.match(w) for w in MAN["command"])
    assert (ROOT.parent / MAN["command"][1]).is_file()


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), e[key]


def test_configs_and_cells_have_their_files():
    for c in MAN["configs"]:
        path = ROOT.parent / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        conf = json.loads(path.read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"] == conf["source"]
    configs = {c["name"] for c in MAN["configs"]}
    used = set()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        traffic = json.loads((ROOT / "workloads" /
                              f"{w['traffic']}.json").read_text())
        assert traffic["config"] == w["config"]
        used.add(w["config"])
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_cells_and_moves():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells

    def reports(cell, name):
        m = e2e[name]
        return "workloads" not in m or cell in m["workloads"]

    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, m["moves"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert reports(cell, "setup_s")
        assert any(reports(cell, n) for n in e2e if n != "setup_s")
        assert any("workloads" not in m or cell in m["workloads"]
                   for m in MAN["per_layer"])
    layers = {}
    for m in MAN["per_layer"]:
        assert LINE.match(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_size_and_quarter_on_four_chips():
    assert len((ROOT.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
