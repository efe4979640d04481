"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file under phybench/."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def cell_metrics(cell: str, kind: str) -> set:
    return {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "phybench/run.py"]
    assert BENCH["paths"] == ["phybench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_and_names(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert set(e) - extra == KEYS[kind], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and 2 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    e2e = cell_metrics(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_per_layer_moves_and_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers: dict = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("phybench/")
        data = json.loads((REPO / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        traffic = json.loads((REPO / "phybench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (REPO / "phybench" / "entries"
                / f"{traffic['entry']}.py").exists()
    for m in BENCH["per_layer"]:
        assert (REPO / "phybench" / "metrics" / f"{m['name']}.py").exists()


def test_paths_hold_only_names():
    for f in (REPO / "phybench").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
