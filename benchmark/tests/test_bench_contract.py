"""BENCHMARK.json against the files the harness finds by name, and against
the rules its fields keep."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]


def test_configs_are_the_files():
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        spec = harness.load("configs", c["name"])
        assert spec["source"] == c["source"] and spec["reduced"] == c["reduced"] == []
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells_are_the_files(w):
    cell = harness.load_cell(w["name"])
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    assert w["chips"] == 1


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_its_metrics(w):
    cell = harness.load_cell(w["name"])
    drv = harness.driver(cell["traffic_spec"]["driver"])
    stats = {"clips": 64, "window_s": 1.0, "latencies": [0.1, 0.2], "setup_s": 1.0,
             "memory_peak_bytes": 1}
    reported = {"setup_s", *drv.end_to_end(stats)}
    listed = {m["name"] for m in SPEC["end_to_end"]
              if w["name"] in m.get("workloads", [w["name"]])}
    assert reported == listed
    per_layer = {m["name"] for m in SPEC["per_layer"] if w["name"] in m["workloads"]}
    assert per_layer == {m.NAME for m in harness.metrics_of(w["name"])}
    assert per_layer
    for m in SPEC["per_layer"]:
        if w["name"] in m["workloads"]:
            assert m["moves"] in reported


def test_per_layer_entries_are_the_readers():
    mods = {m.NAME: m for m in (harness.load_module(p) for p in
                                sorted((REPO / "benchmark" / "metrics").glob("*.py")))}
    assert set(mods) == {m["name"] for m in SPEC["per_layer"]}
    for m in SPEC["per_layer"]:
        mod = mods[m["name"]]
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES, mod.WORKLOADS) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"])
