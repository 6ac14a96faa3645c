"""BENCHMARK.json and the files it names: the contract's names, units and
limits, and every configuration, cell, traffic mix, entry, check and metric
reader present."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def cell_file(name):
    return json.loads((HERE / "cells" / f"{name}.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["perfbench"]


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in SPEC["configs"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_config_has_a_cell():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["reduced"] == c["reduced"] == []
    assert (HERE / "entries" / f"{data['entry']}.py").is_file()
    assert (HERE / "reference" / f"{data['reference']}.py").is_file()
    assert data["dtype"] in ("float64", "float32", "bfloat16", "float16")


@pytest.mark.parametrize("name", CELLS)
def test_cell(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    cell = cell_file(name)
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for check in cell["limits"]:
        assert (HERE / "checks" / f"{check}.py").is_file()


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_its_cells_report(m):
    e2e = {x["name"]: x for x in SPEC["end_to_end"]}
    assert m["moves"] in e2e
    reported = set(e2e[m["moves"]].get("workloads", CELLS))
    assert set(m.get("workloads", CELLS)) <= reported


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_enough(name):
    def reports(m):
        return name in m.get("workloads", CELLS)
    e2e = [m["name"] for m in SPEC["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in SPEC["per_layer"])
