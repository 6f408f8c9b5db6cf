"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by its name in a file of its own."""

from __future__ import annotations

import json
import re

import pytest

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["paths"] == ["flowbench"] and BENCH["command"][1] == "flowbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert _line(c["why"]) and _line(c["source"]) and c["file"].startswith("flowbench/")
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and _line(w["why"])
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"] and m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and _line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2 and layers
        for m in layers:
            assert m["moves"] in [x["name"] for x in mine]


@pytest.mark.parametrize("key", ["configs", "traffic", "metrics", "limits"])
def test_each_piece_is_a_file_found_by_name(key):
    fb = REPO / "flowbench"
    if key == "configs":
        for c in BENCH["configs"]:
            assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    elif key == "traffic":
        for w in BENCH["workloads"]:
            spec = json.loads((fb / "traffic" / f"{w['traffic']}.json").read_text())
            assert spec["stages"] and spec["pool"] >= 1
    elif key == "metrics":
        from flowbench import harness

        for m in BENCH["per_layer"]:
            assert callable(harness.load_reader(REPO, m["name"]))
    else:
        for w in BENCH["workloads"]:
            limits = json.loads((fb / "limits" / f"{w['name']}.json").read_text())
            assert limits and all(v > 0 for v in limits.values())


def test_a_full_check_fits_its_time():
    # 2 + 14 x cells runs at run_seconds + 60 s, 2 x 90 s a cell to compile,
    # 1200 s spare, for the full 24 cells.
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200

