"""``BENCHMARK.json`` read, each cell's parts found by name, and the file
held to the benchmark's contract as far as it can be checked here."""

import json
import re

import pytest

from portbench import spec
from portbench.tests.tiny import BENCH, CELLS

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.fullmatch(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"] and all(PATH.fullmatch(p) for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits in 43200 s
    assert 1200 + 24 * 180 + (2 + 14 * 24) * (BENCH["run_seconds"] + 60) <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert TEXT.fullmatch(c["source"]) and TEXT.fullmatch(c["why"])
        assert c["file"].startswith("portbench/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert spec._module("families", cfg["family"])


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(set(CELLS)) == len(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.fullmatch(w["why"])
    # a cell on four chips: at most a quarter of the cells, or one
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and TEXT.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
    for m in e2e + layer:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_found_by_name(workload):
    cell = spec.cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    # each per-layer metric moves an end-to-end metric this cell reports
    assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    assert cell.entry.__name__ == f"portbench.entries.{cell.traffic['entry']}"


def test_files_under_paths_are_named_from_names():
    for path in (spec.PACKAGE).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert all(NAME.fullmatch(part) for part in rel.split("/")), rel
