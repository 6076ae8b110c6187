"""BENCHMARK.json against the contract's shape, and every file it names found by name."""

import json
import re

import pytest
from harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    runs, cells = 2 + 14 * 24, 24
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for w in metric["workloads"]:
            assert metric["moves"] in {m["name"] for m in spec.load_spec(w).end_to_end}
    for w in metric.get("workloads", []):
        assert w in WORKLOADS
    if "roofline" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and setup["better"] == "lower" and "workloads" not in setup


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    s = spec.load_spec(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert s.cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["chips"] == 1
    names = {m["name"] for m in s.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert s.per_layer, "every cell reports a per-layer metric"
    assert spec.load_module("traffic", s.cell["traffic"]["kind"])
    assert spec.load_module("systems", s.config["system"])
    assert s.cell["limits"]["bad_rows"] == 0


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = spec.ROOT / config["file"]
    assert config["file"].startswith("benchmark/configs/") and path.is_file()
    body = json.loads(path.read_text())
    assert body["name"] == config["name"]
    assert sorted(body["reduced"]) == sorted(config["reduced"])
    assert all(key in body["data"] for key in config["reduced"])
    assert len(config["source"]) <= 200 and "\n" not in config["source"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.load_metric(metric["name"]).read)


def test_files_under_paths_are_named_from_name_characters():
    for path in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "cells").glob("*.json")), ids=lambda p: p.stem)
def test_every_cell_file_names_its_config_and_system(path):
    """Cells kept for later PRs (not in BENCHMARK.json) stay whole too."""
    cell = json.loads(path.read_text())
    config = json.loads((spec.BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
    assert config["name"] == cell["config"] and len(cell["why"]) <= 200
    assert spec.load_module("systems", config["system"]) and spec.load_module("traffic", cell["traffic"]["kind"])
    assert set(cell["limits"]) == {"bad_rows", "dist_err", "recall_miss"} and cell["controls"]
