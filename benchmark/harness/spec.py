"""Find a cell's files by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Spec:
    """One cell: its ``BENCHMARK.json`` entry, its cell file, its
    configuration file and the metrics it reports."""

    workload: str
    chips: int
    cell: dict
    config: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def applies(metric: dict, workload: str, reported: set | None = None) -> bool:
    """Whether ``metric`` is reported in ``workload``: listed there, or, with
    no ``workloads`` key, in every cell (a per-layer metric: every cell that
    reports the end-to-end metric it moves, given as ``reported``)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    cell = json.loads((BENCH_DIR / "cells" / f"{workload}.json").read_text())
    if (cell["config"], cell["traffic"]["name"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"cells/{workload}.json names {cell['config']}/{cell['traffic']['name']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, workload, reported)]
    return Spec(workload, entry["chips"], cell, config, e2e, per_layer)


def load_module(kind: str, name: str):
    """``harness.<kind>.<name>``: a system or a kind of traffic."""
    return importlib.import_module(f"harness.{kind}.{name}")


def load_metric(name: str):
    """The reader ``metrics/<name>.py`` (names hold dots, so it is loaded
    from its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
