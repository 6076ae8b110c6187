"""A whole run of each cell, at a size the CPU holds, with the timed path
broken underneath: ``correct`` comes out false for each fault the cell can
have, and true without one.  The port runs its plain PyTorch kernels on the
CPU; the harness's look for a card is skipped.  No cell crosses chips, so
the exchange between chips has no fault here, and no cell keeps a batch
mean, so "half the batch left out" is half of each call's queries
answered, their answers standing in for the rest."""

import json
import time

import granne_tpu_torch as gt
import pytest
import torch
from harness import runner, spec

# the HNSW cell is kept in cells/ for a later PR and is not in BENCHMARK.json (PERF.md §7)
SERVING = ["glove100-hnsw.batch10k-ef32", "glove100-ivf.batch10k"]


def cell_spec(workload: str) -> spec.Spec:
    """A cell of BENCHMARK.json, or one kept in ``cells/`` without an entry."""
    try:
        return spec.load_spec(workload)
    except SystemExit:
        cell = json.loads((spec.BENCH_DIR / "cells" / f"{workload}.json").read_text())
        config = json.loads((spec.BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
        return spec.Spec(workload, 1, cell, config, [], [])


def tiny(workload: str) -> spec.Spec:
    s = cell_spec(workload)
    # IVF keeps n / 300 clusters: 66 at 20,000, so nprobe 8 still finds the true neighbours
    s.config["data"]["n"] = 20_000 if s.config["system"] == "ivf" else 3000
    s.cell["traffic"].update(queries_per_call=100, pool_calls=3, warmup_calls=1)
    return s


def run(s: spec.Spec, seconds: float = 0.3, **kw) -> dict:
    return runner.run_cell(s, 2**31 + 77, seconds, False, t0=time.perf_counter(), device="cpu", **kw)


def serving_fault(monkeypatch, workload, fault):
    cls = gt.Granne if "hnsw" in workload else gt.IvfIndex
    orig = cls.search_batch
    first = {}

    def stale(self, queries, *a, **kw):  # the state of the first call, returned unchanged
        first.setdefault("answer", orig(self, queries, *a, **kw))
        return first["answer"]

    def half(self, queries, *a, **kw):  # half the batch searched, its answers standing in for the rest
        ids, dists = orig(self, queries[: queries.shape[0] // 2], *a, **kw)
        return torch.cat([ids, ids]), torch.cat([dists, dists])

    def altered(self, queries, *a, **kw):  # one id of one answer changed where it is produced
        ids, dists = orig(self, queries, *a, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % (len(self) if cls is gt.Granne else self.n_total)
        return ids, dists

    monkeypatch.setattr(cls, "search_batch", {"stale": stale, "half": half, "altered": altered}[fault])


@pytest.mark.parametrize("workload", SERVING)
def test_sound_run_is_correct(workload):
    r = run(tiny(workload))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload", SERVING)
def test_fault_is_caught(monkeypatch, workload, fault):
    serving_fault(monkeypatch, workload, fault)
    r = run(tiny(workload))
    assert not r["correct"], r["checks"]
