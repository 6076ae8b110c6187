"""granne_tpu_torch's ``TieredShardedIvf`` over 4 gloo ranks on the CPU
against granne_tpu's ``TieredShardedIvf`` on ``make_mesh(4)``.

The cases of ``tests/test_tiering.py``'s two sharded tests: a bf16 index
of 4,000 × 16 (40 clusters) and an int8 index of 2,000 × 12 (24 clusters),
both saved by JAX.  One spawn of 4 ranks
(``torch_rank_jobs.tiered_sharded_job``) loads each file (each rank
memory-maps only its own block rows), searches one batch and two batches
through the pipeline, and shards the whole index with ``from_ivf``.  The
port scores fetched blocks through K4's plain route, JAX through a bf16
einsum, so ids must overlap JAX's >= 0.999 and distances agree within
1e-3, not in bits.  Recall@1 must reach the one-device ``TieredIvf``'s at
equal nprobe, and distances must not decrease along a row.
"""

import jax
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
import torch_rank_jobs as jobs
from granne_tpu.parallel.mesh import make_mesh
from granne_tpu.parallel.tiering import TieredShardedIvf as JTieredSharded
from granne_tpu_torch import TieredIvf, convert, run_ranks


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_jax():
    """Drop every compiled JAX program before and after this module: each
    XLA:CPU executable holds memory maps, and one test process that runs
    many JAX-heavy files can reach vm.max_map_count and crash."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch ops on one thread, then restore the count:
    the test suite runs several workers at once, and torch's intra-op
    threads on top of them oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, K, NPROBE, ATOL = 4, 5, 8, 1e-3
CASES = {  # name: (seed, n, d, n_clusters, dtype, queries)
    "bf16": (1, 4000, 16, 40, "bfloat16", 128),
    "int8": (2, 2000, 12, 24, "int8", 64),
}


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's files and sharded searches, the one-device tiered searches and
    the 4 ranks' results (computed once a run)."""
    return jobs.once_per_run(tmp_path_factory, "tiered_sharded", lambda: _run(tmp_path_factory))


def _run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiered_sharded")
    mesh = make_mesh(S)
    cases, queries, want, single = {}, {}, {}, {}
    for name, (seed, n, d, c, dtype, nq) in CASES.items():
        x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
        j = jivf.IvfIndex.build(x, n_clusters=c, kmeans_iters=5, dtype=dtype)
        path = str(tmp / f"{name}.ivf")
        j.save(path)
        cases[name], queries[name] = (path, NPROBE), x[:nq]
        want[name] = JTieredSharded.load(path, mesh=mesh).search_batch(x[:nq], K, nprobe=NPROBE)
        port = convert.ivf_from_numpy(np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids),
                                      np.asarray(j.block_scales), j.n_total, device="cpu")
        single[name] = TieredIvf.from_ivf(port, device="cpu").search_batch(x[:nq], K, nprobe=NPROBE)
    ranks = run_ranks(jobs.tiered_sharded_job, S, cases, queries, backend="gloo", device="cpu", timeout=300)
    return cases, want, single, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_ids_overlap_jax(run, name):
    _, want, _, ranks = run
    ids, d = ranks[0][name]["one"]
    assert _overlap(ids, want[name][0]) >= 0.999
    np.testing.assert_allclose(d, want[name][1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_recall_at_least_single_device(run, name):
    """Self-recall@1 at least the one-device ``TieredIvf``'s at equal nprobe
    (``tests/test_tiering.py``'s bar; > 0.9 for the int8 artifact too)."""
    _, _, single, ranks = run
    ids, d = ranks[0][name]["one"]
    r = np.arange(len(ids))
    assert np.mean(ids[:, 0] == r) >= np.mean(single[name][0][:, 0] == r) and np.mean(ids[:, 0] == r) > 0.9
    assert np.all(np.diff(d, axis=1) >= -1e-5) and ids.max() < CASES[name][1]


def test_each_rank_maps_only_its_rows(run):
    """Blocks stay memory-mapped on the host; rank r holds the file's rows
    [r·k_local, (r+1)·k_local) that exist (the last rank fewer)."""
    cases, _, _, ranks = run
    for name, (path, _) in cases.items():
        k = jivf.IvfIndex.load(path, device=False).blocks.shape[0]
        k_local = -(-k // S)
        for r, out in enumerate(ranks):
            res = out[name]
            assert res["host_type"] == "memmap"
            assert res["rows"] == min(k_local, k - r * k_local)


def test_batches_and_from_ivf_agree(run):
    """The pipelined ``search_batches`` over two halves returns the one-call
    ids; ``from_ivf`` on the whole index answers exactly as ``load``; every
    rank returns the same, and no rank loaded jax or the JAX package."""
    cases, _, _, ranks = run
    for name in cases:
        res = ranks[0][name]
        both = np.concatenate([ids for ids, _ in res["batches"]])
        assert _overlap(both, res["one"][0]) >= 0.999
        assert all(np.array_equal(a, b) for a, b in zip(res["from_ivf"], res["one"]))
        for out in ranks:
            assert all(np.array_equal(a, b) for a, b in zip(out[name]["one"], res["one"]))
    assert all(out["modules"] == [] for out in ranks)
