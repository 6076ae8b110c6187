"""granne_tpu_torch's ``ShardedGranne`` over 4 gloo ranks on the CPU against
granne_tpu's ``ShardedGranne`` on ``make_mesh(4)``.

Two cases at d = 25: ``tests/test_sharded.py``'s n = 800 (200 a shard)
and n = 797 (shards of 199, 199, 199, 200: three padded by a repeated row).  JAX builds, searches and saves each; one spawn of 4 ranks
(``torch_rank_jobs.sharded_granne_job``) builds each rank's own shard,
searches it, saves and reloads it, carries JAX's shards across
(``convert.sharded_granne_from_numpy``) and saves them, and loads JAX's
saved directory.  Bars: each rank's graph against JAX's shard by edge
Jaccard > 0.95 on every layer; search ids overlap JAX's >= 0.99 on the
same graphs and on each package's own; ``tests/test_sharded.py``'s
recall@1 > 0.95, unique in-range ids and both halves of the id space; the
directories read both ways; the manifest and element files byte-equal to
JAX's on the same graphs.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

import granne_tpu as J
import torch_rank_jobs as jobs
from granne_tpu.parallel.mesh import make_mesh
from granne_tpu.parallel.sharded import ShardedGranne as JShardedGranne
from granne_tpu_torch import Group, ShardedGranne, run_ranks


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


S = 4
SEARCH = dict(max_search=20, num_neighbors=5)
CASES = {
    "n800": (7, 800, 25, dict(num_neighbors=16, max_search=30), 200),
    "n797": (8, 797, 25, dict(num_neighbors=16, max_search=30), 100),  # 199, 199, 199, 200: JAX's shapes of n800
}


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(np.asarray(a), np.asarray(b))]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's sharded builds, searches and directories, and the 4 ranks'
    results (computed once a run)."""
    return jobs.once_per_run(tmp_path_factory, "sharded_granne", lambda: _run(tmp_path_factory))


def _run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    mesh = make_mesh(S)
    cases, queries, jax_out = {}, {}, {}
    for name, (seed, n, d, cfg, nq) in CASES.items():
        vecs = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
        jsg = JShardedGranne.build(J.AngularVectors, vecs, J.BuildConfig(**cfg), mesh=mesh)
        jax_dir = str(tmp / f"{name}-jax")
        jsg.save(jax_dir)
        layers = [[np.asarray(a[s])[: jsg.counts[i][s]] for i, a in enumerate(jsg.layers)] for s in range(S)]
        elements = [np.asarray(jsg.elements.vectors[s]) for s in range(S)]
        cases[name] = (vecs, cfg, jax_dir, layers, elements)
        queries[name] = vecs[:nq]
        jax_out[name] = np.asarray(jsg.search_batch(vecs[:nq], **SEARCH)[0])
    ranks = run_ranks(jobs.sharded_granne_job, S, cases, queries, str(tmp), backend="gloo", device="cpu", timeout=300)
    return tmp, cases, queries, jax_out, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_shard_graphs_match_jax(run, name):
    """Rank s's own graph against JAX's shard s: equal layer counts, edge
    Jaccard > 0.95 on every layer.  JAX's deeper stack past a shard's own
    depth only repeats its bottom layer (the port keeps none of it)."""
    _, cases, _, _, ranks = run
    jax_layers = cases[name][3]
    for s, out in enumerate(ranks):
        mine = out[name]["layers"]
        for i, a in enumerate(mine):
            assert a.shape == jax_layers[s][i].shape and _jaccard(a, jax_layers[s][i]) > 0.95, (s, i)
        assert all(np.array_equal(extra, jax_layers[s][len(mine) - 1]) for extra in jax_layers[s][len(mine):])


@pytest.mark.parametrize("name", list(CASES))
def test_search_overlaps_jax(run, name):
    """Ids overlap JAX's sharded search >= 0.99: on JAX's graphs carried
    across, on JAX's saved directory loaded, and on the port's own build."""
    _, _, _, jax_out, ranks = run
    res = ranks[0][name]
    for key in ("same", "jax_dir", "own"):
        assert _overlap(res[key][0], jax_out[name]) >= 0.99, key


def test_sharded_search_bars(run):
    """``tests/test_sharded.py``'s bars: recall@1 > 0.95, ids unique within a
    row and below n, results from both halves of the id space."""
    *_, ranks = run
    ids = ranks[0]["n800"]["own"][0]
    assert float(np.mean(ids[:, 0] == np.arange(200))) > 0.95
    for row in ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live) and live.max() < 800
    ids = ranks[0]["n797"]["own"][0]
    assert ids[ids >= 0].max() >= 797 // 2 and ids[ids >= 0].min() < 797 // 2


def test_directories_read_both_ways(run):
    """The port reloads its own directory to the same ids; JAX's
    ``ShardedGranne.load`` reads it and answers within the overlap bar."""
    tmp, _, queries, _, ranks = run
    mesh = make_mesh(S)
    for name in CASES:
        res = ranks[0][name]
        assert all(np.array_equal(a, b) for a, b in zip(res["reloaded"], res["own"]))
        loaded = JShardedGranne.load(str(tmp / f"{name}-own"), mesh=mesh)
        assert _overlap(np.asarray(loaded.search_batch(queries[name], **SEARCH)[0]), res["own"][0]) >= 0.99


@pytest.mark.parametrize("name", list(CASES))
def test_manifest_and_elements_byte_equal(run, name):
    """On the same graphs, the port writes JAX's manifest and element files
    byte for byte (padding rows included); a load refuses another world size."""
    tmp = run[0]
    for f in ["manifest.json"] + [f"shard{s}.elements" for s in range(S)]:
        assert filecmp.cmp(os.path.join(tmp, f"{name}-same", f), os.path.join(tmp, f"{name}-jax", f), shallow=False), f
    two = Group(rank=0, world=2, backend="gloo", device=torch.device("cpu"), pg=None)
    with pytest.raises(ValueError, match="manifest has 4 shards"):
        ShardedGranne.load(str(tmp / f"{name}-same"), two)


def test_ranks_agree_and_import_no_jax(run):
    *_, ranks = run
    for out in ranks:
        assert out["modules"] == []
        for name in CASES:
            for key in ("own", "same", "jax_dir", "reloaded"):
                assert all(np.array_equal(a, b) for a, b in zip(out[name][key], ranks[0][name][key]))


def test_dryrun_multichip_at_four_gloo_ranks():
    """The port's dry run (``parallel/dryrun.py``, the steps of
    ``__graft_entry__.dryrun_multichip``): the data-parallel build's edge
    Jaccard against the single-device build > 0.95, and every engine, the
    data-parallel build's index included, at least as good as the
    single-device search."""
    from granne_tpu_torch.parallel.dryrun import dryrun_multichip

    recalls = dryrun_multichip(S, "gloo", "cpu", timeout=300)
    jaccard = recalls.pop("dp_build_jaccard")
    assert set(recalls) == {"single_device", "dp_build", "sharded_granne", "sharded_ivf", "tiered_sharded_ivf"}
    assert min(recalls.values()) == recalls["single_device"] > 0.9
    assert 0.95 < jaccard <= 1.0


def test_nccl_world_gets_a_gpu_a_rank_or_is_refused(monkeypatch):
    """NCCL refuses two ranks on one GPU: the launcher puts NCCL rank r on
    ``cuda:r`` and refuses a world larger than the host's GPUs (before any
    rank starts), so the dry run's default NCCL world of 4 needs 4 cards;
    gloo runs every rank on one device."""
    from granne_tpu_torch.parallel.dryrun import dryrun_multichip
    from granne_tpu_torch.parallel.mesh import rank_devices

    cards = [torch.device("cuda", r) for r in range(S)]
    assert rank_devices(S, "nccl", "cuda", gpus=S) == rank_devices(S, None, "cuda", gpus=S) == cards
    assert rank_devices(S, "gloo", "cuda", gpus=1) == [torch.device("cuda", 0)] * S
    assert rank_devices(1, None, "cuda", gpus=1) == [torch.device("cuda", 0)]
    assert rank_devices(S, None, "cpu") == [torch.device("cpu")] * S
    for world, device, gpus in ((S, "cuda", S - 1), (2, "cuda:0", 2), (2, "cpu", 2)):
        with pytest.raises(ValueError, match="NCCL needs a GPU of its own a rank"):
            rank_devices(world, "nccl", device, gpus=gpus)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs a GPU of its own a rank"):
        dryrun_multichip(S)
