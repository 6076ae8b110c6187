"""granne_tpu_torch's ``ShardedIvf`` over 4 gloo ranks on the CPU against
granne_tpu's ``ShardedIvf`` on ``make_mesh(4)``, on the same index files.

JAX builds bf16 and int8 indexes of one clustered set (58 blocks: padded
to 60, so the last rank holds 2 empty blocks), the f32 index of
``tests/test_sharded_ivf.py``'s full-probe case and the 13-block index of
its padding case, saves each, and searches them sharded.  One spawn of 4 ranks (``torch_rank_jobs.sharded_ivf_job``)
loads every file (each rank reads its own block rows), searches at every
nprobe through K4's plain route and once through K5's (``fused_topk``),
and carries the same index across with ``convert.sharded_ivf_from_numpy``.
Ids must equal JAX's and distances agree within 1e-3 (the bar
``tests/test_torch_ivf.py`` holds the one-device search to); every rank
returns the same; sharded recall is at least the one-device search's at
equal nprobe.  The probe mask and the row-range load are also checked
without ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
import torch_rank_jobs as jobs
from granne_tpu.parallel.mesh import make_mesh
from granne_tpu.parallel.sharded_ivf import ShardedIvf as JShardedIvf
from granne_tpu_torch import IvfIndex, TieredIvf, convert, run_ranks
from granne_tpu_torch.index import ivf
from granne_tpu_torch.ops import distance


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


S, K, ATOL = 4, 10, 1e-3
NPROBES = (2, 4, 8)


def _clustered(rng, n, d, c=30, sigma=0.3):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return (centers[rng.integers(0, c, n)] + sigma * rng.standard_normal((n, d))).astype(np.float32)


def _gt(x, q, k):
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


def _port(j) -> IvfIndex:
    return convert.ivf_from_numpy(
        np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids), np.asarray(j.block_scales),
        j.n_total, device="cpu",
    )


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's indexes, files and sharded searches, and the 4 ranks' results
    (computed once a run)."""
    return jobs.once_per_run(tmp_path_factory, "sharded_ivf", lambda: _run(tmp_path_factory))


def _run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ivf")
    x = _clustered(np.random.default_rng(41), 3000, 24)
    q = _clustered(np.random.default_rng(42), 96, 24)
    rng = np.random.default_rng(0)
    pad_x = rng.standard_normal((900, 16)).astype(np.float32)
    f32_x, f32_q = rng.standard_normal((2048, 24)).astype(np.float32), rng.standard_normal((64, 24)).astype(np.float32)
    specs = {  # f32 and pad: the data of tests/test_sharded_ivf.py's full-probe and padding cases
        "bf16": (x, q, dict(n_clusters=24, kmeans_iters=4, cluster_cap=64, dtype="bfloat16")),
        "f32": (f32_x, f32_q, dict(n_clusters=24, kmeans_iters=6, dtype="float32")),
        "int8": (x, q, dict(n_clusters=24, kmeans_iters=4, cluster_cap=64, dtype="int8")),
        "pad": (pad_x, pad_x[:100], dict(n_clusters=13, kmeans_iters=5, cluster_cap=96)),
    }
    mesh = make_mesh(S)
    cases, want, indexes = {}, {}, {}
    for name, (vecs, queries, kw) in specs.items():
        j = jivf.IvfIndex.build(vecs, **kw)
        path = str(tmp / f"{name}.ivf")
        j.save(path)
        nprobes = {"f32": NPROBES + (-(-j.k // S),), "pad": (3,)}.get(name, NPROBES)  # f32: also every local block
        sharded = JShardedIvf.from_ivf(j, mesh)
        want[name] = {p: tuple(np.asarray(a) for a in sharded.search_batch(queries, K, nprobe=p)) for p in nprobes}
        cases[name] = (path, nprobes, queries)
        indexes[name] = (vecs, queries, _port(j))
    ranks = run_ranks(jobs.sharded_ivf_job, S, cases, backend="gloo", device="cpu", timeout=300)
    return cases, want, indexes, ranks


@pytest.mark.parametrize("name", ["bf16", "f32", "int8", "pad"])
def test_ids_equal_jax(run, name):
    """Every nprobe: JAX's ids, distances within 1e-3; the carried-across
    index (``sharded_ivf_from_numpy``) answers as the loaded one."""
    cases, want, _, ranks = run
    got = ranks[0][name]
    for nprobe in cases[name][1]:
        ids, d = got[nprobe]
        assert np.array_equal(ids, want[name][nprobe][0]), nprobe
        np.testing.assert_allclose(d, want[name][nprobe][1], rtol=0, atol=ATOL)
    first = cases[name][1][0]
    assert all(np.array_equal(a, b) for a, b in zip(got["from_numpy"], got[first]))


def test_ranks_agree_and_hold_only_their_rows(run):
    """The merged answer is the same on every rank; rank r holds block rows
    [r·k_local, (r+1)·k_local) of the file, padding rows empty and masked."""
    cases, _, indexes, ranks = run
    for name, (path, nprobes, _) in cases.items():
        full = IvfIndex.load(path, device="cpu")
        k_local = -(-full.k // S)
        ids = torch.cat([full.block_ids, torch.full((k_local * S - full.k, full.cluster_cap), -1, dtype=torch.int32)])
        for r, out in enumerate(ranks):
            res = out[name]
            assert res["k_local"] == k_local
            assert np.array_equal(res["block_ids"], ids[r * k_local : (r + 1) * k_local].numpy())
            assert np.array_equal(res["valid"], np.arange(r * k_local, (r + 1) * k_local) < full.k)
            for key in (*nprobes, "fused"):
                assert all(np.array_equal(a, b) for a, b in zip(res[key], ranks[0][name][key])), (name, r, key)


def test_padding_blocks_never_leak(run):
    """``tests/test_sharded_ivf.py::test_sharded_ivf_global_ids_and_padding``
    at 4 ranks (nprobe 3): k_phys not a multiple of 4, ids in range,
    self-queries find themselves, no id twice in a row."""
    cases, _, indexes, ranks = run
    vecs, _, index = indexes["pad"]
    assert index.k % S != 0
    ids = ranks[0]["pad"][3][0]
    live = ids[ids >= 0]
    assert live.max() < len(vecs)
    assert np.mean([i in set(ids[i]) for i in range(100)]) > 0.95
    for row in ids:
        lv = row[row >= 0]
        assert len(set(lv.tolist())) == len(lv)


def test_full_probe_equals_exact(run):
    """Probing every local block is a full scan: recall against the exact
    f32 top-10 > 0.99 (bf16 products may swap near-ties), distances sorted."""
    cases, _, indexes, ranks = run
    vecs, queries, index = indexes["f32"]
    ids, d = ranks[0]["f32"][cases["f32"][1][-1]]
    assert cases["f32"][1][-1] == -(-index.k // S)
    assert _recall(ids, _gt(vecs, queries, K)) > 0.99
    assert np.all(np.diff(d, axis=1) >= -1e-6)


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_recall_at_least_single_device(run, name):
    cases, _, indexes, ranks = run
    vecs, queries, index = indexes[name]
    gt = _gt(vecs, queries, K)
    for nprobe in NPROBES:
        single = _recall(index.search_batch(queries, K, nprobe=nprobe)[0].numpy(), gt)
        assert _recall(ranks[0][name][nprobe][0], gt) >= single - 1e-9, nprobe


def test_fused_route_agrees_and_ranks_import_no_jax(run):
    """K5's route (``fused_topk``) returns K4's ids (overlap >= 0.999,
    chip_smoke.py's ROUTE_AGREEMENT); no rank loaded jax or the JAX package."""
    cases, _, _, ranks = run
    for name, (_, nprobes, _) in cases.items():
        a, b = ranks[0][name]["fused"][0], ranks[0][name][nprobes[0]][0]
        assert np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]) >= 0.999
    assert all(out["modules"] == [] for out in ranks)


def test_probe_mask_matches_jax():
    """Padding blocks (zero centroids) are never probed when every real
    block scores below 0: the port's masked grouped search equals JAX's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 3.0  # every centroid leans along +e0
    j = jivf.IvfIndex.build(x, n_clusters=8, kmeans_iters=3, cluster_cap=96)
    pad = 4
    cent = np.concatenate([np.asarray(j.centroids), np.zeros((pad, 16), np.float32)])
    blocks = np.concatenate([np.asarray(j.blocks), np.zeros((pad,) + j.blocks.shape[1:], j.blocks.dtype)])
    bids = np.concatenate([np.asarray(j.block_ids), np.full((pad, j.blocks.shape[1]), -1, np.int32)])
    scales = np.concatenate([np.asarray(j.block_scales), np.ones((pad, j.blocks.shape[1]), np.float32)])
    valid = np.arange(len(cent)) < j.k
    q = np.zeros((5, 16), np.float32)
    q[:, 0], q[:, 1:6] = -1.0, 0.1 * np.eye(5)  # along -e0: every real block scores below 0
    kw = dict(nprobe=3, k_out=K, group_cap=8, num_slots=5 * 3)
    jq = jnp.asarray(np.asarray(jivf.D.normalize(jnp.asarray(q))))
    jids, jd = jivf._ivf_search_grouped(jnp.asarray(cent), jnp.asarray(blocks), jnp.asarray(bids),
                                        jnp.asarray(scales), jq, centroid_valid=jnp.asarray(valid), **kw)
    t = convert.ivf_from_numpy(cent, blocks, bids, scales, len(x), device="cpu")
    tq = distance.normalize(torch.as_tensor(q))
    probes = ivf._probe(tq, t.centroids, 3, torch.as_tensor(valid))
    assert bool((probes < j.k).all()) and not bool((ivf._probe(tq, t.centroids, 3) < j.k).all())
    ids, d = ivf._ivf_search_grouped(t.centroids, t.blocks, t.block_ids, t.block_scales, tq,
                                     centroid_valid=torch.as_tensor(valid), **kw)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    assert bool((ids >= 0).all())


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_row_range_load(run, name):
    """``IvfIndex.load(rows=...)`` and ``TieredIvf.load(rows=...)`` read
    exactly the rows of the whole file's arrays."""
    path = run[0][name][0]
    full = IvfIndex.load(path, device="cpu")
    for lo, hi in ((0, 15), (45, 58), (7, 7)):
        part = IvfIndex.load(path, device="cpu", rows=(lo, hi))
        assert part.n_total == full.n_total and part.k == hi - lo
        for key in ("centroids", "block_ids", "block_scales"):
            assert torch.equal(getattr(part, key), getattr(full, key)[lo:hi])
        assert torch.equal(part.blocks.float(), full.blocks[lo:hi].float())
        tiered = TieredIvf.load(path, device="cpu", rows=(lo, hi))
        assert isinstance(tiered.host_blocks, np.ndarray) and tiered.k == hi - lo
        assert np.array_equal(tiered.host_block_ids, full.block_ids[lo:hi].numpy())
    with pytest.raises(ValueError, match="not within"):
        IvfIndex.load(path, device="cpu", rows=(50, 60))
