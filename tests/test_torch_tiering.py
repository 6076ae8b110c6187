"""granne_tpu_torch's host-tiered IVF serving (``parallel.tiering.TieredIvf``)
against granne_tpu's ``TieredIvf`` on the same ``IvfIndex``.

The port scores the fetched blocks through the grouped slot route of
``index.ivf`` (K4's plain version on the CPU); JAX gathers each query's
probed blocks and contracts them in one XLA einsum.  Both take bf16
products with f32 sums, in other orders, so ids must be equal except where
two candidates' distances tie (within 1e-6).  Within the port,
``search_batches``, ``search_batches_sequential`` and the device-resident
``IvfIndex.search_batch`` give the same ids and distances bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from granne_tpu.index.ivf import IvfIndex as JIvf
from granne_tpu.parallel.tiering import TieredIvf as JTiered
from granne_tpu_torch import IvfIndex, TieredIvf, convert
from granne_tpu_torch.index import ivf


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


TIE = 1e-6


def _clustered(rng, n, d, c=30, sigma=0.3):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return (centers[rng.integers(0, c, n)] + sigma * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    x = _clustered(np.random.default_rng(21), 3000, 24)
    q = _clustered(np.random.default_rng(22), 300, 24)
    return x, q, [q[lo : lo + 100] for lo in range(0, 300, 100)]


def _to_port(j) -> IvfIndex:
    return convert.ivf_from_numpy(
        np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids), np.asarray(j.block_scales),
        j.n_total, device="cpu",
    )


def _collect(results):
    results = list(results)
    return np.concatenate([r[0] for r in results]), np.concatenate([r[1] for r in results])


def _assert_equal_but_ties(ids, d, want_ids, want_d):
    """Equal ids, except at positions where both distances agree within TIE
    (a tie that a different summation order may break either way)."""
    np.testing.assert_allclose(d, want_d, rtol=0, atol=TIE)
    differ = ids != want_ids
    assert np.mean(differ) < 0.01
    for b, k in zip(*np.nonzero(differ)):
        row_d = want_d[b]
        assert np.sum(np.abs(row_d - d[b, k]) <= TIE) >= 2, (b, k)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tiered_matches_jax(data, dtype):
    """TieredIvf.from_ivf on one JAX-built index (bf16 or int8 blocks):
    search_batches and search_batch equal JAX's TieredIvf but for ties, at
    nprobe 4 and 9; blocks stay in host memory (numpy), centroids on the
    search device."""
    x, q, batches = data
    j = JIvf.build(x, n_clusters=24, kmeans_iters=4, cluster_cap=64, dtype=dtype)
    jt, t = JTiered.from_ivf(j), TieredIvf.from_ivf(_to_port(j), device="cpu")
    assert isinstance(t.host_blocks, np.ndarray) and t.centroids.device.type == "cpu"
    assert t.block_dtype == ivf._DTYPES[dtype] and t.n_total == 3000
    for nprobe in (4, 9):
        ids, d = _collect(t.search_batches(batches, 10, nprobe=nprobe))
        want_ids, want_d = _collect(jt.search_batches(batches, 10, nprobe=nprobe))
        _assert_equal_but_ties(ids, d, want_ids, want_d)
        one_ids, one_d = t.search_batch(q[:100], 10, nprobe=nprobe)
        assert np.array_equal(one_ids, ids[:100]) and np.array_equal(one_d, d[:100])
        assert one_ids.dtype == np.int32 and one_d.dtype == np.float32


def test_pipeline_equals_sequential_and_resident(data):
    """search_batches == search_batches_sequential == the device-resident
    grouped IvfIndex.search_batch (K4's plain version), ids and distances
    bit for bit, for the port's own build; the fused K5 route agrees on ids."""
    x, q, batches = data
    index = IvfIndex.build(x, n_clusters=24, kmeans_iters=4, cluster_cap=64, device="cpu")
    t = TieredIvf.from_ivf(index, device="cpu")
    for nprobe in (3, 8):
        ids, d = _collect(t.search_batches(batches, 10, nprobe=nprobe))
        s_ids, s_d = _collect(t.search_batches_sequential(batches, 10, nprobe=nprobe))
        r_ids, r_d = index.search_batch(q, 10, nprobe=nprobe)
        assert np.array_equal(ids, s_ids) and np.array_equal(d, s_d)
        assert np.array_equal(ids, r_ids.numpy()) and np.array_equal(d, r_d.numpy())
        f_ids, _ = index.search_batch(q, 10, nprobe=nprobe, fused_topk=True)
        assert np.mean(f_ids.numpy() == ids) > 0.99
    assert list(t.search_batches([], 10)) == []


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tiered_load_of_either_package_file(data, tmp_path, dtype):
    """TieredIvf.load on a file written by either package keeps blocks, ids
    and scales memory-mapped and answers as from_ivf of the same index; JAX's
    TieredIvf.load of the port's file answers alike but for ties."""
    x, q, _ = data
    j = JIvf.build(x, n_clusters=24, kmeans_iters=4, cluster_cap=64, dtype=dtype)
    jpath, tpath = str(tmp_path / "j.ivf"), str(tmp_path / "t.ivf")
    j.save(jpath)
    _to_port(j).save(tpath)
    want_ids, want_d = TieredIvf.from_ivf(_to_port(j), device="cpu").search_batch(q, 10, nprobe=6)
    for path in (jpath, tpath):
        t = TieredIvf.load(path, device="cpu")
        assert isinstance(t.host_blocks, np.memmap) and isinstance(t.host_block_ids, np.memmap)
        assert (dtype == "int8") == isinstance(t.host_block_scales, np.memmap)
        ids, d = t.search_batch(q, 10, nprobe=6)
        assert np.array_equal(ids, want_ids) and np.array_equal(d, want_d)
    jids, jd = JTiered.load(tpath).search_batch(q, 10, nprobe=6)
    _assert_equal_but_ties(want_ids, want_d, np.asarray(jids), np.asarray(jd))


def test_search_probed_is_the_grouped_search(data):
    """search_probed on the coarse probe's blocks is _ivf_search_grouped bit
    for bit; the tiered route's renumbered probes into the fetched blocks
    give the same result as global probes over all blocks; recall is JAX's
    TieredIvf recall bar (self top-1 > 0.95)."""
    x, q, _ = data
    index = IvfIndex.build(x, n_clusters=24, kmeans_iters=4, cluster_cap=64, device="cpu")
    qn = ivf.D.normalize(torch.as_tensor(q))
    probes = ivf._probe(qn, index.centroids, 6)
    S = ivf.slot_count(index.k, len(q), 6, 32)
    args = (index.blocks, index.block_ids, index.block_scales, qn)
    a = ivf._ivf_search_grouped(index.centroids, *args, nprobe=6, k_out=10, group_cap=32, num_slots=S)
    b = ivf.search_probed(probes, *args, k_out=10, group_cap=32, num_slots=S)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    uniq, inv = torch.unique(probes, return_inverse=True)
    c = ivf.search_probed(inv, index.blocks[uniq], index.block_ids[uniq], index.block_scales[uniq], qn, k_out=10,
                          group_cap=32, num_slots=ivf.slot_count(len(uniq), len(q), 6, 32))
    assert all(torch.equal(u, v) for u, v in zip(a, c))
    t = TieredIvf.from_ivf(index, device="cpu")
    ids, _ = t.search_batch(x[:200], 5, nprobe=8)
    assert np.mean(ids[:, 0] == np.arange(200)) > 0.95
