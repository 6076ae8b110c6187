"""granne_tpu_torch's IVF search (index/ivf.py) against granne_tpu's.

The same index (built by JAX and carried across, or built by each package
from the same numpy data) and queries go through both packages on the CPU.
The port's scoring kernels run their plain PyTorch versions for CPU
tensors (the CUDA kernels are checked on the card by
tests/test_torch_cuda.py; the plain versions against the Pallas kernels by
tests/test_torch_ivf_score.py).  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
from granne_tpu.ops import distance as jdist
from granne_tpu_torch import BruteForceIndex, IvfIndex, convert
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


def _t(x):
    return torch.as_tensor(np.array(x))


def _clustered(rng, n, d, c=30, sigma=0.3):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return (centers[rng.integers(0, c, n)] + sigma * rng.standard_normal((n, d))).astype(np.float32)


def _jax_to_port(j) -> IvfIndex:
    return convert.ivf_from_numpy(
        np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids), np.asarray(j.block_scales),
        j.n_total, device="cpu",
    )


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def _gt(x, q, k):
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :k]


def test_search_on_a_jax_built_index_matches_jax(rng):
    """The same index (built by JAX, carried across) and queries: grouped
    (K4 and K3 plain routes, the fused K5 route) and non-grouped searches
    return JAX's ids with overlap >= 0.99 against JAX's XLA route and its
    fused Pallas route, and distances within 1e-3 (queries normalized in
    either package differ by an ulp before their bf16 rounding)."""
    x = _clustered(rng, 3000, 32)
    q = _clustered(np.random.default_rng(9), 160, 32)
    j = jivf.IvfIndex.build(x, n_clusters=24, kmeans_iters=4, cluster_cap=64)
    t = _jax_to_port(j)
    qn = jdist.normalize(jnp.asarray(q))
    B, nprobe, cap = 160, 6, 16
    S = min(B * nprobe, j.k + (B * nprobe) // cap + 8)
    args = (j.centroids, j.blocks, j.block_ids, j.block_scales, qn)
    kw = dict(nprobe=nprobe, k_out=10, group_cap=cap, num_slots=S)
    jx_ids, jx_d = jivf._ivf_search_grouped(*args, use_pallas=False, **kw)
    jp_ids, jp_d = jivf._ivf_search_grouped(*args, use_pallas_topk=True, **kw)
    targs = (t.centroids, t.blocks, t.block_ids, t.block_scales, distance.normalize(_t(q)))
    for fused, slot_group in ((False, 8), (False, 1), (True, 8)):
        ids, d = ivf._ivf_search_grouped(*targs, use_pallas_topk=fused, slot_group=slot_group, **kw)
        for want_ids, want_d in ((jx_ids, jx_d), (jp_ids, jp_d)):
            assert _overlap(ids, want_ids) >= 0.99
            np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=1e-3)
    jn_ids, _ = jivf._ivf_search(*args, nprobe=nprobe, k_out=10, query_chunk=64)
    tn_ids, _ = ivf._ivf_search(*targs, nprobe=nprobe, k_out=10, query_chunk=64)
    assert _overlap(tn_ids, jn_ids) >= 0.99
    # the public entry point, both routes
    pub = j.search_batch(q, 10, nprobe=nprobe)[0]
    for fused in (False, True):
        assert _overlap(t.search_batch(q, 10, nprobe=nprobe, fused_topk=fused)[0], pub) >= 0.99
    assert _overlap(t.search_batch(q, 10, nprobe=nprobe, grouped=False, query_chunk=50)[0], pub) >= 0.99


def test_ivf_recall(rng):
    """Port of test_ivf_brute.py::test_ivf_recall."""
    x = rng.standard_normal((8000, 32)).astype(np.float32)
    q = x[:128]
    index = IvfIndex.build(x, n_clusters=64, kmeans_iters=8, device="cpu")
    ids, _ = index.search_batch(q, num_neighbors=10, nprobe=8)
    assert np.mean(ids[:, 0].numpy() == np.arange(128)) > 0.95
    ids32 = index.search_batch(q, num_neighbors=10, nprobe=32)[0]
    assert _overlap(ids32, _gt(x, q, 10)) > 0.9


def test_ivf_no_element_dropped(rng):
    """Port of test_ivf_brute.py::test_ivf_no_element_dropped."""
    index = IvfIndex.build(rng.standard_normal((3000, 16)).astype(np.float32), n_clusters=32, kmeans_iters=5, device="cpu")
    live = index.block_ids[index.block_ids >= 0].numpy()
    assert len(live) == 3000 and set(live.tolist()) == set(range(3000))


def test_ivf_nprobe_monotone_recall(rng):
    """Port of test_ivf_brute.py::test_ivf_nprobe_monotone_recall."""
    x = rng.standard_normal((6000, 24)).astype(np.float32)
    q = x[:100]
    index = IvfIndex.build(x, n_clusters=64, kmeans_iters=6, device="cpu")
    gt = _gt(x, q, 10)
    last = 0.0
    for nprobe in [2, 8, 48]:
        ov = _overlap(index.search_batch(q, num_neighbors=10, nprobe=nprobe)[0], gt)
        assert ov >= last - 0.02
        last = ov
    assert last > 0.95


def test_ivf_int8_blocks_recall(rng):
    """Port of test_ivf_brute.py::test_ivf_int8_blocks_recall, both routes."""
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = x[:100]
    i_f = IvfIndex.build(x, n_clusters=48, kmeans_iters=6, device="cpu")
    i_q = IvfIndex.build(x, n_clusters=48, kmeans_iters=6, dtype="int8", device="cpu")
    assert i_q.blocks.dtype == torch.int8
    ids_f = i_f.search_batch(q, 10, nprobe=16)[0].numpy()
    for fused in (False, True):
        ids_q = i_q.search_batch(q, 10, nprobe=16, fused_topk=fused)[0].numpy()
        assert np.mean(ids_q[:, 0] == np.arange(100)) > 0.95
        assert _overlap(ids_f, ids_q) > 0.85


def test_ivf_pathological_probe_skew(rng):
    """Port of test_ivf_brute.py::test_ivf_pathological_probe_skew: every
    query probes the same cluster; the grouped path spills it into
    duplicate slots without dropping results, on both routes."""
    n, d = 4000, 24
    center = rng.standard_normal(d).astype(np.float32)
    vecs = np.concatenate([
        center + 0.01 * rng.standard_normal((200, d)).astype(np.float32),
        rng.standard_normal((n - 200, d)).astype(np.float32) * 5.0,
    ])
    index = IvfIndex.build(vecs, n_clusters=64, kmeans_iters=6, cluster_cap=64, device="cpu")
    q = center + 0.01 * rng.standard_normal((256, d)).astype(np.float32)
    gt = BruteForceIndex.build(vecs, device="cpu").search_batch(q, 10)[0]
    for fused in (False, True):
        ids = index.search_batch(q, 10, nprobe=4, group_cap=8, fused_topk=fused)[0]
        assert bool((ids >= 0).all()), "spill path dropped results"
        assert _overlap(ids, gt) > 0.9


def test_ivf_tiny_n_and_n_less_than_k(rng):
    """Port of test_ivf_brute.py::test_ivf_tiny_n_and_n_less_than_k."""
    for n in (3, 9, 40):
        vecs = rng.standard_normal((n, 8)).astype(np.float32)
        index = IvfIndex.build(vecs, n_clusters=16, kmeans_iters=2, cluster_cap=8, device="cpu")
        for fused in (False, True):
            ids = index.search_batch(vecs, min(5, n), nprobe=min(16, index.k), fused_topk=fused)[0].numpy()
            assert ids.shape[0] == n and np.mean(ids[:, 0] == np.arange(n)) > 0.9
