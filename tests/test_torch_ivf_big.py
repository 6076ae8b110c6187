"""granne_tpu_torch's chunked IVF builders and block-scan ground truth
(index/ivf_big.py) against granne_tpu's.

The same numpy data (fixed seeds) goes to both packages on the CPU.  Each
test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
from granne_tpu.index import ivf_big as jbig
from granne_tpu.ops import distance as jdist
from granne_tpu_torch import convert
from granne_tpu_torch.index import ivf_big
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


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


@pytest.fixture
def big_data(rng):
    centers = rng.standard_normal((20, 16)).astype(np.float32)
    return (centers[rng.integers(0, 20, 2000)] + 0.3 * rng.standard_normal((2000, 16))).astype(np.float32)


def _exact_up_to_ties(ids, q_np, x_np, gt_v, k=5, tol=5e-3):
    cos = np.einsum("bd,bkd->bk", q_np, x_np[np.asarray(ids)])
    return bool(np.all(cos >= gt_v[:, k - 1 : k] - tol))


def test_ivf_big_f32_chunked_matches_jax(big_data):
    """The chunked f32 builder (three chunks): every element placed once,
    exact up to bf16 ties at full probe (the body of test_ivf_big.py's
    test), and ids overlap >= 0.95 with JAX's index at a small nprobe."""
    kw = dict(n_clusters=16, cluster_cap=64, kmeans_iters=4, chunk=700, kmeans_sample=1024, log=lambda m: None)
    t = ivf_big.build_ivf_f32_chunked(big_data, device="cpu", **kw)
    j = jbig.build_ivf_f32_chunked(big_data, **kw)
    assert t.blocks.dtype == torch.bfloat16
    assert sorted(t.block_ids[t.block_ids >= 0].tolist()) == list(range(2000))
    q = distance.normalize(_t(big_data[:64]))
    gt, gt_v = ivf_big.exact_topk_over_blocks(t, q, 5, block_chunk=8)
    ids = t.search_batch(q, 5, nprobe=t.k, grouped=False, query_chunk=32)[0]
    xn = distance.normalize(_t(big_data)).numpy()
    assert _exact_up_to_ties(ids, q.numpy(), xn, gt_v) and int(ids[0, 0]) == 0
    jq = jdist.normalize(jnp.asarray(big_data[:64]))
    assert _overlap(t.search_batch(q, 5, nprobe=6)[0], j.search_batch(jq, 5, nprobe=6)[0]) >= 0.95
    assert ivf_big.build_ivf_f32_chunked(big_data, device="cpu", dtype="float32", **kw).blocks.dtype == torch.float32


@pytest.mark.parametrize("device_resident", [True, False])
def test_ivf_big_i8_chunked_matches_jax(big_data, device_resident):
    """The chunked int8 builder: int8 blocks, scales equal to the codes'
    inverse norms, exact up to ties at full probe, overlap >= 0.95 with
    JAX's; ``device_resident=False`` keeps the index in host memory."""
    x_i8 = np.asarray(jdist.quantize_i8(jdist.normalize(jnp.asarray(big_data))))
    kw = dict(n_clusters=16, cluster_cap=64, kmeans_iters=4, chunk=512, kmeans_sample=1024, log=lambda m: None)
    t = ivf_big.build_ivf_i8_chunked(x_i8, device="cpu", device_resident=device_resident, **kw)
    j = jbig.build_ivf_i8_chunked(x_i8, device_resident=device_resident, **kw)
    assert t.blocks.dtype == torch.int8 and t.blocks.device.type == "cpu"
    live = t.block_ids >= 0
    np.testing.assert_allclose(
        t.block_scales[live].numpy(), distance.inv_norms_i8(t.blocks[live]).numpy(), rtol=0, atol=1e-7
    )
    q = distance.normalize(_t(big_data[:64]))
    gt, gt_v = ivf_big.exact_topk_over_blocks(t, q, 5, block_chunk=8)
    ids = t.search_batch(q, 5, nprobe=t.k, grouped=False, query_chunk=32)[0]
    xf = x_i8.astype(np.float32)
    assert _exact_up_to_ties(ids, q.numpy(), xf / np.linalg.norm(xf, axis=1, keepdims=True), gt_v)
    jq = jdist.normalize(jnp.asarray(big_data[:64]))
    assert _overlap(t.search_batch(q, 5, nprobe=6)[0], jivf.IvfIndex.search_batch(j, jq, 5, nprobe=6)[0]) >= 0.95


def test_exact_topk_over_blocks_matches_jax(big_data):
    """On the same (JAX-built) index: ids equal, cosines within 1e-6."""
    j = jbig.build_ivf_f32_chunked(
        big_data, n_clusters=16, cluster_cap=64, kmeans_iters=3, chunk=1000, kmeans_sample=1024,
        dtype="float32", log=lambda m: None,
    )
    q = np.asarray(jdist.normalize(jnp.asarray(big_data[:40] + 0.05)))
    jid, jv = jbig.exact_topk_over_blocks(j, jnp.asarray(q), 5, block_chunk=8)
    port = convert.ivf_from_numpy(
        np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids), np.asarray(j.block_scales),
        j.n_total, device="cpu",
    )
    tid, tv = ivf_big.exact_topk_over_blocks(port, q, 5, block_chunk=8)
    assert np.array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=1e-6)
