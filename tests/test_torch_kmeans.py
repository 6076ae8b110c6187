"""granne_tpu_torch's IVF coarse quantizer against granne_tpu's: k-means
(ops/kmeans.py) and the coarse probe's order at ties (index/ivf.py).

The seeding is pure numpy and bit-equal; Lloyd's update sums in another f32
order than XLA's scatter-add, so assignments and centroids are compared by
agreement.  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
import granne_tpu.ops.kmeans as jkmeans
from granne_tpu.ops import distance as jdist
from granne_tpu_torch.index import ivf
from granne_tpu_torch.ops import distance, kmeans


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


def test_kmeanspp_init_bit_equal_to_jax(rng):
    x = np.asarray(jdist.normalize(jnp.asarray(_clustered(rng, 3000, 24))))
    for k, sample in ((40, 20000), (300, 500)):  # the second subsamples
        want = jkmeans._kmeanspp_init(x, k, np.random.default_rng(3), sample=sample)
        got = kmeans._kmeanspp_init(x, k, np.random.default_rng(3), sample=sample)
        assert np.array_equal(got, want)


def test_lloyd_step_agrees_with_jax(rng):
    """One assignment + update from the same centroids: >= 0.999 of the
    points assigned alike, centroids within 1e-5 (f32 summation order)."""
    x = np.asarray(jdist.normalize(jnp.asarray(_clustered(rng, 4000, 24))))
    c0 = jkmeans._kmeanspp_init(x, 40, np.random.default_rng(1))
    ja = np.asarray(jkmeans.assign_clusters(jnp.asarray(x), jnp.asarray(c0), chunk=1024))
    ta = kmeans.assign_clusters(_t(x), _t(c0), chunk=1000)
    assert ta.dtype == torch.int32 and np.mean(ta.numpy() == ja) >= 0.999
    jc, jn = jkmeans._update_centroids(jnp.asarray(x), jnp.asarray(ja), k=40)
    tc, tn = kmeans._update_centroids(_t(x), _t(ja), k=40)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    assert np.array_equal(tn.numpy(), np.asarray(jn))


def test_train_kmeans_agrees_with_jax(rng):
    """Same seed, same init, a few Lloyd's iterations with an empty-cluster
    reseed: assignments agree >= 0.99, centroids within 1e-4."""
    x = np.asarray(jdist.normalize(jnp.asarray(_clustered(rng, 2000, 16, c=12, sigma=0.1))))
    jc, ja = jkmeans.train_kmeans(x, 24, iters=4, seed=5)
    tc, ta = kmeans.train_kmeans(x, 24, iters=4, seed=5)
    assert np.mean(ta.numpy() == np.asarray(ja)) >= 0.99
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)


def test_kmeans_clusters_data(rng):
    """Port of test_ivf_brute.py::test_kmeans_clusters_data."""
    k, per, d = 8, 100, 16
    centers = rng.standard_normal((k, d)).astype(np.float32) * 5
    x = np.concatenate([centers[i] + 0.05 * rng.standard_normal((per, d)) for i in range(k)]).astype(np.float32)
    x = distance.normalize(_t(x))
    _, assign = kmeans.train_kmeans(x, k, iters=15, seed=1)
    assign = assign.numpy()
    for i in range(k):
        assert len(set(assign[i * per : (i + 1) * per].tolist())) == 1
    assert len(set(assign.tolist())) == k


def test_kmeans_k_exceeds_init_subsample(rng):
    """Ports of the two k > subsample tests of test_ivf_brute.py."""
    x = rng.standard_normal((50, 8)).astype(np.float32)
    centers = kmeans._kmeanspp_init(np.repeat(x, 10, axis=0), 200, np.random.default_rng(0), sample=100)
    assert centers.shape == (200, 8) and np.all(np.isfinite(centers))
    assert kmeans._kmeanspp_init(x, 120, np.random.default_rng(0), sample=100).shape == (120, 8)
    xn = distance.normalize(_t(rng.standard_normal((400, 8)).astype(np.float32)))
    cents, assign = kmeans.train_kmeans(xn, 64, iters=4, seed=0)
    assert cents.shape == (64, 8) and assign.shape == (400,) and torch.isfinite(cents).all()


def test_duplicated_centroid_ties_probe_as_jax(rng):
    """Sub-blocks of one cluster carry bit-identical centroid rows and tie
    exactly; at the nprobe boundary both packages probe the lower blocks
    first (lax.top_k's order), so the probe lists are equal."""
    x = _clustered(rng, 2500, 24, c=6, sigma=0.2)
    j = jivf.IvfIndex.build(x, n_clusters=8, kmeans_iters=3, cluster_cap=48)
    cent = np.asarray(j.centroids)
    assert np.any(np.all(cent[1:] == cent[:-1], axis=1))  # runs of duplicated rows exist
    q = x[:200]
    qn = np.asarray(jdist.normalize(jnp.asarray(q)))
    for nprobe in (3, 5, 9):
        _, want = jax.lax.top_k(jnp.asarray(qn) @ jnp.asarray(cent).T, nprobe)
        got = ivf._probe(_t(qn), _t(cent), nprobe)
        assert np.array_equal(got.numpy(), np.asarray(want)), nprobe
