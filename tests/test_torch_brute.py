"""granne_tpu_torch's brute-force engine and exact ground truth
(models/brute.py) against granne_tpu's.

The JAX package ranks with ``lax.approx_max_k``; the port's top-k is exact,
so its recall is at least JAX's on the same stored arrays.  Each test
states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granne_tpu.models import brute as jbrute
from granne_tpu.ops import distance as jdist
from granne_tpu_torch import BruteForceIndex, convert
from granne_tpu_torch.models import brute


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


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def _gt(x, q, k):
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_brute_force_recall_at_least_jax(rng, storage):
    """Same stored arrays (built by JAX, carried across): the port's exact
    top-k reaches at least JAX's approx_max_k recall@10, and the stored
    arrays the port builds itself equal JAX's (bf16 within one rounding
    step of the 1-ulp normalize difference, int8 codes mostly equal)."""
    x = _clustered(rng, 5000, 32)
    q = _clustered(np.random.default_rng(4), 64, 32)
    gt = _gt(x, q, 10)
    j = jbrute.BruteForceIndex.build(x, storage=storage)
    t = convert.brute_from_numpy(np.asarray(j.vectors), np.asarray(j.scale), j.n_total, device="cpu")
    jr = _overlap(np.asarray(j.search_batch(q, 10)[0]), gt)
    ids, dists = t.search_batch(q, 10)
    assert _overlap(ids, gt) >= jr and ids.dtype == torch.int32
    assert np.all(np.diff(dists.numpy(), axis=1) >= 0)
    own = BruteForceIndex.build(x, storage=storage, device="cpu")
    assert own.vectors.shape == t.vectors.shape == (5120, 32) and own.n_total == 5000
    if storage == "int8":
        assert np.mean(own.vectors.numpy() == t.vectors.numpy()) >= 0.999
    else:
        np.testing.assert_allclose(own.vectors.float().numpy(), t.vectors.float().numpy(), rtol=0, atol=2e-3)
    with pytest.raises(ValueError, match="storage"):
        BruteForceIndex.build(x, storage="f16", device="cpu")


def test_brute_force_is_exact(rng):
    """Port of test_ivf_brute.py::test_brute_force_is_exact."""
    x = rng.standard_normal((5000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    ids, dists = BruteForceIndex.build(x, device="cpu").search_batch(q, num_neighbors=10)
    gt = _gt(x, q, 10)
    assert np.mean(ids[:, 0].numpy() == gt[:, 0]) >= 0.95
    assert _overlap(ids, gt) >= 0.9
    assert np.all(np.diff(dists.numpy(), axis=1) >= -1e-6)


def test_exact_topk_returns_jax_ids(rng):
    """Chunked exact ground truth (chunk < n: the cross-chunk merge and a
    short last chunk): JAX's ids, distances within 1e-6; with exact
    duplicates the lower id comes first in both."""
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    x[2000] = x[17]  # an exact duplicate across chunks
    q = rng.standard_normal((32, 24)).astype(np.float32)
    q[0] = x[17]
    xn = np.asarray(jdist.normalize(jnp.asarray(x)))
    qn = np.asarray(jdist.normalize(jnp.asarray(q)))
    jid, jd = jbrute.exact_topk(xn, qn, 10, chunk=1024)
    for xs in (xn, _t(xn)):
        tid, td = brute.exact_topk(xs, qn, 10, chunk=1024)
        assert tid.dtype == np.int64 and np.array_equal(tid, jid)
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    assert list(tid[0, :2]) == [17, 2000]
