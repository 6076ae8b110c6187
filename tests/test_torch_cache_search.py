"""Serving through the rest of the neighbor cache against granne_tpu: the
tiled layout (K2), f32 flat rows, the beam's gather_budget and
search_layers(rerank=...).

One graph per file (built by the port, carried to JAX as numpy); both
packages search it with the same unit vectors.  The JAX side's tiled
serving runs the Pallas kernel interpreted, as tests/test_nbr_score.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index.granne import Granne as JGranne
from granne_tpu.index.graph import LayerStack as JLayerStack
from granne_tpu.ops import frontier as jfrontier
from granne_tpu.ops.nbr_cache import make_neighbor_cache as j_make_cache
from granne_tpu_torch import AngularVectors, BuildConfig, build_layers
from granne_tpu_torch.index.granne import Granne
from granne_tpu_torch.ops import frontier
from granne_tpu_torch.ops.nbr_cache import make_neighbor_cache


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
    threads on top of them oversubscribe the cores, which slows its small
    eager ops (a wave build is thousands of them) many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, D, M = 1500, 24, 10
NQ = 128


@pytest.fixture(scope="module")
def graph():
    """(port layers, JAX layers, f32 elements of both, raw queries)."""
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    jel = J.AngularVectors.from_raw(vecs)
    tel = AngularVectors.from_normalized(np.asarray(jel.vectors), device="cpu")
    tl = build_layers(tel, BuildConfig(num_neighbors=M, max_search=30))
    jl = JLayerStack.from_numpy(tl.as_numpy())
    queries = np.concatenate([vecs[:NQ // 2], rng.standard_normal((NQ // 2, D)).astype(np.float32)])
    return tl, jl, tel, jel, queries


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


def test_tiled_serving_matches_jax(graph):
    """Granne.with_neighbor_cache("tiled") serves through K2: ids overlap
    JAX's interpreted-Pallas serving >= 0.99, and the port's tiled search
    equals its uncached bf16 search on > 99% of ids (JAX's own bar)."""
    tl, jl, tel, jel, queries = graph
    jidx = JGranne(layers=jl, elements=jel.as_bf16()).with_neighbor_cache(layout="tiled")
    jids, jd = jidx.search_batch(queries, max_search=24, num_neighbors=5)
    plain = Granne(layers=tl, elements=tel.as_bf16())
    idx = plain.with_neighbor_cache("tiled")
    assert idx.nbr_vecs.shape == (N, 16, 128) and idx.nbr_vecs.dtype == torch.bfloat16
    ids, d = idx.search_batch(queries, max_search=24, num_neighbors=5)
    assert _overlap(ids.numpy(), np.asarray(jids)) >= 0.99
    np.testing.assert_allclose(np.sort(d.numpy()), np.sort(np.asarray(jd)), atol=1e-5)
    ids0, _ = plain.search_batch(queries, max_search=24, num_neighbors=5)
    assert np.mean(ids0.numpy() == ids.numpy()) > 0.99


def test_f32_cache_beam_equals_uncached(graph):
    """A cache_dtype="f32" table holds exact rows: the cached search gives
    the uncached f32 search's ids, distances within rtol 1e-6, and JAX's
    f32-cache ids."""
    tl, jl, tel, jel, queries = graph
    kw = dict(ef=20, num_neighbors=10, expand=1, descent_ef=4)
    q = tel.prepare_queries(queries)
    tab = make_neighbor_cache(tl.layers[-1], tel, rows=N, cache_dtype="f32")
    ids0, d0 = frontier.search_layers(tl.layers, tel, q, **kw)
    ids1, d1 = frontier.search_layers(tl.layers, tel, q, nbr_vecs=tab, **kw)
    assert torch.equal(ids0, ids1)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=1e-6)
    jtab = j_make_cache(jl.layers[-1], jel, rows=N, cache_dtype="f32")
    jids, _ = jfrontier.search_layers(jl.layers, jel, jel.prepare_queries(jnp.asarray(queries)), nbr_vecs=jtab, **kw)
    assert _overlap(ids1.numpy(), np.asarray(jids)) >= 0.99


def test_gather_budget_matches_jax(graph):
    """A budget >= expand*M is byte-for-byte the unbudgeted search; a tight
    budget (M) agrees with JAX's budgeted ids."""
    tl, jl, tel, jel, queries = graph
    kw = dict(ef=20, num_neighbors=5, expand=2)
    q = tel.prepare_queries(queries)
    base_ids, base_d = frontier.search_layers(tl.layers, tel, q, **kw)
    full_ids, full_d = frontier.search_layers(tl.layers, tel, q, gather_budget=2 * M, **kw)
    assert torch.equal(base_ids, full_ids) and torch.equal(base_d, full_d)
    tight_ids, _ = frontier.search_layers(tl.layers, tel, q, gather_budget=M, **kw)
    jids, _ = jfrontier.search_layers(jl.layers, jel, jel.prepare_queries(jnp.asarray(queries)), gather_budget=M, **kw)
    assert _overlap(tight_ids.numpy(), np.asarray(jids)) >= 0.99


def test_rerank_f32_container_is_noop(graph):
    """On the exact f32 container a rerank re-sorts by the same metric:
    neither ids nor distances change."""
    tl, _, tel, _, queries = graph
    kw = dict(ef=20, num_neighbors=5, expand=1)
    q = tel.prepare_queries(queries)
    ids0, d0 = frontier.search_layers(tl.layers, tel, q, **kw)
    ids1, d1 = frontier.search_layers(tl.layers, tel, q, rerank=True, **kw)
    assert torch.equal(ids0, ids1)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=1e-5)


def test_bf16_serving_reranked_against_f32_matches_jax(graph):
    """bf16 serving through the flat cache, its final beam reranked against
    the f32 container with the unrounded f32 unit queries: ids overlap
    JAX's >= 0.99, distances within 1e-5 of JAX's and of an exact numpy
    recompute, ascending."""
    tl, jl, tel, jel, queries = graph
    kw = dict(ef=24, num_neighbors=10, expand=1)
    el16, jel16 = tel.as_bf16(), jel.as_bf16()
    tab = make_neighbor_cache(tl.layers[-1], el16, rows=N)
    ids, d = frontier.search_layers(
        tl.layers, el16, el16.prepare_queries(queries), nbr_vecs=tab, rerank=True,
        rerank_with=tel, rerank_queries=tel.prepare_queries(queries), **kw,
    )
    jtab = j_make_cache(jl.layers[-1], jel16, rows=N)
    jids, jd = jfrontier.search_layers(
        jl.layers, jel16, jel16.prepare_queries(jnp.asarray(queries)), nbr_vecs=jtab, rerank=True,
        rerank_with=jel, rerank_queries=jel.prepare_queries(jnp.asarray(queries)), **kw,
    )
    ids, d = ids.numpy(), d.numpy()
    assert _overlap(ids, np.asarray(jids)) >= 0.99
    np.testing.assert_allclose(np.sort(d), np.sort(np.asarray(jd)), atol=1e-5)
    unit = np.asarray(jel.vectors)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    for i in range(NQ):
        np.testing.assert_allclose(d[i], np.maximum(0.0, 1.0 - unit[ids[i]] @ qn[i]), atol=1e-5)
        assert np.all(np.diff(d[i]) >= 0)
