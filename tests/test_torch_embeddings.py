"""Bag-of-embeddings elements in granne_tpu_torch against granne_tpu: the
``SumEmbeddings`` container, ``reorder_keys``, the HNSW build over it
(uncached and flat cache-fed), searches over one JAX-built graph
(uncached, flat cache through K1's plain version, tiled cache through K2's
plain version), and ``reorder_by_keys`` with ``reorder_keys`` (the JAX
package's embeddings reorder workflow).

Both packages get the same numpy embedding table and term lists from a
seed; the JAX side runs with its Pallas routes off, as its own tests do.
Vectors agree within 1e-6, term lists and keys are equal, graphs agree by
per-layer edge Jaccard above 0.95 (tests/test_torch_builder.py's bar), and
searches by id overlap >= 0.99.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.elements.embeddings import SumEmbeddings as JSum
from granne_tpu.elements.embeddings import reorder_keys as j_reorder_keys
from granne_tpu.index.graph import LayerStack as JLayerStack
from granne_tpu_torch import BuildConfig, Granne, SumEmbeddings, build_layers, reorder_keys
from granne_tpu_torch.convert import granne_from_numpy, sum_embeddings_from_numpy


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


V, D, N = 300, 24, 800
CFG = dict(num_neighbors=10, max_search=30)
ATOL = 1e-6


def _parts(rng, v=V, d=D, n=N, max_terms=6):
    """An embedding table and n lists of 1..max_terms-1 distinct terms."""
    emb = rng.standard_normal((v, d)).astype(np.float32)
    lists = [list(rng.choice(v, size=rng.integers(1, max_terms), replace=False)) for _ in range(n)]
    return emb, lists


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
def data():
    emb, lists = _parts(np.random.default_rng(11))
    return emb, lists, JSum.from_parts(emb, lists), SumEmbeddings.from_parts(emb, lists, device="cpu")


@pytest.fixture(scope="module")
def jax_graph(data):
    """A JAX-built graph over the container, and 96 queries (48 elements'
    own vectors, 48 sums of random term pairs)."""
    emb, lists, j, _ = data
    layers = J.build_layers(j, J.BuildConfig(**CFG))
    rng = np.random.default_rng(5)
    own = np.asarray(j.get(jnp.arange(48, dtype=jnp.int32)))
    pairs = emb[rng.integers(0, V, (48, 2))].sum(axis=1)
    return layers, np.concatenate([own, pairs]).astype(np.float32)


def test_container_matches_jax(data):
    """get, create_embedding (lists within the width), self_dist (1 for an
    empty row), the distances, permute and extend (lists within the width)
    within 1e-6 of JAX's; get_terms equal; carried across from numpy."""
    emb, lists, _, _ = data
    lists = [list(x) for x in lists]
    lists[7] = []  # a row of -1 only: the zero vector
    j = JSum.from_parts(emb, lists)
    t = SumEmbeddings.from_parts(emb, lists, device="cpu")
    assert t.terms.dtype == torch.int32 and torch.equal(t.terms, torch.as_tensor(np.array(j.terms)))
    assert len(t) == len(j) == N and t.dim == j.dim == D
    ids = np.random.default_rng(2).integers(0, N, (9, 7)).astype(np.int32)
    ids[0, :3] = [7, 7, 7]
    tid, jid = torch.as_tensor(ids), jnp.asarray(ids)
    np.testing.assert_allclose(t.get(tid).numpy(), np.asarray(j.get(jid)), rtol=0, atol=ATOL)
    assert np.all(t.get(tid)[0, 0].numpy() == 0.0)
    np.testing.assert_allclose(t.self_dist(tid).numpy(), np.asarray(j.self_dist(jid)), rtol=0, atol=ATOL)
    assert float(t.self_dist(torch.tensor([7]))[0]) == 1.0
    q = np.random.default_rng(3).standard_normal((9, D)).astype(np.float32)
    tq, jq = t.prepare_queries(q), j.prepare_queries(jnp.asarray(q))
    np.testing.assert_allclose(t.dist_ids_to_queries(tid, tq).numpy(), np.asarray(j.dist_ids_to_queries(jid, jq)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.pairwise_from_ids(tid).numpy(), np.asarray(j.pairwise_from_ids(jid)),
                               rtol=0, atol=ATOL)
    assert abs(t.dist(3, 9) - j.dist(3, 9)) <= ATOL
    for terms in ([1, 2, 5], [4], [], list(range(j.terms.shape[1]))):
        np.testing.assert_allclose(t.create_embedding(terms), j.create_embedding(terms), rtol=0, atol=ATOL)
    for i in (0, 7, 17, N - 1):
        assert t.get_terms(i) == j.get_terms(i) == [int(x) for x in lists[i]]
    order = np.random.default_rng(4).permutation(N)
    tp, jp = t.permute(order), j.permute(order)
    assert torch.equal(tp.terms, torch.as_tensor(np.array(jp.terms)))
    np.testing.assert_allclose(tp.get(tid).numpy(), np.asarray(jp.get(jid)), rtol=0, atol=ATOL)
    new = [[1, 2], [3], [9, 8, 7, 6, 5]]
    te, je = t.extend(new), j.extend(new)
    assert torch.equal(te.terms, torch.as_tensor(np.array(je.terms))) and len(t) == N
    last = torch.arange(N, N + 3)
    np.testing.assert_allclose(te.get(last).numpy(), np.asarray(je.get(jnp.arange(N, N + 3))), rtol=0, atol=ATOL)
    c = sum_embeddings_from_numpy(emb, np.asarray(j.terms), device="cpu")
    assert torch.equal(c.terms, t.terms) and torch.equal(c.embeddings, t.embeddings)


def test_reorder_keys_match_jax(data):
    """reorder_keys equals JAX's int64 keys: terms by descending norm,
    stable among equal norms (a repeated word), cut to max_terms, V-padded."""
    emb, lists, j, t = data
    for max_terms in (8, 3, 1):
        assert np.array_equal(reorder_keys(t, max_terms), j_reorder_keys(j, max_terms))
    rng = np.random.default_rng(6)
    dup = [list(rng.integers(0, V, rng.integers(1, 12))) for _ in range(200)]
    dup[0] = []
    dup[1] = [4, 4, 9, 4]
    emb2 = emb.copy()
    emb2[9] = emb2[4]  # equal norms: list order decides
    k_t = reorder_keys(SumEmbeddings.from_parts(emb2, dup, device="cpu"))
    assert np.array_equal(k_t, j_reorder_keys(JSum.from_parts(emb2, dup)))
    assert k_t.dtype == np.int64 and np.all(k_t[0] == V)


def test_build_matches_jax(data, jax_graph):
    """The port's HNSW build over SumEmbeddings against JAX's build_layers
    on the same container: the same layer counts, per-layer edge Jaccard
    above 0.95, and self-recall@1 (by vector: equal bags are equal) > 0.95."""
    _, _, _, t = data
    jl = jax_graph[0]
    tl = build_layers(t, BuildConfig(**CFG))
    assert tl.counts == jl.counts
    for a, b in zip(tl.as_numpy(), jl.as_numpy()):
        assert a.shape == b.shape and _jaccard(a, b) > 0.95
    own = t.get(torch.arange(N))
    ids, _ = Granne(layers=tl, elements=t).search_batch(own, max_search=20, num_neighbors=1)
    found = t.get(ids[:, 0])
    assert float(torch.mean((torch.sum(found * own, dim=1) > 1 - 1e-5).float())) > 0.95


def test_searches_over_a_jax_graph_match_jax(data, jax_graph):
    """One JAX-built graph, the same queries: uncached, flat cache (K1's
    plain version) and tiled cache (K2's plain version) searches overlap
    JAX's by >= 0.99, distances within 1e-5 (bf16 routes: JAX's XLA routes
    sum the same bf16 products in another order)."""
    _, _, j, t = data
    jl, queries = jax_graph
    tl = granne_from_numpy(jl.as_numpy(), t, device="cpu").layers
    jg, tg = J.Granne(layers=jl, elements=j), Granne(layers=tl, elements=t)
    for layout in (None, "flat", "tiled"):
        ji = jg if layout is None else jg.with_neighbor_cache(layout=layout)
        ti = tg if layout is None else tg.with_neighbor_cache(layout)
        jids, jd = ji.search_batch(queries, max_search=24, num_neighbors=5)
        ids, d = ti.search_batch(queries, max_search=24, num_neighbors=5)
        assert _overlap(ids.numpy(), jids) >= 0.99, layout
        np.testing.assert_allclose(np.sort(d.numpy()), np.sort(np.asarray(jd)), rtol=0, atol=1e-5)
    assert tg.with_neighbor_cache("flat").nbr_vecs.dtype == torch.int16
    assert tg.with_neighbor_cache("tiled").nbr_vecs.dtype == torch.bfloat16


def test_flat_cache_fed_build_matches_jax(data, jax_graph):
    """A flat cache-fed build (K1's plain version in every wave's beam, merges
    fed from the bf16 cache) in each package: per-layer edge Jaccard above
    0.95, and both served through a flat cache overlap JAX's uncached
    graph's answers alike (within 0.02 of each other, each >= 0.9)."""
    _, _, j, t = data
    jl, queries = jax_graph
    cfg = dict(neighbor_cache=True, neighbor_cache_layout="flat", **CFG)
    tl = build_layers(t, BuildConfig(**cfg))
    jcl = J.build_layers(j, J.BuildConfig(**cfg))
    assert tl.counts == jcl.counts
    for a, b in zip(tl.as_numpy(), jcl.as_numpy()):
        assert _jaccard(a, b) > 0.95
    ref, _ = J.Granne(layers=jl, elements=j).search_batch(queries, max_search=40, num_neighbors=5)
    jids, _ = J.Granne(layers=jcl, elements=j).with_neighbor_cache(layout="flat").search_batch(
        queries, max_search=40, num_neighbors=5)
    ids, _ = Granne(layers=tl, elements=t).with_neighbor_cache("flat").search_batch(
        queries, max_search=40, num_neighbors=5)
    o_t, o_j = _overlap(ids.numpy(), ref), _overlap(jids, ref)
    assert o_t >= 0.9 and o_j >= 0.9 and abs(o_t - o_j) <= 0.02, (o_t, o_j)


def test_reorder_by_keys_workflow_matches_jax():
    """JAX's embeddings reorder workflow (tests/test_reorder.py::
    test_reorder_by_keys_embeddings_doctest, lists with repeated words) on
    one graph (the port's build, carried to JAX): the same order, the same
    terms and layers after the reorder, element i holding old order[i]'s
    terms, and self-queries resolving through the translation."""
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((V, 12)).astype(np.float32)
    lists = [list(rng.integers(0, V, rng.integers(1, 6))) for _ in range(250)]
    j = JSum.from_parts(emb, lists)
    t = SumEmbeddings.from_parts(emb, lists, device="cpu")
    tg = Granne(layers=build_layers(t, BuildConfig(num_neighbors=10, max_search=20)), elements=t)
    jl = JLayerStack.from_numpy(tg.layers.as_numpy())
    jr, jorder = J.Granne(layers=jl, elements=j).reorder_by_keys(j_reorder_keys(j))
    tr, order = tg.reorder_by_keys(reorder_keys(t))
    assert np.array_equal(order, np.asarray(jorder))
    assert torch.equal(tr.elements.terms, torch.as_tensor(np.array(jr.elements.terms)))
    for a, b in zip(tr.layers.as_numpy(), JLayerStack.as_numpy(jr.layers)):
        assert np.array_equal(np.sort(a, axis=1), np.sort(b, axis=1))
    for i in (0, 17, 249):
        assert tr.elements.get_terms(i) == t.get_terms(int(order[i]))
    q = t.get(torch.as_tensor(order[:40]))
    ids, _ = tr.search_batch(q, max_search=20, num_neighbors=1)
    assert float(np.mean(ids[:, 0].numpy() == np.arange(40))) > 0.9
