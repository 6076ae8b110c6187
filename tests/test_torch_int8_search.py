"""Serving and building int8 elements through the neighbor cache in
granne_tpu_torch against granne_tpu: the flat tables (bits equal), K1-fed
serving with both query-lane forms, the exact rerank, the f32 table,
dequantized serving, the cache-fed flat build, and the refusal of the
tiled layout.

One graph per file (built by the port's int8 builder, carried to JAX as
numpy); both packages search it with the same raw queries.  The JAX side
scores flat rows on its XLA route, the same math as K1's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.elements.angular_int import AngularIntVectors as JInt
from granne_tpu.elements.angular_int import IntQueries as JIntQueries
from granne_tpu.index.granne import Granne as JGranne
from granne_tpu.index.graph import LayerStack as JLayerStack
from granne_tpu.ops import frontier as jfrontier
from granne_tpu.ops.nbr_cache import make_neighbor_cache as j_make_cache
from granne_tpu_torch import AngularIntVectors, AngularVectors, BuildConfig, Granne, build_layers
from granne_tpu_torch.elements.angular_int import IntQueries
from granne_tpu_torch.index import builder
from granne_tpu_torch.ops import frontier, nbr_cache
from granne_tpu_torch.ops.kernels import nbr_score


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
    """(port layers, JAX layers, raw vectors, raw queries): the port's
    uncached int8 build; queries half stored rows, half fresh."""
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    tl = build_layers(AngularIntVectors.from_raw(vecs, device="cpu"), BuildConfig(num_neighbors=M, max_search=30))
    jl = JLayerStack.from_numpy(tl.as_numpy())
    queries = np.concatenate([vecs[: NQ // 2], rng.standard_normal((NQ // 2, D)).astype(np.float32)])
    return tl, jl, vecs, queries


def _np(t):
    """A tensor or JAX array as numpy (bf16 as its int16 bit patterns)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(np.asarray(a), np.asarray(b))])


def _counted_k1(monkeypatch):
    """Route the beam's K1 calls through a counter; returns the count dict."""
    calls = {"k1": 0}

    def k1(*a, **k):
        calls["k1"] += 1
        return nbr_score.gather_score_flat(*a, **k)

    monkeypatch.setattr(frontier, "gather_score_flat", k1)
    return calls


def test_flat_cache_serving_matches_jax(graph, monkeypatch):
    """The flat bf16 table of int8 elements equals JAX's bit for bit; the
    f32 table holds JAX's ids and the IEEE products ``code * inv_norm``
    (numpy's bits: XLA:CPU's products in JAX's table differ from those by
    up to 2 ulp).  Serving through the bf16 table (K1 on the exact-unit
    lanes) overlaps JAX's cached search >= 0.99, the uncached int8 search
    > 0.97 and self-recall@1 > 0.95 (JAX's bars); the code-lane form
    (queries without ``unit``) overlaps JAX's >= 0.99 too."""
    tl, jl, vecs, queries = graph
    el, jel = AngularIntVectors.from_raw(vecs, device="cpu"), JInt.from_raw(vecs)
    tab = nbr_cache.make_neighbor_cache(tl.layers[-1], el, rows=N)
    assert np.array_equal(_np(tab), _np(j_make_cache(jl.layers[-1], jel, rows=N))[:N])
    tab = nbr_cache.make_neighbor_cache(tl.layers[-1], el, rows=N, cache_dtype="f32")
    jtab = np.asarray(j_make_cache(jl.layers[-1], jel, rows=N, cache_dtype="f32"))[:N]
    adj = tl.layers[-1].numpy().clip(0)
    exact = el.vectors.numpy()[adj].astype(np.float32) * el.inv_norms.numpy()[adj][..., None]
    vecs32 = nbr_cache.row_vecs(tab, M, D).numpy().reshape(N, M, D)
    assert np.array_equal(vecs32, exact)
    assert np.array_equal(nbr_cache.unpack_ids(tab, M, D).numpy(), jtab[:, M * D : M * D + M])
    jvecs32 = jtab[:, : M * D].view(np.float32).reshape(N, M, D)
    assert np.abs(vecs32.view(np.int32).astype(np.int64) - jvecs32.view(np.int32)).max() <= 2

    calls = _counted_k1(monkeypatch)
    plain = Granne(layers=tl, elements=el)
    idx = plain.with_neighbor_cache()
    ids, d = idx.search_batch(queries, max_search=24, num_neighbors=5)
    assert calls["k1"] > 0
    jids, jd = JGranne(layers=jl, elements=jel).with_neighbor_cache().search_batch(queries, max_search=24, num_neighbors=5)
    assert _overlap(ids, jids) >= 0.99
    np.testing.assert_allclose(np.sort(d.numpy()), np.sort(np.asarray(jd)), atol=1e-5)
    ids0, _ = plain.search_batch(queries, max_search=24, num_neighbors=5)
    assert _overlap(ids0, ids) > 0.97
    assert np.mean(ids[: NQ // 2, 0].numpy() == np.arange(NQ // 2)) > 0.95

    q, jq = el.prepare_queries(queries), jel.prepare_queries(jnp.asarray(queries))
    kw = dict(ef=24, num_neighbors=5, expand=2)
    before = calls["k1"]
    cids, _ = frontier.search_layers(tl.layers, el, IntQueries(q.vecs, q.inv_norms), nbr_vecs=idx.nbr_vecs, **kw)
    assert calls["k1"] > before
    jcids, _ = jfrontier.search_layers(jl.layers, jel, JIntQueries(jq.vecs, jq.inv_norms),
                                       nbr_vecs=j_make_cache(jl.layers[-1], jel, rows=N), **kw)
    assert _overlap(cids, jcids) >= 0.99


def test_rerank_matches_jax(graph):
    """search_layers(rerank=True) over the int8 flat cache (round-to-nearest
    codes): the final beam re-sorted by the exact distance (dequantized
    rows x the unquantized unit query), drawn from the plain beam, equal to
    a numpy recompute within 1e-5, and JAX's ids (overlap >= 0.99)."""
    tl, jl, vecs, queries = graph
    ef, k = 24, 10
    el, jel = AngularIntVectors.from_raw(vecs, rounding="nearest", device="cpu"), JInt.from_raw(vecs, rounding="nearest")
    q = el.prepare_queries(queries)
    tab = nbr_cache.make_neighbor_cache(tl.layers[-1], el, rows=N)
    kw = dict(ef=ef, expand=1, descent_ef=4)
    beam, _ = frontier.search_layers(tl.layers, el, q, nbr_vecs=tab, num_neighbors=ef, **kw)
    rr_ids, rr_d = frontier.search_layers(tl.layers, el, q, nbr_vecs=tab, num_neighbors=k, rerank=True, **kw)
    beam, rr_ids, rr_d = beam.numpy(), rr_ids.numpy(), rr_d.numpy()
    unit = el.vectors.numpy().astype(np.float32) * el.inv_norms.numpy()[:, None]
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    for i in range(NQ):
        assert set(rr_ids[i]) <= set(beam[i])
        np.testing.assert_allclose(rr_d[i], np.maximum(0.0, 1.0 - unit[rr_ids[i]] @ qn[i]), atol=1e-5)
        assert np.all(np.diff(rr_d[i]) >= -1e-6)
        exact = np.maximum(0.0, 1.0 - unit[beam[i]] @ qn[i])
        np.testing.assert_allclose(np.sort(rr_d[i]), exact[np.argsort(exact, kind="stable")[:k]], atol=1e-5)
    jids, jd = jfrontier.search_layers(jl.layers, jel, jel.prepare_queries(jnp.asarray(queries)),
                                       nbr_vecs=j_make_cache(jl.layers[-1], jel, rows=N), num_neighbors=k,
                                       rerank=True, **kw)
    assert _overlap(rr_ids, jids) >= 0.99
    np.testing.assert_allclose(np.sort(rr_d), np.sort(np.asarray(jd)), atol=1e-5)


def test_f32_table_and_dequantized_serving_match_jax(graph):
    """The f32 flat table of int8 elements scores every beam entry exactly
    (distances = the numpy recompute within 1e-5; ids overlap JAX's >=
    0.99).  Dequantized serving: the bf16 copy's rows are the bf16 cast of
    the exact dequant, and its flat-cache search reranked against the int8
    container (its bf16 queries, then the f32 unit queries) matches a
    numpy recompute and JAX's ids."""
    tl, jl, vecs, queries = graph
    el, jel = AngularIntVectors.from_raw(vecs, rounding="nearest", device="cpu"), JInt.from_raw(vecs, rounding="nearest")
    unit = el.vectors.numpy().astype(np.float32) * el.inv_norms.numpy()[:, None]
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    kw = dict(ef=20, num_neighbors=10, expand=1, descent_ef=4)
    tab = nbr_cache.make_neighbor_cache(tl.layers[-1], el, rows=N, cache_dtype="f32")
    ids, d = frontier.search_layers(tl.layers, el, el.prepare_queries(queries), nbr_vecs=tab, **kw)
    ids, d = ids.numpy(), d.numpy()
    for i in range(NQ):
        np.testing.assert_allclose(d[i], np.maximum(0.0, 1.0 - unit[ids[i]] @ qn[i]), atol=1e-5)
    jtab = j_make_cache(jl.layers[-1], jel, rows=N, cache_dtype="f32")
    jids, _ = jfrontier.search_layers(jl.layers, jel, jel.prepare_queries(jnp.asarray(queries)), nbr_vecs=jtab, **kw)
    assert _overlap(ids, jids) >= 0.99

    dq, jdq = el.dequantized(), jel.dequantized()
    assert isinstance(dq, AngularVectors) and dq.vectors.dtype == torch.bfloat16
    assert np.array_equal(_np(dq.vectors), _np(torch.from_numpy(unit).to(torch.bfloat16)))
    kw = dict(ef=24, num_neighbors=10, expand=1, descent_ef=4, rerank=True)
    dtab, jdtab = nbr_cache.make_neighbor_cache(tl.layers[-1], dq, rows=N), j_make_cache(jl.layers[-1], jdq, rows=N)
    qdq, jqdq = dq.prepare_queries(queries), jdq.prepare_queries(jnp.asarray(queries))
    qbf = qdq.to(torch.float32).numpy()
    unit_q = el.prepare_queries(queries).unit  # the unrounded f32 unit queries
    for rq, jrq, qq in ((None, None, qbf), (unit_q, jnp.asarray(unit_q.numpy()), qn)):
        ids, d = frontier.search_layers(tl.layers, dq, qdq, nbr_vecs=dtab, rerank_with=el, rerank_queries=rq, **kw)
        jids, jd = jfrontier.search_layers(jl.layers, jdq, jqdq, nbr_vecs=jdtab, rerank_with=jel,
                                           rerank_queries=jrq, **kw)
        ids, d = ids.numpy(), d.numpy()
        for i in range(NQ):
            np.testing.assert_allclose(d[i], np.maximum(0.0, 1.0 - unit[ids[i]] @ qq[i]), atol=2e-5)
            assert np.all(np.diff(d[i]) >= -1e-6)
        assert _overlap(ids, jids) >= 0.99
        np.testing.assert_allclose(np.sort(d), np.sort(np.asarray(jd)), atol=1e-5)


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def test_int8_cache_fed_build(monkeypatch):
    """The flat cache-fed build from int8 elements (JAX's
    test_int8_neighbor_cache_build: n=1200, d=24, M=10, ef 30): K1 runs in
    the build beam, self-recall@1 over 256 rows > 0.95, and the graph
    agrees with JAX's cache-fed int8 build (edge Jaccard >= 0.98 per layer)."""
    vecs = np.random.default_rng(13).standard_normal((1200, 24)).astype(np.float32)
    cfg = dict(num_neighbors=M, max_search=30, neighbor_cache=True)
    calls = _counted_k1(monkeypatch)
    el = AngularIntVectors.from_raw(vecs, device="cpu")
    tl = build_layers(el, BuildConfig(**cfg))
    assert calls["k1"] > 0
    ids, _ = Granne(layers=tl, elements=el).search_batch(vecs[:256], max_search=30, num_neighbors=1)
    assert np.mean(ids[:, 0].numpy() == np.arange(256)) > 0.95
    jl = J.build_layers(JInt.from_raw(vecs), J.BuildConfig(**cfg))
    assert tl.counts == jl.counts
    for i, (a, b) in enumerate(zip(tl.as_numpy(), jl.as_numpy())):
        assert _jaccard(a, b) >= 0.98, i


def test_int8_tiled_refused(graph, monkeypatch):
    """int8 elements cannot feed the tiled layout (the JAX package's tiled
    route raises AttributeError on int8 queries): serving, the table, the
    tiled scorer and the build raise ValueError, the build before its first
    wave."""
    tl, jl, vecs, queries = graph
    el = AngularIntVectors.from_raw(vecs, device="cpu")
    with pytest.raises(AttributeError):
        JGranne(layers=jl, elements=JInt.from_raw(vecs)).with_neighbor_cache("tiled").search_batch(queries[:4], 8, 2)
    with pytest.raises(ValueError, match="tiled"):
        Granne(layers=tl, elements=el).with_neighbor_cache("tiled")
    with pytest.raises(ValueError, match="tiled"):
        nbr_cache.make_neighbor_cache(tl.layers[-1], el, layout="tiled")
    tiled = nbr_cache.make_neighbor_cache(tl.layers[-1], el.dequantized(), layout="tiled")
    sel = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="tiled"):
        nbr_cache.score_cached(tiled, sel, el.prepare_queries(queries[:4]), el, M)
    with pytest.raises(ValueError, match="tiled"):
        frontier.search_layers(tl.layers, el, el.prepare_queries(queries[:4]), ef=8, num_neighbors=2, nbr_vecs=tiled)

    def no_wave(*a, **k):
        raise AssertionError("a wave ran")

    monkeypatch.setattr(builder, "search_select_phase", no_wave)
    with pytest.raises(ValueError, match="tiled"):
        build_layers(el, BuildConfig(num_neighbors=M, max_search=30, neighbor_cache=True, neighbor_cache_layout="tiled"))
