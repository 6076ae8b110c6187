"""The cache-fed HNSW build (BuildConfig(neighbor_cache=True), flat and
tiled) against granne_tpu: the heuristic and merge fed from cache vectors,
one wave on the same state, and whole builds.

The JAX reference build is the flat cache-fed one (one per file, module
fixture); the port's tiled build differs from it only in the f32 summation
order of K2's dots, and holding it against JAX's flat build avoids running
the interpreted Pallas K2 inside every JAX wave.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index import builder as jbuilder
from granne_tpu.index import heuristic as jheuristic
from granne_tpu.ops import nbr_cache as jcache
from granne_tpu_torch import AngularVectors, BuildConfig, Granne, build_layers
from granne_tpu_torch.index import builder, heuristic
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


N, D = 1500, 24
CFG = dict(num_neighbors=12, max_search=32)


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def _np(t):
    """A tensor or JAX array as numpy (bf16 as its int16 bit patterns)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _jax(t):
    """A tensor as a JAX array of the same type and bits."""
    a = jnp.asarray(_np(t))
    return a.view(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.fixture(scope="module")
def data():
    """The same unit vectors in both packages (normalized once, by JAX)."""
    vecs = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    jel = J.AngularVectors.from_raw(vecs)
    return vecs, jel, AngularVectors.from_normalized(np.asarray(jel.vectors), device="cpu")


@pytest.fixture(scope="module")
def jax_cached_layers(data):
    _, jel, _ = data
    return J.build_layers(jel, J.BuildConfig(neighbor_cache=True, **CFG))


def _self_recall(layers, elements, vecs):
    ids, _ = Granne(layers=layers, elements=elements).search_batch(vecs, max_search=20, num_neighbors=1)
    return float(np.mean(ids[:, 0].numpy() == np.arange(len(vecs))))


def _candidates(rng, tel, n_rows, C):
    """Distance-sorted candidate rows of distinct ids (a few invalid)."""
    nodes = rng.choice(N, n_rows, replace=False).astype(np.int32)
    ids = np.stack([rng.choice(N, C, replace=False) for _ in range(n_rows)]).astype(np.int32)
    ids[:, -3:] = -1
    q = tel.vectors[torch.from_numpy(nodes).long()]
    d = tel.dist_ids_to_queries(torch.from_numpy(ids), q).numpy()
    d[ids < 0] = np.inf
    order = np.argsort(d, axis=1, kind="stable")
    return nodes, np.take_along_axis(ids, order, 1), np.take_along_axis(d, order, 1).astype(np.float32)


def test_select_neighbors_with_vecs_matches_jax(data, rng):
    """The heuristic fed pre-gathered bf16 vectors: kept ids equal JAX's,
    the returned vectors equal on every kept slot."""
    _, jel, tel = data
    _, ids, d = _candidates(rng, tel, 40, 30)
    vecs = tel.cache_rows(torch.from_numpy(ids).clamp_min(0))
    jvecs = _jax(vecs)
    valid = ids >= 0
    jids, jd, jv = jheuristic.select_neighbors(
        jel, jnp.asarray(ids), jnp.asarray(d), jnp.asarray(valid), 12, cand_vecs=jvecs, return_vecs=True
    )
    tids, td, tv = heuristic.select_neighbors(
        tel, torch.from_numpy(ids), torch.from_numpy(d), torch.from_numpy(valid), 12, cand_vecs=vecs, return_vecs=True
    )
    assert np.array_equal(tids.numpy(), np.asarray(jids)) and np.array_equal(td.numpy(), np.asarray(jd))
    kept = tids.numpy() >= 0
    assert kept.sum() > 0 and np.array_equal(_np(tv)[kept], _np(jv)[kept])
    assert (tids.numpy() >= 0).sum(1).max() <= 12


def test_cache_fed_merge_matches_jax(data, rng):
    """_merge_rows fed from cache vectors (existing rows) and element rows
    (incoming), and _merge_rows_chunked picking the incoming vectors from a
    wave block by position: rows equal JAX's, kept vectors equal on valid
    slots."""
    _, jel, tel = data
    nodes, exist, _ = _candidates(rng, tel, 48, 12)
    _, inc, inc_d = _candidates(rng, tel, 48, 8)
    valid = np.ones(48, bool)
    valid[5] = False
    ev = tel.cache_rows(torch.from_numpy(exist).clamp_min(0))
    iv = tel.cache_rows(torch.from_numpy(inc).clamp_min(0))
    args = (nodes, exist, inc, inc_d, valid)
    jrows, jvecs = jbuilder._merge_rows(jel, *map(jnp.asarray, args), 12, _jax(ev), _jax(iv), return_vecs=True)
    trows, tvecs = builder._merge_rows(tel, *map(torch.from_numpy, args), 12, ev, iv, return_vecs=True)
    assert np.array_equal(trows.numpy(), np.asarray(jrows))
    ok = trows.numpy() >= 0
    assert np.array_equal(_np(tvecs)[ok], _np(jvecs)[ok])

    # incoming vectors from a [W, d] wave block by position (JAX: one-hot matmul)
    wave = rng.choice(N, 64, replace=False).astype(np.int32)
    pos = rng.integers(0, 64, inc.shape).astype(np.int32)
    inc_w = np.where(inc >= 0, wave[pos], -1).astype(np.int32)
    adj = np.full((N, 12), -1, np.int32)
    adj[nodes] = exist
    jtab = jcache.make_neighbor_cache(jnp.asarray(adj), jel, rows=N, layout="tiled")
    ttab = nbr_cache.make_neighbor_cache(torch.from_numpy(adj), tel, rows=N, layout="tiled")
    jrows, jvecs = jbuilder._merge_rows_chunked(
        jel, jnp.asarray(nodes), jnp.asarray(exist), jnp.asarray(inc_w), jnp.asarray(inc_d), jnp.asarray(valid),
        12, 16, nbr_tab=jtab, inc_pos=jnp.asarray(pos), wave_rows=jel.cache_rows(jnp.asarray(wave)), return_vecs=True,
    )
    trows, tvecs = builder._merge_rows_chunked(
        tel, torch.from_numpy(nodes), torch.from_numpy(exist), torch.from_numpy(inc_w), torch.from_numpy(inc_d),
        torch.from_numpy(valid), 12, 16, nbr_tab=ttab, inc_pos=torch.from_numpy(pos),
        wave_rows=tel.cache_rows(torch.from_numpy(wave)), return_vecs=True,
    )
    assert np.array_equal(trows.numpy(), np.asarray(jrows))
    ok = trows.numpy() >= 0
    assert np.array_equal(_np(tvecs)[ok], _np(jvecs)[ok])


def test_one_wave_matches_jax(data):
    """One wave (insert and reinsert) applied to the same graph, selection
    and cache by both packages, with a flat and a tiled table: the
    adjacency equals JAX's, and the cache rows equal JAX's on every valid
    id slot (JAX leaves pad slots arbitrary); flat rows embed the adjacency."""
    vecs, jel, tel = data
    n, M = 600, 12
    el, jel_n = AngularVectors(tel.vectors[:n]), J.AngularVectors(jel.vectors[:n])
    layers = build_layers(el, BuildConfig(num_neighbors=M, max_search=24, reinsert_elements=False))
    adj0 = layers.layers[-1]
    wave = torch.arange(n - 64, n, dtype=torch.int32)
    valid = torch.ones(64, dtype=torch.bool)
    for layout in ("flat", "tiled"):
        tab0 = nbr_cache.make_neighbor_cache(adj0, el, layout=layout)
        sel = builder.search_select_phase(layers.layers[:-1], adj0, el, wave, valid, m_eff=M, max_search=24,
                                          expand=2, nbr_vecs=tab0)
        for reinsert in (False, True):
            kw = dict(m_eff=M, reinsert=reinsert, reverse_cap=8, merge_chunk=32)
            jadj, jtab = jbuilder.apply_wave_edges(
                _jax(adj0), jel_n, _jax(wave), _jax(valid), *map(_jax, sel), nbr_tab=_jax(tab0), **kw
            )
            tadj, ttab = builder.apply_wave_edges(adj0.clone(), el, wave, valid, *sel, nbr_tab=tab0.clone(), **kw)
            what = (layout, reinsert)
            assert np.array_equal(tadj.numpy(), np.asarray(jadj)), what
            assert not torch.equal(tadj, adj0), what
            ok = tadj.numpy() >= 0
            if layout == "tiled":
                tv, jv = _np(ttab)[:, :M, :D], _np(jtab)[:n, :M, :D]
            else:
                tv = _np(nbr_cache.row_vecs(ttab, M, D)).reshape(n, M, D)
                jv = _np(jcache.row_vecs(jtab, M, D)).reshape(-1, M, D)[:n]
                assert np.array_equal(nbr_cache.unpack_ids(ttab, M, D).numpy(), tadj.numpy()), what
            assert np.array_equal(tv[ok], jv[ok]), what


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_cache_fed_build_matches_jax(data, jax_cached_layers, layout, monkeypatch):
    """Whole cache-fed builds: per-layer edge Jaccard >= 0.99 against JAX's
    flat cache-fed build, self-recall no more than 0.02 below the port's
    uncached build, and the build beam went through the layout's kernel
    wrapper (K1 for flat, K2 for tiled)."""
    vecs, _, tel = data
    calls = {"k1": 0, "k2": 0}

    def k1(*a, **k):
        calls["k1"] += 1
        return nbr_score.gather_score_flat(*a, **k)

    def k2(*a, **k):
        calls["k2"] += 1
        return nbr_score.gather_score_reference(*a, **k)

    monkeypatch.setattr(frontier, "gather_score_flat", k1)
    monkeypatch.setattr(nbr_score, "gather_score", k2)
    tl = build_layers(tel, BuildConfig(neighbor_cache=True, neighbor_cache_layout=layout, **CFG))
    assert calls["k1" if layout == "flat" else "k2"] > 0 and calls["k2" if layout == "flat" else "k1"] == 0
    assert tl.counts == jax_cached_layers.counts
    for i, (a, b) in enumerate(zip(tl.as_numpy(), jax_cached_layers.as_numpy())):
        assert _jaccard(a, b) >= 0.99, (layout, i)
    monkeypatch.undo()
    base = build_layers(tel, BuildConfig(**CFG))
    assert _self_recall(tl, tel, vecs) >= _self_recall(base, tel, vecs) - 0.02


def test_gather_budget_build(data):
    """BuildConfig(gather_budget): a budget >= expand*M builds the unbudgeted
    graph exactly; a tight one (M) keeps self-recall within 0.02 of it."""
    vecs, _, tel = data
    el = AngularVectors(tel.vectors[:800])
    cfg = dict(num_neighbors=12, max_search=32, expand=2)
    base = build_layers(el, BuildConfig(**cfg))
    full = build_layers(el, BuildConfig(gather_budget=24, **cfg))
    assert all(torch.equal(a, b) for a, b in zip(base.layers, full.layers))
    tight = build_layers(el, BuildConfig(gather_budget=12, **cfg))
    assert tight.counts == base.counts
    assert _self_recall(tight, el, vecs[:800]) >= _self_recall(base, el, vecs[:800]) - 0.02
