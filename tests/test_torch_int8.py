"""int8 elements in granne_tpu_torch against granne_tpu: the int8 distance
functions, the ``AngularIntVectors`` surface, the ``"angular_int"`` element
file (bytes equal both ways), the builder and ``compute_distance``, and the
uncached int8 build.

Both packages get the same numpy inputs from a seed.  int8 codes, norms,
dequantized bf16 rows and files must be bit-equal; distances agree within
2e-7 (the dots are the same exact integers, the elementwise order is
JAX's); graphs agree by edge Jaccard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.elements.angular_int import AngularIntVectors as JInt
from granne_tpu.elements.angular_int import IntQueries as JIntQueries
from granne_tpu.index import io as jio
from granne_tpu.ops import distance as JD
from granne_tpu_torch import (
    AngularIntVectors,
    AngularVectors,
    BuildConfig,
    Granne,
    GranneBuilder,
    build_layers,
    compute_distance,
    load_granne,
)
from granne_tpu_torch.convert import granne_from_numpy, int8_elements_from_numpy
from granne_tpu_torch.elements.angular_int import IntQueries
from granne_tpu_torch.index import io
from granne_tpu_torch.ops import distance as D


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


DIST_ATOL = 2e-7


def _np(t):
    """A tensor or JAX array as numpy (bf16 as its int16 bit patterns)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _codes(rng, shape, zero_rows=()):
    """Max-abs int8 codes of Gaussian rows, some rows zero."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., list(zero_rows), :] = 0.0
    return np.array(JD.quantize_i8(jnp.asarray(x)))


def test_i8_distances_match_jax(rng):
    """i8_dist_gathered, i8_pairwise_gathered and i8_dist_matrix: within
    2e-7 of JAX's at d = 24, 121 and 128, zero rows at distance 1.0; and the
    dots above the exact-f32 width (chunked) equal numpy's int64 dots, the
    reciprocal norms numpy's IEEE f32 ones."""
    for d in (24, 121, 128):
        vecs = _codes(rng, (6, 9, d), zero_rows=(2,))
        q = _codes(rng, (6, d))
        q[4] = 0
        vn, qn = np.array(JD.inv_norms_i8(jnp.asarray(vecs))), np.array(JD.inv_norms_i8(jnp.asarray(q)))
        assert np.array_equal(D.inv_norms_i8(torch.from_numpy(vecs)).numpy(), vn)
        t = [torch.from_numpy(a) for a in (vecs, vn, q, qn)]
        got = D.i8_dist_gathered(*t).numpy()
        want = np.asarray(JD.i8_dist_gathered(*map(jnp.asarray, (vecs, vn, q, qn))))
        np.testing.assert_allclose(got, want, rtol=0, atol=DIST_ATOL)
        assert np.all(got[:, 2] == 1.0) and np.all(got[4] == 1.0)

        got = D.i8_pairwise_gathered(t[0], t[1]).numpy()
        want = np.asarray(JD.i8_pairwise_gathered(jnp.asarray(vecs), jnp.asarray(vn)))
        np.testing.assert_allclose(got, want, rtol=0, atol=DIST_ATOL)
        assert np.all(got[:, 2, :] == 1.0) and np.all(got[:, :, 2] == 1.0)

        a, b = vecs[0], vecs[1]
        got = D.i8_dist_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(JD.i8_dist_matrix(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=0, atol=DIST_ATOL)
        assert np.all(got[2] == 1.0) and np.all(got[:, 2] == 1.0)

    # past D.I8_EXACT_LANES the contraction is chunked; |dots| reach 2^24 and beyond
    for d in (D.I8_EXACT_LANES, D.I8_EXACT_LANES + 1, 2 * D.I8_EXACT_LANES + 7):
        a = rng.choice(np.array([-127, 127, 126], np.int8), (3, 5, d))
        b = rng.choice(np.array([-127, 127, 125], np.int8), (3, 4, d))
        want = np.einsum("bmd,bnd->bmn", a.astype(np.int64), b.astype(np.int64)).astype(np.float32)
        assert np.array_equal(D.i8_dots(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want), d
        # reciprocal norms: IEEE f32 square root then IEEE f32 reciprocal of the f32-rounded sum
        sq = np.sum(a.astype(np.int64) ** 2, axis=-1).astype(np.float32)
        assert np.array_equal(D.inv_norms_i8(torch.from_numpy(a)).numpy(), np.float32(1.0) / np.sqrt(sq)), d


def test_container_matches_jax(rng):
    """The AngularIntVectors surface against JAX's on the same raw rows and
    queries: codes (trunc, nearest, from_quantized), norms, dequantized
    bf16 bits, get, queries, both cache-row forms, score_block /
    query_lanes / dist_from_dots_q with and without ``unit``, rerank_dists
    in its three query forms, self_dist, permute, extend (keeps rounding)
    and dist."""
    n, d, B, K = 60, 24, 7, 11
    raw = rng.standard_normal((n, d)).astype(np.float32)
    raw[5] = 0.0
    more = rng.standard_normal((9, d)).astype(np.float32)
    qraw = rng.standard_normal((B, d)).astype(np.float32)
    ids = rng.integers(-1, n, (B, K)).astype(np.int32)
    tids = torch.from_numpy(ids)
    for rounding in ("trunc", "nearest"):
        jel = JInt.from_raw(raw, rounding=rounding)
        el = AngularIntVectors.from_raw(raw, rounding=rounding, device="cpu")
        assert el.rounding == rounding and el.vectors.dtype == torch.int8
        assert np.array_equal(el.vectors.numpy(), np.asarray(jel.vectors))
        assert np.array_equal(el.inv_norms.numpy(), np.asarray(jel.inv_norms))
        fq = AngularIntVectors.from_quantized(np.asarray(jel.vectors), device="cpu")
        assert fq.rounding == "trunc" and torch.equal(fq.inv_norms, el.inv_norms)
        assert np.array_equal(_np(el.dequantized().vectors), _np(jel.dequantized().vectors))
        assert np.array_equal(el.get(tids).numpy(), np.asarray(jel.get(jnp.asarray(ids))))
        for mine, theirs in ((el.cache_rows, jel.cache_rows), (el.cache_rows_exact, jel.cache_rows_exact)):
            assert np.array_equal(_np(mine(tids)), _np(theirs(jnp.asarray(ids))))

        q, jq = el.prepare_queries(qraw), jel.prepare_queries(jnp.asarray(qraw))
        assert isinstance(q, IntQueries) and q.shape == (B, d) and q.device == torch.device("cpu")
        assert np.array_equal(q.vecs.numpy(), np.asarray(jq.vecs))
        assert np.array_equal(q.inv_norms.numpy(), np.asarray(jq.inv_norms))
        np.testing.assert_allclose(q.unit.numpy(), np.asarray(jq.unit), rtol=0, atol=1e-7)
        np.testing.assert_allclose(el.dist_ids_to_queries(tids, q).numpy(),
                                   np.asarray(jel.dist_ids_to_queries(jnp.asarray(ids), jq)), rtol=0, atol=DIST_ATOL)
        np.testing.assert_allclose(el.pairwise_from_ids(tids).numpy(),
                                   np.asarray(jel.pairwise_from_ids(jnp.asarray(ids))), rtol=0, atol=DIST_ATOL)
        sq, jsq = el.queries_from_ids(tids[:, 0]), jel.queries_from_ids(jnp.asarray(ids[:, 0]))
        assert np.array_equal(sq.vecs.numpy(), np.asarray(jsq.vecs))
        np.testing.assert_allclose(sq.unit.numpy(), np.asarray(jsq.unit), rtol=0, atol=1e-7)

        block = el.cache_rows(tids)
        jblock = jel.cache_rows(jnp.asarray(ids))
        bare, jbare = IntQueries(q.vecs, q.inv_norms), JIntQueries(jq.vecs, jq.inv_norms)
        for qq, jqq in ((q, jq), (bare, jbare)):
            np.testing.assert_allclose(el.score_block(block, qq).numpy(),
                                       np.asarray(jel.score_block(jblock, jqq)), rtol=0, atol=1e-6)
            lanes = el.query_lanes(qq)
            assert lanes.dtype == torch.bfloat16 and np.array_equal(_np(lanes), _np(jel.query_lanes(jqq)))
            dots = torch.bmm(block.float(), lanes.float()[:, :, None])[..., 0]
            np.testing.assert_allclose(el.dist_from_dots_q(dots, qq).numpy(),
                                       np.asarray(jel.dist_from_dots_q(jnp.asarray(dots.numpy()), jqq)), rtol=0, atol=1e-6)
        assert float(el.query_lanes(bare).abs().max()) == 127.0  # the code lanes

        unit = D.normalize(torch.from_numpy(qraw))
        forms = ((q, jq), (unit, jnp.asarray(unit.numpy())), (bare, jbare), ((q.vecs, q.inv_norms), (jq.vecs, jq.inv_norms)))
        for qq, jqq in forms:
            np.testing.assert_allclose(el.rerank_dists(tids, qq).numpy(),
                                       np.asarray(jel.rerank_dists(jnp.asarray(ids), jqq)), rtol=0, atol=1e-6)
        assert np.array_equal(el.self_dist(tids).numpy(), np.asarray(jel.self_dist(jnp.asarray(ids))))
        assert float(el.self_dist(torch.tensor([5]))[0]) == 1.0

        order = rng.permutation(n)
        p, jp = el.permute(order), jel.permute(order)
        assert np.array_equal(p.vectors.numpy(), np.asarray(jp.vectors)) and p.rounding == rounding
        assert np.array_equal(p.inv_norms.numpy(), np.asarray(jp.inv_norms))
        x, jx = el.extend(more), jel.extend(more)
        assert x.rounding == rounding and len(x) == n + 9 and len(el) == n
        assert np.array_equal(x.vectors.numpy(), np.asarray(jx.vectors))
        assert np.array_equal(x.inv_norms.numpy(), np.asarray(jx.inv_norms))
        for i, j in ((0, 1), (3, 3), (5, 7), (40, 59)):
            assert abs(el.dist(i, j) - jel.dist(i, j)) <= DIST_ATOL
    # the two quantizers differ on this data (the rounding checks have teeth)
    assert not torch.equal(AngularIntVectors.from_raw(raw, device="cpu").vectors,
                           AngularIntVectors.from_raw(raw, rounding="nearest", device="cpu").vectors)
    conv = int8_elements_from_numpy(np.asarray(jel.vectors), rounding="nearest", device="cpu")
    assert conv.rounding == "nearest" and torch.equal(conv.vectors, el.vectors)


def test_element_files_byte_equal_both_ways(rng, tmp_path):
    """An "angular_int" element file written by either package loads in the
    other, and the bytes are equal; the codec-compressed index with it."""
    raw = rng.standard_normal((300, 24)).astype(np.float32)
    jel = JInt.from_raw(raw)
    el = AngularIntVectors.from_raw(raw, device="cpu")
    jpath, tpath = str(tmp_path / "j.gt"), str(tmp_path / "t.gt")
    jio.save_elements(jel, jpath)
    io.save_elements(el, tpath)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert io.read_elements_metadata(tpath)["type"] == "angular_int"
    loaded = io.load_elements(jpath, device="cpu")
    assert isinstance(loaded, AngularIntVectors)
    assert torch.equal(loaded.vectors, el.vectors) and torch.equal(loaded.inv_norms, el.inv_norms)
    back = jio.load_elements(tpath)
    assert isinstance(back, JInt) and np.array_equal(np.asarray(back.vectors), np.asarray(jel.vectors))
    loaded_buf = io.load_elements(open(tpath, "rb").read(), device="cpu")
    assert torch.equal(loaded_buf.vectors, el.vectors)
    # an element file does not record rounding, in either package
    nearest = AngularIntVectors.from_raw(raw, rounding="nearest", device="cpu")
    io.save_elements(nearest, tpath)
    assert io.load_elements(tpath, device="cpu").rounding == "trunc" == jio.load_elements(tpath).rounding


def test_builder_and_compute_distance(rng, tmp_path):
    """GranneBuilder("angular_int"): append -> build -> save -> load_granne
    -> search gives the builder's own answers; get_element returns the
    codes (as JAX's does); compute_distance("angular_int") equals JAX's."""
    vecs = rng.standard_normal((400, 16)).astype(np.float32)
    b = GranneBuilder("angular_int", num_neighbors=8, max_search=24, device="cpu")
    b.append(vecs[0])
    b.append(vecs[1:])
    b.build()
    assert isinstance(b.elements, AngularIntVectors) and b.indexed_elements == 400
    ipath, epath = str(tmp_path / "i.gtz"), str(tmp_path / "e.gt")
    b.save_index(ipath)
    b.save_elements(epath)
    idx = load_granne(ipath, epath, device="cpu")
    assert isinstance(idx.elements, AngularIntVectors) and torch.equal(idx.elements.vectors, b.elements.vectors)
    el = b.get_element(17)
    assert el.dtype == np.int8 and np.array_equal(el, np.asarray(JInt.from_raw(vecs).vectors[17]))
    hits = 0
    for i in range(0, 400, 9):
        res = idx.search(vecs[i], 24, 5)
        assert res == b.search(vecs[i], 24, 5)
        hits += res[0][0] == i
    assert hits >= 0.95 * len(range(0, 400, 9))
    resumed = GranneBuilder.from_index(ipath, epath, device="cpu", num_neighbors=8, max_search=24)
    assert isinstance(resumed.elements, AngularIntVectors) and resumed.indexed_elements == 400
    for a, c in ((vecs[0], vecs[1]), (vecs[2], vecs[2]), (vecs[3], np.zeros(16, np.float32))):
        assert abs(compute_distance("angular_int", a, c, device="cpu") - J.compute_distance("angular_int", a, c)) <= DIST_ATOL


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def _self_recall(layers, elements, queries, ef):
    ids, _ = Granne(layers=layers, elements=elements).search_batch(queries, ef, 1)
    return float(np.mean(ids[:, 0].numpy() == np.arange(len(queries))))


def test_int8_build_matches_jax(rng):
    """The uncached int8 build against JAX's int8 graph on the same data:
    edge Jaccard >= 0.98 on every layer; then the recall bars of JAX's
    test_builder.py: self-recall@1 > 0.95 (n=500, d=25, M=20), and int8
    recall within 0.03 of the f32 build's on noisy queries (n=800, d=32)."""
    vecs = rng.standard_normal((1200, 24)).astype(np.float32)
    cfg = dict(num_neighbors=12, max_search=32)
    jl = J.build_layers(JInt.from_raw(vecs), J.BuildConfig(**cfg))
    el = AngularIntVectors.from_raw(vecs, device="cpu")
    tl = build_layers(el, BuildConfig(**cfg))
    assert tl.counts == jl.counts
    for i, (a, b) in enumerate(zip(tl.as_numpy(), jl.as_numpy())):
        assert _jaccard(a, b) >= 0.98, i
    # the port serves JAX's int8 graph as JAX does
    g = granne_from_numpy(jl.as_numpy(), np.asarray(JInt.from_raw(vecs).vectors), device="cpu")
    ids, _ = g.search_batch(vecs[:200], 24, 5)
    jids, _ = J.Granne(layers=jl, elements=JInt.from_raw(vecs)).search_batch(vecs[:200], 24, 5)
    assert np.mean([len(set(x) & set(y)) / 5 for x, y in zip(ids.numpy(), np.asarray(jids))]) >= 0.99

    v = rng.standard_normal((500, 25)).astype(np.float32)
    e8 = AngularIntVectors.from_raw(v, device="cpu")
    assert _self_recall(build_layers(e8, BuildConfig(num_neighbors=20, max_search=30)), e8, v, 20) > 0.95

    v = rng.standard_normal((800, 32)).astype(np.float32)
    noisy = v + 0.05 * rng.standard_normal((800, 32)).astype(np.float32)
    c = BuildConfig(num_neighbors=16, max_search=30)
    e8 = AngularIntVectors.from_raw(v, device="cpu")
    t32 = AngularVectors.from_raw(v, device="cpu")
    r32 = _self_recall(build_layers(t32, c), t32, noisy, 30)
    r8 = _self_recall(build_layers(e8, c), e8, noisy, 30)
    assert r32 > 0.95 and r8 > r32 - 0.03, (r8, r32)
