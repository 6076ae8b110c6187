"""The bag-of-embeddings surface of granne_tpu_torch against granne_tpu:
packed 3-byte ids and CSR terms, the ``"embeddings"`` element file (bytes
equal both ways, chunked and ``raw64`` offset tables), the ETL
(``parse_elements_and_save_to_disk``, ``compute_embeddings_and_save_to_disk``
and its ``i1`` file), ``Embeddings``, ``WordEmbeddingsGranne``,
``Granne.get_element``/``get_internal_element``, ``HostGranne``'s refusal
of an embeddings file, and ``GranneBuilder`` over ``SumEmbeddings``
(resuming a JAX-saved ``"embeddings"`` pair; ``append`` takes term-id
lists and refuses raw vectors).

Three faults of the JAX package are shown not copied: a text query embeds
all its words (JAX embeds the first only), ``extend`` keeps every term of
a longer list (JAX truncates it), and a ``cache_dtype="f32"`` table holds
the exact f32 sums (JAX rounds them to bf16).  ``Embeddings.save`` over
the file it maps is safe (JAX truncates the file before reading it).
"""

import filecmp
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu import api as japi
from granne_tpu.elements import embeddings_etl as jetl
from granne_tpu.elements import packed as jpacked
from granne_tpu.elements.embeddings import SumEmbeddings as JSum
from granne_tpu.index import io as jio
from granne_tpu.ops.nbr_cache import make_neighbor_cache as j_make_cache
from granne_tpu_torch import (
    AngularIntVectors,
    AngularVectors,
    BuildConfig,
    Embeddings,
    Granne,
    GranneBuilder,
    HostGranne,
    SumEmbeddings,
    WordDict,
    WordEmbeddingsGranne,
    build_layers,
    compute_embeddings_and_save_to_disk,
    load_granne,
    parse_elements_and_save_to_disk,
)
from granne_tpu_torch.elements import embeddings_etl as etl
from granne_tpu_torch.elements import packed
from granne_tpu_torch.index import io
from granne_tpu_torch.ops.nbr_cache import make_neighbor_cache, row_vecs


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


V, D, N = 120, 16, 300


def _parts(rng, v=V, d=D, n=N, max_terms=6):
    emb = rng.standard_normal((v, d)).astype(np.float32)
    lists = [list(rng.choice(v, size=rng.integers(1, max_terms), replace=False)) for _ in range(n)]
    return emb, lists


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x)


def test_packed_and_csr_match_jax(rng):
    """pack_u24/unpack_u24 and terms_to_csr/csr_to_terms give JAX's bytes
    and arrays; the u24 range is checked."""
    ids = rng.integers(0, 1 << 24, 1000).astype(np.uint32)
    ids[:3] = [0, (1 << 24) - 1, 65536]
    blob = packed.pack_u24(ids)
    assert blob == jpacked.pack_u24(ids) and len(blob) == 3000
    assert np.array_equal(packed.unpack_u24(blob, 1000), jpacked.unpack_u24(blob, 1000))
    assert np.array_equal(packed.unpack_u24(blob, 1000), ids)
    with pytest.raises(ValueError, match="3-byte"):
        packed.pack_u24(np.array([1 << 24]))
    lists = [list(rng.integers(0, 50, rng.integers(0, 7))) for _ in range(40)]
    terms = np.asarray(JSum.from_parts(np.zeros((50, 2), np.float32), lists).terms)
    for a, b in zip(packed.terms_to_csr(terms), jpacked.terms_to_csr(terms)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    offsets, data = packed.terms_to_csr(terms)
    for width in (None, terms.shape[1], 2):
        assert np.array_equal(packed.csr_to_terms(offsets, data, width), jpacked.csr_to_terms(offsets, data, width))


def test_element_files_byte_equal_both_ways(rng, tmp_path):
    """The "embeddings" element file: the port's bytes equal JAX's for the
    same container (chunked offsets; raw64 when a row holds more than
    65,535 terms), each package loads the other's file to the same terms
    and table, buffers load like paths, and a widened container round-trips."""
    emb, lists = _parts(rng)
    lists[3] = []
    long = [list(rng.integers(0, V, 70_000)), [1, 2], []]
    for case, (e, ls) in {"chunked": (emb, lists), "raw64": (emb, long)}.items():
        j, t = JSum.from_parts(e, ls), SumEmbeddings.from_parts(e, ls, device="cpu")
        jp, tp = str(tmp_path / f"j_{case}.gt"), str(tmp_path / f"t_{case}.gt")
        jio.save_elements(j, jp)
        io.save_elements(t, tp)
        assert filecmp.cmp(jp, tp, shallow=False), case
        meta = io.read_elements_metadata(tp)
        assert meta["offsets_format"] == case and meta["type"] == "embeddings"
        with open(jp, "rb") as f:
            assert f.read(1024) == open(tp, "rb").read(1024)
        for loaded in (io.load_elements(jp, device="cpu"), io.load_elements(open(jp, "rb").read(), device="cpu")):
            assert isinstance(loaded, SumEmbeddings)
            assert torch.equal(loaded.terms, t.terms) and torch.equal(loaded.embeddings, t.embeddings)
        back = jio.load_elements(tp)
        assert np.array_equal(np.asarray(back.terms), t.terms.numpy())
        assert np.array_equal(np.asarray(back.embeddings), emb)
    wide = SumEmbeddings.from_parts(emb, lists, device="cpu").extend([list(range(9))])
    io.save_elements(wide, str(tmp_path / "wide.gt"))
    assert io.read_elements_metadata(str(tmp_path / "wide.gt"))["term_width"] == 9
    assert torch.equal(io.load_elements(str(tmp_path / "wide.gt"), device="cpu").terms, wide.terms)


def test_etl_matches_jax(rng, tmp_path):
    """parse_elements_and_save_to_disk gives JAX's .npz arrays (one file and
    shards; WordDict lines in all three forms, gzipped files, unknown words
    dropped); compute_embeddings_and_save_to_disk gives an i1 file equal to
    JAX's byte for byte, and codes equal to precompute_quantized_vectors'."""
    words = [f"w{i}" for i in range(V)]
    wpath = tmp_path / "words.jsonl"
    wpath.write_text("\n".join(json.dumps({"word": w}) if i % 3 == 0 else (json.dumps(w) if i % 3 == 1 else w)
                               for i, w in enumerate(words)) + "\n")
    wd = WordDict.from_file(str(wpath))
    assert wd.words == jetl.WordDict.from_file(str(wpath)).words == words
    assert wd.to_ids("w3 nope w7") == [3, 7] and wd.get_id("w5") == 5 and wd.get_word(6) == "w6"
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for k in range(3):
        text = "\n".join(" ".join(f"w{x}" for x in rng.integers(0, V + 20, rng.integers(0, 8))) for _ in range(60))
        if k == 1:
            with gzip.open(corpus / f"part{k}.txt.gz", "wt") as f:
                f.write(text)
        else:
            (corpus / f"part{k}.txt").write_text(text)
    assert etl.parse_corpus_dir(str(corpus), wd) == jetl.parse_corpus_dir(str(corpus), jetl.WordDict(words))
    parse_elements_and_save_to_disk(str(corpus), str(wpath), str(tmp_path / "t_el"))
    japi.parse_elements_and_save_to_disk(str(corpus), str(wpath), str(tmp_path / "j_el"))
    t_terms, j_terms = np.load(tmp_path / "t_el.npz")["terms"], np.load(tmp_path / "j_el.npz")["terms"]
    assert t_terms.dtype == j_terms.dtype and np.array_equal(t_terms, j_terms)
    parse_elements_and_save_to_disk(str(corpus), str(wpath), str(tmp_path / "t_sh"), num_shards=3)
    japi.parse_elements_and_save_to_disk(str(corpus), str(wpath), str(tmp_path / "j_sh"), num_shards=3)
    for s in range(3):
        name = etl.get_shard_name(s, 3) + ".npz"
        assert name == jetl.get_shard_name(s, 3) + ".npz"
        a, b = np.load(tmp_path / "t_sh" / name), np.load(tmp_path / "j_sh" / name)
        assert all(np.array_equal(a[key], b[key]) for key in ("terms", "lo", "hi"))

    emb = rng.standard_normal((V, D)).astype(np.float32)
    compute_embeddings_and_save_to_disk(str(tmp_path / "t_el.npz"), emb, str(tmp_path / "t.i1"), device="cpu")
    japi.compute_embeddings_and_save_to_disk(str(tmp_path / "t_el.npz"), emb, str(tmp_path / "j.i1"))
    assert filecmp.cmp(tmp_path / "t.i1", tmp_path / "j.i1", shallow=False)
    q = etl.precompute_quantized_vectors(SumEmbeddings.from_parts(emb, t_terms, device="cpu"), chunk=50)
    assert isinstance(q, AngularIntVectors)
    assert torch.equal(io.load_elements(str(tmp_path / "t.i1"), device="cpu").vectors, q.vectors)


def test_embeddings_collection(rng, tmp_path):
    """Embeddings: append (duplicates refused), sums by id, id list and text,
    distances, save and load (the words file in the reference's format),
    growth after a load; every value equal to JAX's collection's.  Saving
    over the matrix file a loaded collection maps keeps the old rows."""
    vecs = rng.standard_normal((5, 12)).astype(np.float32)
    e, je = Embeddings(), japi.Embeddings()
    for i, w in enumerate(["alpha", "beta", "gamma", "delta", "eps"]):
        assert e.append(vecs[i], w) is True and je.append(vecs[i], w) is True
    assert e.append(vecs[0], "alpha") is False and len(e) == 5
    with pytest.raises(ValueError, match="dimension mismatch"):
        e.append(np.zeros(3, np.float32), "zeta")
    for query in (2, [0, 3], "alpha delta", "unknown words", []):
        assert np.array_equal(e.get_embedding(query), je.get_embedding(query))
    assert e.dist("alpha beta", "gamma") == je.dist("alpha beta", "gamma")
    assert e.dists("alpha", ["beta", [2], 3, "nothing"]) == je.dists("alpha", ["beta", [2], 3, "nothing"])
    ep, wp = str(tmp_path / "emb.npy"), str(tmp_path / "words.jsonl")
    e.save(ep, wp)
    with open(wp, encoding="utf-8") as f:
        assert f.readline().strip() == '"alpha"'
    e2 = Embeddings(ep, wp)
    assert len(e2) == 5 and np.array_equal(e2.get_embedding("beta gamma"), vecs[1] + vecs[2])
    assert e2.append(rng.standard_normal(12).astype(np.float32), "zeta")
    e2.save(ep, wp)  # over the file e2 maps
    e3 = Embeddings(ep, wp)
    assert len(e3) == 6 and np.array_equal(np.load(ep)[:5], vecs)
    assert np.array_equal(e3.get_embedding("zeta"), e2.get_embedding("zeta"))
    with pytest.raises(ValueError, match="together"):
        Embeddings(embeddings_path=ep)
    empty = str(tmp_path / "empty")
    Embeddings().save_embeddings(empty)
    assert np.load(empty + ".npy").shape == (0, 0)


def test_word_embeddings_granne_and_elements(rng, tmp_path):
    """WordEmbeddingsGranne over a SumEmbeddings index: vector queries and
    element lookups equal JAX's on one graph; a text query is the
    normalized sum of ALL its known words (JAX's sums only the first);
    get_internal_element gives words.  Granne.get_element goes through
    elements.get (dense kinds unchanged); get_internal_element gives term
    ids.  HostGranne refuses an embeddings file with TypeError, as JAX's.
    (The graph is the port's build, saved by the port and loaded by both.)"""
    emb, lists = _parts(rng)
    j = JSum.from_parts(emb, lists)
    t = SumEmbeddings.from_parts(emb, lists, device="cpu")
    ipath, epath = str(tmp_path / "i.gtz"), str(tmp_path / "e.gt")
    io.save_index(build_layers(t, BuildConfig(num_neighbors=8, max_search=20)), ipath, compressed=True)
    jio.save_elements(j, epath)
    idx = load_granne(ipath, epath, device="cpu")
    words = [f"w{i}" for i in range(V)]
    tw, jw = WordEmbeddingsGranne(idx, emb, WordDict(words)), japi.WordEmbeddingsGranne(
        J.load_granne(ipath, epath), emb, jetl.WordDict(words))
    for i in (0, 9, 41):
        v = np.asarray(j.get(jnp.asarray([i], jnp.int32)))[0]
        got, want = tw.search(v, 20, 3), jw.search(v, 20, 3)
        assert [a for a, _ in got] == [a for a, _ in want]
        np.testing.assert_allclose([b for _, b in got], [b for _, b in want], atol=1e-6)
        np.testing.assert_allclose(tw.get_element(i), jw.get_element(i), atol=1e-6)
        assert tw.get_internal_element(i) == jw.get_internal_element(i) == [f"w{t}" for t in lists[i]]
        assert idx.get_internal_element(i) == [int(t) for t in lists[i]]
    text = "w3 w17 unknown w40"
    want = _unit(emb[3].astype(np.float64) + emb[17] + emb[40])
    np.testing.assert_allclose(tw.get_internal_vector(text), want, atol=1e-6)
    np.testing.assert_allclose(tw.get_internal_vector("w5"), jw.get_internal_vector("w5"), atol=1e-6)
    assert np.all(tw.get_internal_vector("none of these") == 0.0)
    bag = lists[12]
    hit = tw.search(" ".join(f"w{t}" for t in bag), 20, 1)[0]
    assert hit[1] < 1e-5 and sorted(idx.get_internal_element(hit[0])) == sorted(int(t) for t in bag)

    vecs = rng.standard_normal((60, 8)).astype(np.float32)
    for el in (AngularVectors.from_raw(vecs, device="cpu"), AngularIntVectors.from_raw(vecs, device="cpu")):
        g = Granne(layers=build_layers(el, BuildConfig(num_neighbors=6, max_search=12)), elements=el)
        assert np.array_equal(g.get_element(5), el.vectors[5].numpy()) and g.get_element(5).dtype == el.vectors.numpy().dtype
        assert np.array_equal(g.get_internal_element(5), g.get_element(5))
    bf = Granne(layers=g.layers, elements=AngularVectors.from_raw(vecs, device="cpu").as_bf16())
    assert np.array_equal(bf.get_element(2), bf.elements.vectors[2].float().numpy())
    with pytest.raises(IndexError):
        idx.get_element(N)
    with pytest.raises(TypeError, match="embeddings"):
        HostGranne(ipath, epath)


def test_reference_faults_not_copied(rng):
    """The JAX package's text query embeds only its first word (its embedder
    has width 1); the port's sums all.  JAX's extend truncates a longer list
    to the width; the port's widens.  JAX's "f32" neighbor table over
    SumEmbeddings holds bf16-rounded rows; the port's the exact f32 sums."""
    emb, lists = _parts(rng, n=80)
    words = [f"w{i}" for i in range(V)]
    jw = japi.WordEmbeddingsGranne(None, emb, jetl.WordDict(words))
    tw = WordEmbeddingsGranne(Granne(layers=None, elements=SumEmbeddings.from_parts(emb, [[0]], device="cpu")),
                              emb, WordDict(words))
    np.testing.assert_allclose(jw.get_internal_vector("w1 w2"), _unit(emb[1]), atol=1e-6)  # the fault
    np.testing.assert_allclose(tw.get_internal_vector("w1 w2"), _unit(emb[1].astype(np.float64) + emb[2]), atol=1e-6)

    j2, t2 = JSum.from_parts(emb, [[0, 1], [2]]), SumEmbeddings.from_parts(emb, [[0, 1], [2]], device="cpu")
    assert j2.extend([[2, 3, 4]]).get_terms(2) == [2, 3]  # the fault
    t3 = t2.extend([[2, 3, 4]])
    assert t3.get_terms(2) == [2, 3, 4] and t3.get_terms(0) == [0, 1] and t3.terms.shape == (3, 3)
    np.testing.assert_allclose(t3.get(torch.tensor([2])).numpy()[0], _unit(emb[2].astype(np.float64) + emb[3] + emb[4]),
                               atol=1e-6)

    j, t = JSum.from_parts(emb, lists), SumEmbeddings.from_parts(emb, lists, device="cpu")
    adj = build_layers(t, BuildConfig(num_neighbors=6, max_search=12)).layers[-1]
    M = adj.shape[1]
    jtab = np.asarray(j_make_cache(jnp.asarray(adj.numpy()), j, rows=80, cache_dtype="f32"))
    tab = make_neighbor_cache(adj, t, rows=80, cache_dtype="f32")
    want = t.get(adj.clamp_min(0)).reshape(80, M * D)
    got = row_vecs(tab, M, D)
    mask = (adj >= 0).repeat_interleave(D, dim=1)
    assert torch.equal(got[mask], want[mask])  # the exact f32 sums
    jrows = jtab[:, : M * D].view(np.float32)
    assert np.array_equal(jrows, jrows.astype(jnp.bfloat16).astype(np.float32))  # JAX's: bf16-rounded
    assert not np.array_equal(jrows[mask.numpy()], want[mask].numpy())


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def test_builder_resumes_a_jax_embeddings_pair(tmp_path):
    """JAX builds the first half of the bags and saves the index and the
    whole csr24 element file; the port's ``GranneBuilder.from_index`` (and
    ``from_bytes``) resumes it, and its graph matches JAX's resumed build
    (per-layer edge Jaccard > 0.95, tests/test_torch_builder.py's bar).
    The port saves, loads and searches the result."""
    emb, lists = _parts(np.random.default_rng(31), n=600)
    cfg = dict(num_neighbors=10, max_search=24)
    j = JSum.from_parts(emb, lists)
    half = J.build_layers(j, J.BuildConfig(**cfg), num_elements=300)
    ipath, epath = str(tmp_path / "half.gtz"), str(tmp_path / "all.gt")
    jio.save_index(half, ipath, compressed=True)
    jio.save_elements(j, epath)
    want = J.build_layers(j, J.BuildConfig(**cfg), state=half)

    b = GranneBuilder.from_index(ipath, epath, device="cpu", **cfg)
    assert b.element_type == "embeddings" and b.indexed_elements == 300 and len(b) == 600
    b.build()
    got = b.get_index().layers
    assert got.counts == tuple(want.counts)
    for a, c in zip(got.as_numpy(), want.as_numpy()):
        assert a.shape == c.shape and _jaccard(a, c) > 0.95
    with open(ipath, "rb") as fi, open(epath, "rb") as fe:
        again = GranneBuilder.from_bytes(fi.read(), fe.read(), device="cpu", **cfg)
    again.build()
    assert all(np.array_equal(a, c) for a, c in zip(again.get_index().layers.as_numpy(), got.as_numpy()))

    b.save_index(str(tmp_path / "i.gtz"))
    b.save_elements(str(tmp_path / "e.gt"))
    assert filecmp.cmp(str(tmp_path / "e.gt"), epath, shallow=False)  # nothing appended: the same file
    index = load_granne(str(tmp_path / "i.gtz"), str(tmp_path / "e.gt"), device="cpu")
    ids, d = index.search_batch(np.stack([index.get_element(i) for i in range(0, 600, 5)]), 24, 1)
    assert float(np.mean(d[:, 0].numpy() <= 1e-5)) > 0.95  # an element finds itself or an equal bag


def test_builder_appends_term_lists():
    """``append`` on an ``"embeddings"`` builder takes one term-id list or
    a list of them, and refuses raw vectors (JAX's builder labels the
    container ``angular_int`` and would feed them to ``extend``)."""
    emb, lists = _parts(np.random.default_rng(32), n=240)
    b = GranneBuilder.from_elements(SumEmbeddings.from_parts(emb, lists[:100], device="cpu"),
                                    num_neighbors=8, max_search=16)
    b.append(lists[100])
    b.append(lists[101:200])
    b.append(np.array(lists[200]))
    for bad in (np.ones(D, np.float32), [0.5, 1.0], np.ones((2, D), np.float32), [[1, 2], [0.5]]):
        with pytest.raises(ValueError, match="term-id lists"):
            b.append(bad)
    assert len(b) == 201 and b.elements.get_terms(150) == [int(t) for t in lists[150]]
    b.build()
    assert b.indexed_elements == 201
    np.testing.assert_allclose(b.get_element(150), _unit(emb[lists[150]].sum(axis=0)), atol=1e-6)
    assert b.search(b.get_element(200), 16, 1)[0][1] <= 1e-5
    with pytest.raises(ValueError, match="SumEmbeddings"):
        GranneBuilder("embeddings", device="cpu")
