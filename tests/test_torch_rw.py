"""granne_tpu_torch's online index (``index/rw.py``, ``RwGranneBuilder``):
the seven cases of ``tests/test_rw.py`` on the port (the layer-count case
looped into the comparison with granne_tpu, which shares its build), and
the same insert and flush sequence through both packages: equal layer
counts and a per-layer edge Jaccard above 0.95 (the bar of
``tests/test_torch_builder.py``).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index.rw import RwGranneBuilder as JRw
from granne_tpu_torch import AngularIntVectors, AngularVectors, BuildConfig, GranneBuilder, RwGranneBuilder
from granne_tpu_torch import load_granne
from granne_tpu_torch.index import schedule

D = 16


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_jax():
    """Drop every compiled JAX program before and after this module (each
    XLA:CPU executable holds memory maps; see tests/test_torch_builder.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's builds (the suite runs several
    workers at once; see tests/test_torch_builder.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vecs(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def _run(rw_cls, el, vecs, cfg, before_flush=None):
    """Base 300, then two inserts of 150 (the second reaches wave_size 256 and
    flushes), then a flush that finds nothing pending."""
    rw = rw_cls(el, cfg)
    rw.insert_batch(vecs[300:450])
    if before_flush is not None:
        before_flush(rw)
    rw.insert_batch(vecs[450:])
    rw.flush()
    return rw


def test_append_after_build_matches_jax():
    """The same sequence through both packages (the online builder declares
    its final size, so the layers follow the offline schedule, as the
    reference's rw test), appended elements findable, and a snapshot taken
    before a flush searches unchanged after it."""
    n = 600
    vecs = _vecs(0, n)
    kw = dict(num_neighbors=12, max_search=25, expected_num_elements=n)
    seen = {}

    def snapshot(rw):
        snap = rw.get_index()
        seen["snap"], seen["layers"] = snap, snap.layers.as_numpy()
        seen["result"] = snap.search_batch(vecs[:100], 20, 5)

    rw = _run(RwGranneBuilder, AngularVectors.from_raw(vecs[:300], device="cpu"), vecs, BuildConfig(**kw),
              snapshot)
    jrw = _run(JRw, J.AngularVectors.from_raw(vecs[:300]), vecs, J.BuildConfig(**kw))
    idx, jidx = rw.get_index(), jrw.get_index()
    assert rw.indexed_elements == len(rw) == jrw.indexed_elements == n
    counts = [idx.layer_len(i) for i in range(idx.num_layers)]
    assert counts == [jidx.layer_len(i) for i in range(jidx.num_layers)] == schedule.layer_counts(n, 15.0)
    for a, b in zip(idx.layers.as_numpy(), jidx.layers.as_numpy()):
        assert _jaccard(a, b) > 0.95
    ids, _ = rw.search_batch(vecs, max_search=20, num_neighbors=1)
    assert np.mean(ids[:, 0].numpy() == np.arange(n)) > 0.93
    # the snapshot from before the flush: same layers, same answers
    snap = seen["snap"]
    assert len(snap) == 300 and all(np.array_equal(a, b) for a, b in zip(snap.layers.as_numpy(), seen["layers"]))
    again = snap.search_batch(vecs[:100], 20, 5)
    assert all(torch.equal(a, b) for a, b in zip(again, seen["result"]))


def test_insert_visible_before_flush():
    """Elements are found the moment insert_batch returns (rw/mod.rs:99-182),
    for f32 and int8 (nearest codes: the tail is quantized as the flush
    will store it), and ids stay put across the flush."""
    base, extra = _vecs(1, 150), _vecs(2, 20)
    for el in (AngularVectors.from_raw(base, device="cpu"),
               AngularIntVectors.from_raw(base, rounding="nearest", device="cpu")):
        rw = RwGranneBuilder(el, BuildConfig(num_neighbors=12, max_search=25, wave_size=1024))
        rw.insert_batch(extra)
        assert rw.indexed_elements == 150 and len(rw) == 170
        ids, d = rw.search_batch(extra, max_search=20, num_neighbors=1)
        assert np.array_equal(ids[:, 0].numpy(), 150 + np.arange(20))
        assert np.all(d[:, 0].numpy() < 1e-3)
        tail_d = d[:, 0].clone()
        ids_b, _ = rw.search_batch(base[:50], max_search=20, num_neighbors=1)
        assert np.mean(ids_b[:, 0].numpy() == np.arange(50)) > 0.95
        rw.flush()
        ids2, d2 = rw.search_batch(extra, max_search=25, num_neighbors=1)
        assert np.array_equal(ids2[:, 0].numpy(), 150 + np.arange(20))
        assert torch.equal(d2[:, 0], tail_d)  # the same codes before and after the flush
    rw2 = RwGranneBuilder(AngularVectors.from_raw(np.zeros((0, 8), np.float32), device="cpu"),
                          BuildConfig(num_neighbors=8, max_search=10, wave_size=64))
    rw2.insert(np.ones(8, np.float32))
    res = rw2.search(np.ones(8, np.float32), 10, 3)
    assert res and res[0][0] == 0


def _threads(*targets):
    errors = []

    def guarded(fn):
        try:
            fn()
        except Exception as e:  # collected and re-raised by the test
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(fn,)) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def test_concurrent_flush_no_lost_updates():
    """Racing direct flush() calls drop none of each other's layers."""
    n = 200
    vecs = _vecs(3, n + 128)
    rw = RwGranneBuilder(AngularVectors.from_raw(vecs[:n], device="cpu"),
                         BuildConfig(num_neighbors=12, max_search=25, wave_size=10_000))

    def ins(lo):
        rw.insert_batch(vecs[lo : lo + 32])
        rw.flush()

    _threads(*[lambda lo=n + i * 32: ins(lo) for i in range(4)])
    rw.flush()
    assert rw.indexed_elements == n + 128
    # arrival order decides the ids: hold each element by its self-distance
    _, dists = rw.search_batch(vecs[n:], max_search=30, num_neighbors=1)
    assert np.mean(dists[:, 0].numpy() < 1e-3) > 0.95


def test_concurrent_insert_and_search():
    n = 300
    vecs = _vecs(4, n + 200)
    rw = RwGranneBuilder(AngularVectors.from_raw(vecs[:n], device="cpu"),
                         BuildConfig(num_neighbors=12, max_search=25, wave_size=64))

    def inserter():
        for lo in range(n, n + 200, 50):
            rw.insert_batch(vecs[lo : lo + 50])
        rw.flush()

    def searcher():
        for _ in range(10):
            ids, _ = rw.search_batch(vecs[:64], max_search=15, num_neighbors=3)
            assert tuple(ids.shape) == (64, 3)

    _threads(inserter, searcher, searcher)
    rw.flush()
    assert rw.indexed_elements == n + 200


def test_empty_and_single():
    rw = RwGranneBuilder(AngularVectors.from_raw(np.zeros((0, 8), np.float32), device="cpu"),
                         BuildConfig(num_neighbors=8, max_search=10))
    assert rw.search(np.ones(8, np.float32), 10, 3) == []
    rw.insert(np.ones(8, np.float32))
    rw.flush()
    res = rw.search(np.ones(8, np.float32), 10, 3)
    assert res and res[0][0] == 0


def test_save_while_serving(tmp_path):
    """save under concurrent searches; the files load, and resume building
    from caller-owned buffers (GranneBuilder.from_bytes)."""
    vecs = _vecs(5, 260)
    rw = RwGranneBuilder(AngularVectors.from_raw(vecs[:200], device="cpu"), BuildConfig(num_neighbors=12, max_search=20))
    rw.insert_batch(vecs[200:240])
    ipath, epath = tmp_path / "i.gtz", tmp_path / "e.gt"

    def searcher():
        for _ in range(5):
            rw.search_batch(vecs[:32], 20, 3)

    _threads(lambda: rw.save(str(ipath), str(epath)), searcher)
    idx = load_granne(str(ipath), str(epath), device="cpu")
    assert len(idx) == 240
    b = GranneBuilder.from_bytes(ipath.read_bytes(), epath.read_bytes(), num_neighbors=12, max_search=20,
                                 device="cpu")
    assert b.indexed_elements == 240
    b.append(vecs[240:])
    b.build()
    assert b.indexed_elements == len(b) == 260 and b.search(vecs[250], 20, 1)[0][0] == 250


def test_int8_online_index(tmp_path):
    """The online index over int8 codes: inserted rows found before the
    flush at their own ids, indexed after it, and saved as the i1 file
    that loads back with the same codes."""
    vecs = _vecs(6, 250)
    rw = RwGranneBuilder(AngularIntVectors.from_raw(vecs[:200], device="cpu"),
                         BuildConfig(num_neighbors=12, max_search=25, wave_size=1024))
    rw.insert_batch(vecs[200:])
    ids, d = rw.search_batch(vecs[200:], max_search=20, num_neighbors=1)
    assert np.array_equal(ids[:, 0].numpy(), 200 + np.arange(50)) and np.all(d[:, 0].numpy() < 1e-5)
    rw.flush()
    assert rw.indexed_elements == 250
    ids, _ = rw.search_batch(vecs, max_search=25, num_neighbors=1)
    assert np.mean(ids[:, 0].numpy() == np.arange(250)) > 0.95
    rw.save(str(tmp_path / "i.gtz"), str(tmp_path / "e.gt"))
    loaded = load_granne(str(tmp_path / "i.gtz"), str(tmp_path / "e.gt"), device="cpu")
    assert isinstance(loaded.elements, AngularIntVectors)
    assert torch.equal(loaded.elements.vectors, rw.get_index().elements.vectors)
