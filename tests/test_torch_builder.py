"""granne_tpu_torch wave builder against granne_tpu and the scalar oracle.

The same data and BuildConfig go through both packages (one JAX build per
file, module fixture): equal layer counts and a bottom-layer edge-set
Jaccard above 0.95 (the multi-device parity bar of ``__graft_entry__.py``).
The remaining cases mirror ``tests/test_builder.py`` on the port.
"""

import jax
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index import schedule as jschedule
from granne_tpu.models import scalar_ref
from granne_tpu_torch import MAX_ELEMENTS, AngularVectors, BuildConfig, Granne, build_layers
from granne_tpu_torch.index import schedule


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


N, D = 2000, 32
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


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_layers(data):
    return J.build_layers(J.AngularVectors.from_raw(data), J.BuildConfig(**CFG))


def _self_recall(layers, elements, vecs):
    ids, _ = Granne(layers=layers, elements=elements).search_batch(vecs, max_search=20, num_neighbors=1)
    return float(np.mean(ids[:, 0].numpy() == np.arange(len(vecs))))


@pytest.mark.parametrize("reinsert", [True, False])
def test_build_matches_jax(data, jax_layers, reinsert):
    if reinsert:
        jl = jax_layers
    else:
        jl = J.build_layers(J.AngularVectors.from_raw(data[:600]), J.BuildConfig(reinsert_elements=False, **CFG))
    vecs = data if reinsert else data[:600]
    el = AngularVectors.from_raw(vecs, device="cpu")
    tl = build_layers(el, BuildConfig(reinsert_elements=reinsert, **CFG))
    assert tl.counts == jl.counts
    assert list(tl.counts) == schedule.layer_counts(len(vecs), 15.0) == jschedule.layer_counts(len(vecs), 15.0)
    for a, b in zip(tl.as_numpy(), jl.as_numpy()):
        assert a.shape == b.shape
        assert _jaccard(a, b) > 0.95
    assert _self_recall(tl, el, vecs) > 0.95


def test_neighbor_rows_are_valid(data):
    el = AngularVectors.from_raw(data[:400], device="cpu")
    tl = build_layers(el, BuildConfig(num_neighbors=16, max_search=30))
    for layer, count in zip(tl.layers, tl.counts):
        used = layer[:count].numpy()
        assert layer.dtype == torch.int32 and used.max() < count
        for i in range(0, count, 37):
            row = [x for x in used[i] if x >= 0]
            assert i not in row and len(row) == len(set(row))


def test_zero_vector_skipped(rng):
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    vecs[7] = 0.0
    tl = build_layers(AngularVectors.from_raw(vecs, device="cpu"), BuildConfig(num_neighbors=16, max_search=30))
    bottom = tl.layers[-1].numpy()
    assert np.all(bottom[7] == -1)  # no forward edges
    assert not np.any(bottom == 7)  # no reverse edges


def test_duplicate_elements_dead_nodes(rng):
    n, d, m = 200, 16, 10
    vecs = np.tile(rng.standard_normal((20, d)).astype(np.float32), (10, 1))
    tl = build_layers(AngularVectors.from_raw(vecs, device="cpu"), BuildConfig(num_neighbors=m, max_search=20))
    connected = int(np.sum(np.any(tl.layers[-1].numpy() >= 0, axis=1)))
    oracle = scalar_ref.ScalarHnswBuilder(vecs, num_neighbors=m, max_search=20)
    oracle.build()
    oracle_connected = int(np.sum(np.any(oracle.layers[-1] >= 0, axis=1)))
    assert connected <= 20 * (m // 2 + 1)
    assert abs(connected - oracle_connected) <= 25


def test_partial_build_then_continue(data):
    vecs = data[:600]
    el = AngularVectors.from_raw(vecs, device="cpu")
    cfg = BuildConfig(num_neighbors=16, max_search=30, expected_num_elements=600)
    part = build_layers(el, cfg, num_elements=300)
    assert part.num_elements == 300
    snapshot = [a.clone() for a in part.layers]
    full = build_layers(el, cfg, state=part)
    assert full.num_elements == 600
    # the resumed state is left as it was
    assert all(torch.equal(a, b) for a, b in zip(part.layers, snapshot))
    assert _self_recall(full, el, vecs) > 0.93


def test_build_errors(rng):
    el = AngularVectors.from_raw(rng.standard_normal((50, 8)).astype(np.float32), device="cpu")
    with pytest.raises(ValueError, match="more elements than exist"):
        build_layers(el, BuildConfig(), num_elements=51)
    part = build_layers(el, BuildConfig(num_neighbors=8, max_search=16), num_elements=40)
    with pytest.raises(ValueError, match="fewer elements"):
        build_layers(el, BuildConfig(num_neighbors=8, max_search=16), num_elements=30, state=part)

    class HugeElements:
        def __len__(self):
            return MAX_ELEMENTS + 1

    with pytest.raises(ValueError, match="at most"):
        build_layers(HugeElements(), BuildConfig())
    empty = AngularVectors.from_raw(np.zeros((0, 8), np.float32), device="cpu")
    assert build_layers(empty, BuildConfig()).num_elements == 0


@pytest.mark.parametrize(
    "kw",
    [dict(neighbor_cache=True), dict(neighbor_cache=True, neighbor_cache_layout="tiled"), dict(gather_budget=8)],
)
def test_unported_build_options_raise(data, kw):
    """The options that once raised NotImplementedError now build: the
    cache-fed build (flat and tiled) and the budgeted build beam give valid
    rows and the uncached build's self-recall bar
    (tests/test_torch_cache_build.py holds them against JAX)."""
    vecs = data[:600]
    el = AngularVectors.from_raw(vecs, device="cpu")
    tl = build_layers(el, BuildConfig(num_neighbors=16, max_search=30, **kw))
    assert tl.num_elements == 600
    bottom = tl.layers[-1].numpy()
    assert bottom.max() < 600 and all(i not in bottom[i] for i in range(0, 600, 41))
    assert _self_recall(tl, el, vecs) > 0.95


def test_build_config_defaults_match_jax():
    assert BuildConfig() == BuildConfig(**vars(J.BuildConfig()))
