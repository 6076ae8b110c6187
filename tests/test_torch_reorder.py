"""granne_tpu_torch's locality reorder (``index/reorder.py``, ``Granne.reorder``)
against granne_tpu's on the same graphs.

The port builds the graphs (f32 n 600 and int8 n 400, d 16, M 12, ef 25,
as ``tests/test_reorder.py``); the JAX package gets them as arrays.  The
trails are held apart from the rest, since a near-tie in an ef=1 step may
go either way when torch and XLA sum in different orders: the port's trails
must agree with JAX's on at least 99% of the elements, the order computed
from JAX's trails must equal JAX's ``compute_order``, and applying one given
order must give the same layers, elements and file bytes in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index import io as jio
from granne_tpu.index import reorder as jreorder
from granne_tpu_torch import AngularIntVectors, AngularVectors, BuildConfig, Granne, build_layers
from granne_tpu_torch.index import io, reorder

N, D = 600, 16
CFG = dict(num_neighbors=12, max_search=25)


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


def _build(cls, n, seed):
    vecs = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    el = cls.from_raw(vecs, device="cpu")
    return vecs, Granne(layers=build_layers(el, BuildConfig(**CFG)), elements=el)


def _to_jax(index):
    codes = jnp.asarray(index.elements.vectors.numpy())
    if isinstance(index.elements, AngularIntVectors):
        el = J.AngularIntVectors.from_quantized(codes)
    else:
        el = J.AngularVectors.from_normalized(codes)
    return J.LayerStack.from_numpy(index.layers.as_numpy()), el


@pytest.fixture(scope="module")
def f32():
    vecs, index = _build(AngularVectors, N, 0)
    jlayers, jel = _to_jax(index)
    return vecs, index, jlayers, jel, jreorder.compute_order(jlayers, jel)


@pytest.fixture(scope="module")
def i8():
    vecs, index = _build(AngularIntVectors, 400, 1)
    return (vecs, index) + _to_jax(index)


def _same_reorder(tmp_path, index, jlayers, jel, order):
    """reorder_index with ``order`` in both packages: layers, elements and the
    saved files equal to the bit, in both directions."""
    layers, el, got = reorder.reorder_index(index.layers, index.elements, order)
    jl, je, jgot = jreorder.reorder_index(jlayers, jel, order)
    assert np.array_equal(got, jgot) and got.dtype == np.int64
    assert layers.counts == tuple(jl.counts)
    assert all(np.array_equal(a, b) for a, b in zip(layers.as_numpy(), jl.as_numpy()))
    assert all(a.dtype == torch.int32 for a in layers.layers)
    assert np.array_equal(el.vectors.numpy(), np.asarray(je.vectors))
    if isinstance(el, AngularIntVectors):
        assert np.array_equal(el.inv_norms.numpy(), np.asarray(je.inv_norms))
    for compressed in (False, True):
        io.save_index(layers, str(tmp_path / "p.gtz"), compressed=compressed)
        jio.save_index(jl, str(tmp_path / "j.gtz"), compressed=compressed)
        assert (tmp_path / "p.gtz").read_bytes() == (tmp_path / "j.gtz").read_bytes()
    io.save_elements(el, str(tmp_path / "p.gt"))
    jio.save_elements(je, str(tmp_path / "j.gt"))
    assert (tmp_path / "p.gt").read_bytes() == (tmp_path / "j.gt").read_bytes()
    return layers, el


def test_trails_and_order_match_jax(f32):
    _, index, jlayers, jel, jorder = f32
    jtrails = np.asarray(jreorder._entrypoint_trails(jlayers, jel))
    trails = reorder._entrypoint_trails(index.layers, index.elements)
    assert trails.shape == jtrails.shape == (N, min(reorder.MAX_TRAIL, index.num_layers - 1))
    assert trails.shape[1] >= 1 and trails.dtype == np.int32
    assert np.mean(np.all(trails == jtrails, axis=1)) >= 0.99
    # the sort alone, fed JAX's trails, is JAX's order
    assert np.array_equal(reorder.banded_order(index.layers.counts, jtrails), jorder)
    # batches do not change a trail
    assert np.array_equal(reorder._entrypoint_trails(index.layers, index.elements, batch=97), trails)
    # within each band the order sorts by trail (np.lexsort's last column is primary)
    order = reorder.compute_order(index.layers, index.elements)
    prev = 0
    for count in index.layers.counts:
        rows = [tuple(r) for r in trails[order[prev:count]]]
        assert rows == sorted(rows) and sorted(order[prev:count]) == list(range(prev, count))
        prev = count


def test_reorder_index_matches_jax(f32, tmp_path):
    _, index, jlayers, jel, jorder = f32
    _same_reorder(tmp_path, index, jlayers, jel, jorder)
    # the bf16 serving copy stays bf16
    assert index.elements.as_bf16().permute(jorder).vectors.dtype == torch.bfloat16


def test_int8_reorder_matches_jax(i8, tmp_path):
    _, index, jlayers, jel = i8
    order = reorder.compute_order(index.layers, index.elements)
    _same_reorder(tmp_path, index, jlayers, jel, order)


def test_order_by_keys_matches_jax(f32):
    vecs, index, jlayers, _, _ = f32
    rng = np.random.default_rng(4)
    for keys in (rng.integers(0, 50, N), rng.integers(0, 4, (N, 3))):
        order = reorder.order_by_keys(index.layers, keys)
        assert np.array_equal(order, jreorder.order_by_keys(jlayers, keys))
        prev = 0
        for count in index.layers.counts:
            band = [tuple(np.atleast_1d(k)) for k in keys[order[prev:count]]]
            assert band == sorted(band)
            prev = count
    with pytest.raises(ValueError, match="one key per element"):
        reorder.order_by_keys(index.layers, np.zeros(N - 1))


def test_reorder_translates_ids(f32):
    """The id translation contract (reorder.rs:19-57), the layer structure,
    an explicit order, reorder_by_keys, and recall after reorder."""
    vecs, index, _, _, _ = f32
    reordered, order = index.reorder()
    assert sorted(order.tolist()) == list(range(N))
    assert reordered.num_layers == index.num_layers
    assert [reordered.layer_len(i) for i in range(index.num_layers)] == list(index.layers.counts)
    for i in (3, 77, 200):
        assert order[reordered.search(vecs[i], 20, 1)[0][0]] == i
        assert np.array_equal(reordered.get_internal_element(int(np.flatnonzero(order == i)[0])),
                              index.get_element(i))
    old, new = index.layers.as_numpy()[-1], reordered.layers.as_numpy()[-1]
    for i in (0, 50, 123):  # isomorphic rows
        assert {int(x) for x in old[order[i]] if x >= 0} == {int(order[x]) for x in new[i] if x >= 0}
    ids, _ = reordered.search_batch(vecs, max_search=20, num_neighbors=1)
    assert np.mean(order[ids[:, 0].numpy()] == np.arange(N)) > 0.95
    # an explicit order: swap two ids of the bottom band only
    counts = index.layers.counts
    swap = np.arange(N)
    a, b = counts[-2] + 1, counts[-2] + 2
    swap[a], swap[b] = swap[b], swap[a]
    swapped, got = index.reorder(swap)
    assert np.array_equal(got, swap) and swapped.search(vecs[swap[a]], 20, 1)[0][0] == a
    # external keys
    keys = np.random.default_rng(2).integers(0, 50, N)
    by_keys, korder = index.reorder_by_keys(keys)
    for i in np.random.default_rng(3).integers(0, N, 20):
        assert by_keys.search(vecs[korder[i]], 20, 1)[0][0] == i


def test_reorder_drops_the_neighbor_cache_and_checks_the_order(f32):
    vecs, index, _, _, jorder = f32
    cached = Granne(layers=index.layers, elements=index.elements.as_bf16()).with_neighbor_cache("flat")
    reordered, order = cached.reorder(jorder)
    assert cached.nbr_vecs is not None and reordered.nbr_vecs is None
    assert reordered.elements.vectors.dtype == torch.bfloat16
    served = reordered.with_neighbor_cache("flat")
    ids, _ = served.search_batch(vecs, max_search=20, num_neighbors=1)
    assert np.mean(order[ids[:, 0].numpy()] == np.arange(N)) > 0.95
    for bad in (np.arange(N - 1), np.zeros(N, np.int64), np.arange(N)[::-1].copy()):
        with pytest.raises(ValueError):  # not a permutation, or a band left
            index.reorder(bad)


def test_single_layer_index_keeps_id_order():
    """A one-layer graph has no trail: the order is the identity in both
    packages, and any permutation is a valid order."""
    vecs, index = _build(AngularVectors, 12, 5)
    assert index.num_layers == 1
    jlayers, jel = _to_jax(index)
    assert reorder._entrypoint_trails(index.layers, index.elements).shape == (12, 0)
    assert np.array_equal(reorder.compute_order(index.layers, index.elements), np.arange(12))
    assert np.array_equal(jreorder.compute_order(jlayers, jel), np.arange(12))
    perm = np.random.default_rng(6).permutation(12)
    layers, el, _ = reorder.reorder_index(index.layers, index.elements, perm)
    jl, je, _ = jreorder.reorder_index(jlayers, jel, perm)
    assert np.array_equal(layers.as_numpy()[0], jl.as_numpy()[0])
    assert np.array_equal(el.vectors.numpy(), np.asarray(je.vectors))
