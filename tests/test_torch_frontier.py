"""granne_tpu_torch beam search against granne_tpu on a JAX-built graph.

One JAX build per file (module fixture); ``convert.py`` carries it into the
port.  The serve path with a flat bf16 cache is compared with the JAX
search through its Pallas flat kernel, interpreted on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index.graph import LayerStack as JLayerStack
from granne_tpu.models import scalar_ref
from granne_tpu.ops import frontier as jfrontier
from granne_tpu.ops.nbr_cache import make_neighbor_cache as j_make_cache
from granne_tpu_torch import AngularVectors, convert
from granne_tpu_torch.index.granne import Granne
from granne_tpu_torch.ops import frontier
from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat

N, D, M = 1200, 121, 8  # row_width(8, 121) = 1024: the JAX flat kernel's layout rule
NQ, EF, K = 64, 16, 5


@pytest.fixture(scope="module")
def jax_graph():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    el = J.AngularVectors.from_raw(vecs)
    layers = J.build_layers(el, J.BuildConfig(num_neighbors=M, max_search=24))
    queries = rng.standard_normal((NQ, D)).astype(np.float32)
    return layers, el, queries


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


def test_f32_search_matches_jax(jax_graph):
    jlayers, jel, queries = jax_graph
    idx = convert.granne_from_numpy(jlayers.as_numpy(), np.asarray(jel.vectors), device="cpu")
    jq = jel.prepare_queries(jnp.asarray(queries))
    jids, jd = jfrontier.search_layers(jlayers.layers, jel, jq, ef=EF, num_neighbors=K)
    ids, d = idx.search_batch(queries, max_search=EF, num_neighbors=K)
    assert ids.dtype == torch.int32 and ids.shape == (NQ, K)
    assert _overlap(ids.numpy(), np.asarray(jids)) >= 0.99
    np.testing.assert_allclose(np.sort(d.numpy()), np.sort(np.asarray(jd)), atol=1e-5)


@pytest.mark.parametrize("expand", [1, 2])
def test_bf16_flat_cache_search_matches_jax_pallas(jax_graph, expand):
    """Overlap > 0.99 and dists within 2e-3 (the bars of the JAX package's
    own fused-kernel parity test): the Pallas kernel rounds each product to
    bf16, the port does not."""
    jlayers, jel, queries = jax_graph
    jel16 = jel.as_bf16()
    jtab = j_make_cache(jlayers.layers[-1], jel16, rows=N)
    jq = jel16.prepare_queries(jnp.asarray(queries))
    jids, jd = jfrontier.search_layers(
        jlayers.layers, jel16, jq, ef=EF, num_neighbors=K, expand=expand,
        nbr_vecs=jtab, pallas_flat="interpret",
    )
    f32 = convert.granne_from_numpy(jlayers.as_numpy(), np.asarray(jel.vectors), device="cpu")
    idx = Granne(layers=f32.layers, elements=f32.elements.as_bf16()).with_neighbor_cache("flat")
    assert np.array_equal(idx.nbr_vecs.numpy(), np.asarray(jtab)[:N])
    ids, d = idx.search_batch(queries, max_search=EF, num_neighbors=K, expand=expand)
    assert _overlap(ids.numpy(), np.asarray(jids)) > 0.99
    np.testing.assert_allclose(np.sort(d.numpy()), np.sort(np.asarray(jd)), atol=2e-3)


def test_cached_search_goes_through_k1_wrapper(jax_graph, monkeypatch):
    jlayers, jel, queries = jax_graph
    f32 = convert.granne_from_numpy(jlayers.as_numpy(), np.asarray(jel.vectors), device="cpu")
    idx = Granne(layers=f32.layers, elements=f32.elements.as_bf16()).with_neighbor_cache()
    calls = []

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return gather_score_flat(*args, **kw)

    monkeypatch.setattr(frontier, "gather_score_flat", spy)
    idx.search_batch(queries[:8], max_search=EF, num_neighbors=K)
    assert calls and all(shape == (8, 1) for shape in calls)


def test_descent_ef_seeding_matches_jax(jax_graph):
    jlayers, jel, queries = jax_graph
    idx = convert.granne_from_numpy(jlayers.as_numpy(), np.asarray(jel.vectors), device="cpu")
    jq = jel.prepare_queries(jnp.asarray(queries))
    jids, _ = jfrontier.search_layers(jlayers.layers, jel, jq, ef=EF, num_neighbors=K, descent_ef=4)
    q = idx.elements.prepare_queries(queries)
    ids, _ = frontier.search_layers(idx.layers.layers, idx.elements, q, ef=EF, num_neighbors=K, descent_ef=4)
    assert _overlap(ids.numpy(), np.asarray(jids)) >= 0.99


@pytest.mark.parametrize("n,d", [(200, 16), (500, 25)])
def test_bottom_layer_beam_matches_oracle(n, d):
    """The port's beam against the scalar heap/visited-set search on the
    oracle's own graph (as tests/test_frontier.py does for the JAX beam)."""
    rng = np.random.default_rng(0)
    b = scalar_ref.ScalarHnswBuilder(rng.standard_normal((n, d)).astype(np.float32), num_neighbors=10, max_search=40)
    b.build()
    adj = b.layers[-1]
    elements = AngularVectors.from_normalized(b.vectors, device="cpu")
    qn = scalar_ref.normalize_rows(rng.standard_normal((32, d)).astype(np.float32))
    ids, dists = frontier.beam_search(
        torch.from_numpy(adj), elements, elements.prepare_queries(qn), torch.zeros(32, dtype=torch.int32), ef=30
    )
    ids, dists = ids.numpy(), dists.numpy()
    agree = 0
    for k in range(32):
        oracle = [i for i, _ in scalar_ref.search_for_neighbors(adj, 0, b.vectors, qn[k], 30)]
        got = [int(i) for i in ids[k] if i >= 0]
        assert np.all(np.diff(dists[k][ids[k] >= 0]) >= -1e-6)
        assert got[0] == oracle[0]
        assert len(set(got) & set(oracle)) / max(1, len(oracle)) >= 0.9
        agree += set(got) == set(oracle)
    assert agree >= int(0.8 * 32)


def test_empty_index_and_unported_options():
    el = AngularVectors.from_raw(np.ones((4, 3), np.float32), device="cpu")
    q = el.prepare_queries(np.ones((2, 3), np.float32))
    ids, d = frontier.search_layers((), el, q, ef=4, num_neighbors=3)
    assert (ids == -1).all() and torch.isinf(d).all()
    adj = torch.full((4, 2), -1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 8"):
        frontier.search_layers((adj,), el, q, ef=4, num_neighbors=3, rerank=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        frontier.beam_search(adj, el, q, torch.zeros(2, dtype=torch.int32), ef=4, gather_budget=2)


def test_jax_layer_stack_round_trip(jax_graph):
    jlayers, _, _ = jax_graph
    stack = convert.layers_from_numpy(jlayers.as_numpy(), device="cpu")
    assert stack.counts == jlayers.counts
    back = JLayerStack.from_numpy(stack.as_numpy())
    for a, b in zip(back.as_numpy(), jlayers.as_numpy()):
        assert np.array_equal(a, b)
