"""granne_tpu_torch distance, sort and heuristic helpers against granne_tpu.

The same numpy inputs (fixed seeds) go through the JAX function and its
PyTorch counterpart on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granne_tpu import AngularVectors as JAngular
from granne_tpu.index import heuristic as jheur
from granne_tpu.ops import distance as jdist
from granne_tpu.ops import topk as jtopk
from granne_tpu_torch import AngularVectors
from granne_tpu_torch.elements.base import supports_cache
from granne_tpu_torch.index import heuristic
from granne_tpu_torch.ops import distance, topk


def _t(x):
    return torch.as_tensor(np.array(x))


def test_normalize_matches_jax(rng):
    x = rng.standard_normal((64, 37)).astype(np.float32)
    x[5] = 0.0  # zero rows stay zero
    got = distance.normalize(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdist.normalize(jnp.asarray(x))), atol=1e-6)
    assert np.all(got[5] == 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_angular_distances_match_jax(rng, dtype):
    """f32 results from f32 or bf16 operands (bf16 upcast before the
    contraction, as preferred_element_type=float32 does in JAX)."""
    a = jdist.normalize(jnp.asarray(rng.standard_normal((6, 9, 40)), jnp.float32))
    q = jdist.normalize(jnp.asarray(rng.standard_normal((6, 40)), jnp.float32))
    if dtype == "bf16":
        a, q = a.astype(jnp.bfloat16), q.astype(jnp.bfloat16)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ta = _t(a.astype(jnp.float32)).to(tdt)  # exact: the values are already bf16
    tq = _t(q.astype(jnp.float32)).to(tdt)
    for got, want in [
        (distance.angular_dist_gathered(ta, tq), jdist.angular_dist_gathered(a, q)),
        (distance.angular_pairwise_gathered(ta), jdist.angular_pairwise_gathered(a)),
        (distance.angular_dist_matrix(ta[0], tq), jdist.angular_dist_matrix(a[0], q)),
    ]:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_angular_container_matches_jax(rng):
    raw = rng.standard_normal((50, 12)).astype(np.float32)
    raw[3] = 0.0
    j = JAngular.from_raw(raw)
    t = AngularVectors.from_raw(raw, device="cpu")
    ids = rng.integers(-1, 50, (4, 7)).astype(np.int32)
    q = rng.standard_normal((4, 12)).astype(np.float32)
    np.testing.assert_allclose(
        t.dist_ids_to_queries(_t(ids), t.prepare_queries(q)).numpy(),
        np.asarray(j.dist_ids_to_queries(jnp.asarray(ids), j.prepare_queries(jnp.asarray(q)))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        t.self_dist(_t(np.arange(50, dtype=np.int32))).numpy(),
        np.asarray(j.self_dist(jnp.arange(50, dtype=jnp.int32))), atol=1e-6,
    )
    assert abs(t.dist(0, 1) - j.dist(0, 1)) < 1e-6
    assert supports_cache(t) and supports_cache(t.as_bf16())
    assert t.as_bf16().vectors.dtype == torch.bfloat16
    assert len(t.extend(raw[:5])) == 55 and len(t) == 50


def test_sort_and_merge_match_jax(rng):
    key = rng.integers(0, 6, (5, 13)).astype(np.float32)  # many ties: stability matters
    val = rng.integers(0, 100, (5, 13)).astype(np.int32)
    sk, sv = topk.sort_by_key(_t(key), _t(val))
    jk, jv = jtopk.sort_by_key(jnp.asarray(key), jnp.asarray(val))
    assert np.array_equal(sk.numpy(), np.asarray(jk)) and np.array_equal(sv.numpy(), np.asarray(jv))

    a = np.sort(rng.integers(0, 8, (5, 10)).astype(np.float32), axis=1)
    b = np.sort(rng.integers(0, 8, (5, 7)).astype(np.float32), axis=1)
    a_ids = np.arange(50, dtype=np.int32).reshape(5, 10)
    b_ids = 100 + np.arange(35, dtype=np.int32).reshape(5, 7)
    d, (ids,) = topk.merge_sorted_topk(_t(a), (_t(a_ids),), _t(b), (_t(b_ids),), 9)
    jd, (jids,) = jtopk.merge_sorted_topk(
        jnp.asarray(a), (jnp.asarray(a_ids),), jnp.asarray(b), (jnp.asarray(b_ids),), 9
    )
    assert np.array_equal(d.numpy(), np.asarray(jd))
    # the same entries below the cut (at the cut, ties may keep either
    # entry), and ties keep the a side: a tied key's a ids come first
    for row_t, row_j, row_d in zip(ids.numpy(), np.asarray(jids), d.numpy()):
        for key_val in np.unique(row_d):
            sel = row_d == key_val
            if key_val < row_d[-1]:
                assert sorted(row_t[sel]) == sorted(row_j[sel])
            tied = row_t[sel]
            assert list(tied < 100) == sorted(tied < 100, reverse=True)


def test_compact_by_mask_matches_jax(rng):
    ids = rng.integers(0, 100, (6, 11)).astype(np.int32)
    d = rng.random((6, 11)).astype(np.float32)
    keep = rng.random((6, 11)) < 0.6
    for k in (3, 11):
        got = topk.compact_by_mask(_t(ids), _t(d), _t(keep), k)
        want = jtopk.compact_by_mask(jnp.asarray(ids), jnp.asarray(d), jnp.asarray(keep), k)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_select_neighbors_matches_jax(rng):
    n, d, B, C, M = 300, 10, 16, 40, 8
    raw = rng.standard_normal((n, d)).astype(np.float32)
    raw[7] = raw[9]  # an exact duplicate: the tie rule keeps both
    j = JAngular.from_raw(raw)
    t = AngularVectors.from_raw(raw, device="cpu")
    q = rng.integers(0, n, B).astype(np.int32)
    cand = np.stack([rng.permutation(n)[:C] for _ in range(B)]).astype(np.int32)
    cand[0, :2] = [7, 9]
    cand[:, -5:] = -1
    jd = np.asarray(j.dist_ids_to_queries(jnp.asarray(cand), j.queries_from_ids(jnp.asarray(q))))
    order = np.argsort(jd, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, 1)
    cd = np.where(cand >= 0, np.take_along_axis(jd, order, 1), np.inf).astype(np.float32)
    valid = cand >= 0
    got = heuristic.select_neighbors(t, _t(cand), _t(cd), _t(valid), M)
    want = jheur.select_neighbors(j, jnp.asarray(cand), jnp.asarray(cd), jnp.asarray(valid), M)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]))
    assert heuristic.EPS100 == float(jheur.EPS100)
