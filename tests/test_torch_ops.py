"""granne_tpu_torch distance, sort and heuristic helpers against granne_tpu.

The same numpy inputs (fixed seeds) go through the JAX function and its
PyTorch counterpart on the CPU.
"""

import jax
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
from granne_tpu_torch.ops.kernels.row_topk import K_MAX, row_top_k


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_jax():
    """Drop every compiled JAX program before and after this module: each
    XLA:CPU executable holds memory maps, and one test process that runs
    many JAX-heavy files can reach vm.max_map_count and crash."""
    jax.clear_caches()
    yield
    jax.clear_caches()


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
    # merge_topk (the read-write builder's tail merge, JAX's argument order):
    # one stable sort of the same concatenation, so equal to the last id
    d, (ids,) = topk.merge_topk(_t(a), _t(b), (_t(a_ids),), (_t(b_ids),), 9)
    jd, (jids,) = jtopk.merge_topk(jnp.asarray(a), jnp.asarray(b), (jnp.asarray(a_ids),), (jnp.asarray(b_ids),), 9)
    assert np.array_equal(d.numpy(), np.asarray(jd)) and np.array_equal(ids.numpy(), np.asarray(jids))


def tie_heavy_rows(rng, kind, R, C):
    """f32 [R, C] rows of one ``kind``: scores on a coarse grid (many exact
    ties), runs of one column repeated the way a split cluster repeats its
    centroid row, -inf with fewer finite values than 32, NaN beside -inf,
    and signed zeros."""
    x = (np.round(rng.standard_normal((R, C)) * 2) / 2 + 0.25).astype(np.float32)  # no zeros
    if kind == "split":
        x = np.repeat(rng.standard_normal((R, C // 3 + 1)).astype(np.float32), 3, axis=1)[:, :C]
    elif kind == "few_finite":
        x[:] = -np.inf
        for r in range(R):
            x[r, rng.choice(C, r % 5, replace=False)] = rng.integers(-2, 3, r % 5)
    elif kind == "nan":
        x[rng.random((R, C)) < 0.3] = np.nan
        x[rng.random((R, C)) < 0.3] = -np.inf
        x[: R // 2, : C - 3] = np.nan
    elif kind == "signed_zeros":
        x[:, ::3] = -0.0
        x[:, 1::4] = 0.0
    return np.ascontiguousarray(x)


ROW_KINDS = ["ties", "split", "few_finite", "nan", "signed_zeros"]


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_row_top_k_on_cpu_is_top_k(rng, kind):
    """``row_top_k`` on CPU tensors is ``top_k`` itself, bit for bit, at
    every k the kernel takes; where the rows hold no NaN and no zero (whose
    order XLA's total order sets apart), both also equal ``lax.top_k``."""
    for C in (33, 300):
        x = tie_heavy_rows(rng, kind, 24, C)
        for k in (1, 8, 10, 16, K_MAX):
            v, i = row_top_k(torch.from_numpy(x), k)
            tv, ti = topk.top_k(torch.from_numpy(x), k)
            assert v.dtype == torch.float32 and i.dtype == torch.int64 and v.shape == i.shape == (24, k)
            assert torch.equal(v.view(torch.int32), tv.view(torch.int32)) and torch.equal(i, ti)
            if kind in ("ties", "split", "few_finite"):
                jv, ji = jax.lax.top_k(jnp.asarray(x), k)
                assert np.array_equal(i.numpy(), np.asarray(ji)) and np.array_equal(v.numpy(), np.asarray(jv))


def test_row_top_k_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 40))
    for bad_k in (0, K_MAX + 1):
        with pytest.raises(ValueError, match="k must be"):
            row_top_k(x, bad_k)
    with pytest.raises(ValueError, match="k must be"):
        row_top_k(x[:, :5].contiguous(), 6)
    for bad in (x.double(), x[None], x.t(), x[:, ::2]):
        with pytest.raises(ValueError, match="contiguous f32"):
            row_top_k(bad, 3)


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
