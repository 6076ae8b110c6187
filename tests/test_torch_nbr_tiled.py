"""The tiled and f32 neighbor-cache tables and K2 (gather_score) against granne_tpu.

On the CPU the port's K2 wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernel interpreted, as its own tests do
(tests/test_nbr_score.py).  The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granne_tpu import AngularVectors as JAngular
from granne_tpu.ops import nbr_cache as jcache
from granne_tpu.ops.pallas import nbr_score as jscore
from granne_tpu_torch import AngularVectors, convert
from granne_tpu_torch.ops import nbr_cache
from granne_tpu_torch.ops.kernels import build, nbr_score


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


NAN_IDS = [0x7F85, 0xFF90, 0x1FF85]  # id halves that are bf16 NaN patterns


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bits(t):
    """Table contents as comparable numpy integers (bf16 as its bit patterns)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _elements(rng, n, d, dtype):
    """The same unit vectors in both packages (normalized once, by JAX)."""
    jel = JAngular.from_raw(rng.standard_normal((n, d)).astype(np.float32))
    tel = AngularVectors.from_normalized(np.asarray(jel.vectors), device="cpu")
    return (jel.as_bf16(), tel.as_bf16()) if dtype == "bf16" else (jel, tel)


def test_tiled_tables_bit_equal_to_jax(rng):
    n, M, d = 300, 6, 19  # Mp = 8
    adj = rng.integers(-1, n, (n, M)).astype(np.int32)
    for dtype in ("f32", "bf16"):
        jel, tel = _elements(rng, n, d, dtype)
        jt = jcache.make_neighbor_cache(jnp.asarray(adj), jel, rows=n, chunk=128, layout="tiled")
        tt = nbr_cache.make_neighbor_cache(torch.from_numpy(adj), tel, rows=n, chunk=128, layout="tiled")
        assert tt.dtype == torch.bfloat16 and tt.shape == (n, nbr_cache.tiled_height(M), 128)
        assert np.array_equal(_bits(tt), _bits(jt)[:n]), dtype
        assert nbr_cache.table_kind(tt) == "tiled"
    vals = _unit(rng, (40, M, d))
    jp = jcache.pack_rows(jnp.asarray(vals, jnp.bfloat16), "tiled")
    tp = nbr_cache.pack_rows(torch.from_numpy(vals).to(torch.bfloat16), "tiled")
    assert np.array_equal(_bits(tp), _bits(jp))
    ids = torch.from_numpy(rng.integers(-1, 40, 17).astype(np.int32))
    jv = jcache.rows_to_vecs(jp, jnp.asarray(ids.numpy()), M, d)
    assert np.array_equal(_bits(nbr_cache.rows_to_vecs(tp, ids, M, d)), _bits(jv))
    with pytest.raises(ValueError, match="d <= 128"):
        nbr_cache.pack_rows(torch.zeros((2, M, 130), dtype=torch.bfloat16), "tiled")


def test_f32_flat_table_bit_equal_to_jax(rng):
    """f32 rows ride in an int32 table with the ids stored directly, so
    NaN-pattern ids and f32 vectors survive bit for bit."""
    n, M, d = 300, 8, 19  # M*d + M = 160 lanes -> 256
    jel, tel = _elements(rng, n, d, "f32")
    adj = rng.integers(-1, n, (n, M)).astype(np.int32)
    adj[5, :3] = NAN_IDS
    jt = jcache.make_neighbor_cache(jnp.asarray(adj), jel, rows=n, chunk=128, cache_dtype="f32")
    tt = nbr_cache.make_neighbor_cache(torch.from_numpy(adj), tel, rows=n, chunk=128, cache_dtype="f32")
    assert tt.dtype == torch.int32 and tt.shape == (n, nbr_cache.row_width(M, d, torch.float32)) == (n, 256)
    assert np.array_equal(tt.numpy(), np.asarray(jt)[:n])
    assert nbr_cache.table_kind(tt) == "flat-f32"
    assert np.array_equal(nbr_cache.unpack_ids(tt, M, d).numpy(), adj)
    want = tel.get(torch.from_numpy(adj).clamp_min(0)).reshape(n, M * d)
    assert torch.equal(nbr_cache.row_vecs(tt, M, d), want)
    vals = _unit(rng, (30, M, d))
    ids = rng.integers(-1, 1 << 20, (30, M)).astype(np.int32)
    jp = jcache.pack_rows(jnp.asarray(vals), "flat", ids=jnp.asarray(ids))
    tp = nbr_cache.pack_rows(torch.from_numpy(vals), "flat", ids=torch.from_numpy(ids))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    sel = torch.from_numpy(rng.integers(-1, 30, 11).astype(np.int32))
    jv = jcache.rows_to_vecs(jp, jnp.asarray(sel.numpy()), M, d)
    assert np.array_equal(nbr_cache.rows_to_vecs(tp, sel, M, d).numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="only supported for layout='flat'"):
        nbr_cache.make_neighbor_cache(torch.from_numpy(adj), tel, layout="tiled", cache_dtype="f32")


def test_gather_score_reference_matches_pallas(rng):
    """Plain K2 vs the Pallas kernel (interpreted) on the same table, at
    E = 1 and 4: the JAX wrapper pads the query to 128 zero lanes, the port
    takes it plain.  Negative ids clip to row 0.  Both sum exact bf16
    products in f32."""
    n, M, d, B = 400, 6, 20, 32
    tab = nbr_cache.pack_rows(torch.from_numpy(_unit(rng, (n, M, d))).to(torch.bfloat16), "tiled")
    jtab = jnp.asarray(_bits(tab)).view(jnp.bfloat16)
    q = torch.from_numpy(_unit(rng, (B, d))).to(torch.bfloat16)
    qp = jnp.zeros((B, 128), jnp.bfloat16).at[:, :d].set(jnp.asarray(q.view(torch.int16).numpy()).view(jnp.bfloat16))
    for E in (1, 4):
        sel = rng.integers(-1, n, (B, E)).astype(np.int32)
        sel[0] = -1
        jd = jscore.gather_score(jtab, jnp.asarray(sel), qp, M=M, interpret=True)
        td = nbr_score.gather_score(tab, torch.from_numpy(sel), q, M=M)
        assert td.shape == (B, E * M) and td.dtype == torch.float32
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
        row0 = nbr_score.gather_score(tab, torch.zeros((B, E), dtype=torch.int32), q, M=M)
        assert torch.equal(td[0], row0[0])


def test_score_cached_matches_jax(rng):
    """score_cached on JAX-built tables of each kind, carried across by
    convert.neighbor_cache_from_numpy: tiled through K2 (interpreted Pallas
    on the JAX side), flat bf16 and f32 through score_block."""
    n, M, d, B, E = 300, 6, 20, 16, 3
    jel, tel = _elements(rng, n, d, "f32")
    adj = jnp.asarray(rng.integers(-1, n, (n, M)).astype(np.int32))
    sel = rng.integers(-1, n, (B, E)).astype(np.int32)
    jq = jel.prepare_queries(jnp.asarray(rng.standard_normal((B, d)).astype(np.float32)))
    for kind, layout, cache_dtype in (("tiled", "tiled", "bf16"), ("flat-bf16", "flat", "bf16"),
                                      ("flat-f32", "flat", "f32")):
        jtab = jcache.make_neighbor_cache(adj, jel, rows=n, layout=layout, cache_dtype=cache_dtype)
        tab = convert.neighbor_cache_from_numpy(np.asarray(jtab), device="cpu")
        assert nbr_cache.table_kind(tab) == kind and np.array_equal(_bits(tab), _bits(jtab))
        jd = jcache.score_cached(jtab, jnp.asarray(sel), jq, jel, M)
        td = nbr_cache.score_cached(tab, torch.from_numpy(sel), torch.from_numpy(np.array(jq)), tel, M)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6, err_msg=kind)


def test_tiled_search_goes_through_k2(rng, monkeypatch):
    """A tiled table in the beam reaches the K2 wrapper once per iteration."""
    from granne_tpu_torch.ops import frontier

    n, M, d = 200, 6, 12
    el = AngularVectors.from_raw(rng.standard_normal((n, d)).astype(np.float32), device="cpu")
    adj = torch.from_numpy(rng.integers(0, n, (n, M)).astype(np.int32))
    tab = nbr_cache.make_neighbor_cache(adj, el, layout="tiled")
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[1].shape))
        return nbr_score.gather_score_reference(*args, **kw)

    monkeypatch.setattr(nbr_score, "gather_score", spy)
    q = el.prepare_queries(rng.standard_normal((5, d)).astype(np.float32))
    ids, _ = frontier.beam_search(adj, el, q, torch.zeros(5, dtype=torch.int32), ef=8, expand=2, nbr_vecs=tab)
    assert calls and all(shape == (5, 2) for shape in calls)
    base, _ = frontier.beam_search(adj, el.as_bf16(), q.to(torch.bfloat16), torch.zeros(5, dtype=torch.int32),
                                   ef=8, expand=2)
    assert np.mean(ids.numpy() == base.numpy()) > 0.95


def test_cuda_tensor_raises_without_fallback(rng, monkeypatch):
    """On a CPU-only torch a CUDA tensor goes to K2, whose build fails: the
    wrapper raises and never runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("needs a torch without CUDA")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(nbr_score, "gather_score_reference", no_fallback)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR.parent / "no_such_build_dir_for_test")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    before = nbr_score.gather_score.launches
    with FakeTensorMode():
        tab = torch.zeros((10, 8, 128), dtype=torch.bfloat16, device="cuda")
        sel = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
        q = torch.zeros((2, 16), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            nbr_score.gather_score(tab, sel, q, M=6)
    assert nbr_score.gather_score.launches == before
    with pytest.raises(ValueError, match="d <= 128"):
        nbr_score.gather_score(torch.zeros((4, 8, 128), dtype=torch.bfloat16), torch.zeros((2, 1), dtype=torch.int32),
                               torch.zeros((2, 130), dtype=torch.bfloat16), M=6)
