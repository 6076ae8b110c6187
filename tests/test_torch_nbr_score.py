"""The flat neighbor cache and K1 (gather_score_flat) against granne_tpu.

On the CPU the port's K1 wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernel interpreted, as its own tests do.  The CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granne_tpu import AngularVectors as JAngular
from granne_tpu.ops import nbr_cache as jcache
from granne_tpu.ops.pallas import nbr_score as jscore
from granne_tpu_torch import AngularVectors
from granne_tpu_torch.ops import nbr_cache
from granne_tpu_torch.ops.kernels import build, nbr_score

NAN_IDS = [0x7F85, 0xFF90, 0x1FF85]  # id halves that are bf16 NaN patterns


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _tables(rng, n, M, d, unfilled=False):
    """The same flat table built by both packages from one numpy draw."""
    vals = _unit(rng, (n, M, d))
    adj = rng.integers(0, n, (n, M)).astype(np.int32)
    if unfilled:
        adj[:, M // 2 :] = -1
    adj[0, :3] = NAN_IDS
    jt = jcache.pack_rows(jnp.asarray(vals, jnp.bfloat16), "flat", ids=jnp.asarray(adj))
    tt = nbr_cache.pack_rows(torch.from_numpy(vals).to(torch.bfloat16), "flat", ids=torch.from_numpy(adj))
    return jt, tt, vals, adj


def test_pack_rows_bit_equal_to_jax(rng):
    n, M, d = 64, 6, 21  # M*d + 2M = 138 lanes -> 256
    jt, tt, _, adj = _tables(rng, n, M, d)
    adj[1, :] = -1
    assert tt.dtype == torch.int16 and tt.shape == (n, nbr_cache.row_width(M, d)) == jt.shape
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(nbr_cache.unpack_ids(tt, M, d).numpy()[0, :3], NAN_IDS)
    assert nbr_cache.table_kind(tt) == "flat-bf16"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_make_neighbor_cache_bit_equal_to_jax(rng, dtype):
    n, M, d = 300, 8, 19
    raw = rng.standard_normal((n, d)).astype(np.float32)
    adj = rng.integers(-1, n, (n, M)).astype(np.int32)
    adj[5, :3] = NAN_IDS
    jel, tel = JAngular.from_raw(raw), AngularVectors.from_raw(raw, device="cpu")
    if dtype == "bf16":
        jel, tel = jel.as_bf16(), tel.as_bf16()
    jt = np.asarray(jcache.make_neighbor_cache(jnp.asarray(adj), jel, rows=n, chunk=128))
    tt = nbr_cache.make_neighbor_cache(torch.from_numpy(adj), tel, rows=n, chunk=128)
    assert np.array_equal(tt.numpy(), jt[:n])


def test_unported_cache_variants_raise(rng):
    el = AngularVectors.from_raw(rng.standard_normal((8, 4)).astype(np.float32), device="cpu")
    adj = torch.full((8, 2), -1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 8"):
        nbr_cache.make_neighbor_cache(adj, el, layout="tiled")
    with pytest.raises(NotImplementedError, match="item 8"):
        nbr_cache.make_neighbor_cache(adj, el, cache_dtype="f32")
    with pytest.raises(ValueError, match="cache_dtype"):
        nbr_cache.make_neighbor_cache(adj, el, cache_dtype="f16")


def test_gather_score_flat_matches_pallas(rng):
    """Plain K1 vs the Pallas kernel (interpreted): ids exactly equal; dots
    within 2e-3 on unit-norm inputs, because the Pallas kernel rounds each
    product to bf16 before its indicator matmul and the port does not."""
    n, M, d, B, E = 400, 8, 121, 32, 2
    RW = nbr_cache.row_width(M, d)
    assert jscore.flat_ok(RW, M, d)
    jt, tt, _, _ = _tables(rng, n, M, d)
    q = _unit(rng, (B, d))
    sel = rng.integers(-1, n, (B, E)).astype(np.int32)
    jq = jnp.asarray(q, jnp.bfloat16)
    jd, jn = jscore.gather_score_flat(
        jt, jnp.asarray(sel), jscore.make_qtile(jq, M, RW), M=M, d=d, interpret=True
    )
    td, tn = nbr_score.gather_score_flat(
        tt, torch.from_numpy(sel), torch.from_numpy(q).to(torch.bfloat16), M=M, d=d
    )
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-3)


def test_gather_score_flat_unfilled_rows_finite(rng):
    """-1 ids embed as 0xFFFF lanes (bf16 NaN): they must never enter a dot."""
    n, M, d, B, E = 200, 8, 30, 16, 3
    _, tt, vals, adj = _tables(rng, n, M, d, unfilled=True)
    q = torch.from_numpy(_unit(rng, (B, d))).to(torch.bfloat16)
    sel = rng.integers(0, n, (B, E)).astype(np.int32)
    dots, nbrs = nbr_score.gather_score_flat(tt, torch.from_numpy(sel), q, M=M, d=d)
    assert torch.isfinite(dots).all()
    rows = torch.from_numpy(vals).to(torch.bfloat16).float()[sel.reshape(-1)]
    want = torch.einsum("kmd,kd->km", rows, q.float().repeat_interleave(E, 0)).reshape(B, E * M)
    np.testing.assert_allclose(dots.numpy(), want.numpy(), atol=1e-5)
    assert np.array_equal(nbrs.numpy(), adj[sel.reshape(-1)].reshape(B, E * M))


def test_gather_score_flat_negative_ids_clip_to_row0(rng):
    n, M, d, B, E = 50, 4, 16, 8, 2
    _, tt, _, _ = _tables(rng, n, M, d)
    q = torch.from_numpy(_unit(rng, (B, d))).to(torch.bfloat16)
    neg = nbr_score.gather_score_flat(tt, torch.full((B, E), -1, dtype=torch.int32), q, M=M, d=d)
    row0 = nbr_score.gather_score_flat(tt, torch.zeros((B, E), dtype=torch.int32), q, M=M, d=d)
    assert torch.equal(neg[0], row0[0]) and torch.equal(neg[1], row0[1])


def test_gather_score_flat_rejects_bad_inputs(rng):
    n, M, d = 20, 4, 16
    _, tt, _, _ = _tables(rng, n, M, d)
    q = torch.zeros((3, d), dtype=torch.bfloat16)
    sel = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="row_width"):
        nbr_score.gather_score_flat(tt, sel, torch.zeros((3, 40), dtype=torch.bfloat16), M=M, d=40)
    with pytest.raises(ValueError, match="sel_ids"):
        nbr_score.gather_score_flat(tt, torch.zeros((2, 3), dtype=torch.int32).T, q, M=M, d=d)
    with pytest.raises(ValueError, match="q must"):
        nbr_score.gather_score_flat(tt, sel, q.float(), M=M, d=d)


def test_cuda_tensor_raises_without_fallback(rng, monkeypatch):
    """On a CPU-only torch a CUDA tensor goes to the kernel, whose build
    fails: the wrapper raises and never runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("needs a torch without CUDA")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(nbr_score, "gather_score_flat_reference", no_fallback)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR.parent / "no_such_build_dir_for_test")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    before = nbr_score.gather_score_flat.launches
    M, d = 4, 16
    with FakeTensorMode():
        tab = torch.zeros((10, nbr_cache.row_width(M, d)), dtype=torch.int16, device="cuda")
        sel = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
        q = torch.zeros((2, d), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            nbr_score.gather_score_flat(tab, sel, q, M=M, d=d)
    assert nbr_score.gather_score_flat.launches == before


def test_failed_nvcc_build_raises_with_its_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.compile_library([str(fake), *build.NVCC_FLAGS], build.CSRC_DIR / "nbr_score.cu", tmp_path / "out" / "libx.so")
    assert not (tmp_path / "out" / "libx.so").exists()
