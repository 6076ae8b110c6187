"""K3/K4/K5's plain PyTorch versions (granne_tpu_torch/ops/kernels/ivf_score.py)
against the Pallas kernels of granne_tpu/ops/pallas/ivf_score.py.

The Pallas kernels run interpreted on the CPU; the port's wrappers run their
plain versions for CPU tensors (the CUDA kernels are checked on the card by
tests/test_torch_cuda.py).  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granne_tpu.ops import distance as jdist
from granne_tpu.ops.pallas import ivf_score as jscore
from granne_tpu_torch import convert
from granne_tpu_torch.ops.kernels import build
from granne_tpu_torch.ops.kernels import ivf_score as K


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


def _kernel_inputs(rng, dtype, k=6, L=16, d=32, S=12, cap=8):
    rows = rng.standard_normal((k, L, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    ids = np.arange(k * L, dtype=np.int32).reshape(k, L)
    ids[:, -3:] = -1
    scales = np.ones((k, L), np.float32)
    if dtype == "int8":
        jb = jdist.quantize_i8(jnp.asarray(rows))
        scales = np.asarray(jdist.inv_norms_i8(jb))
    else:
        jb = jnp.asarray(rows, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    keys = rng.integers(0, k, S).astype(np.int32)
    qg = rng.standard_normal((S, cap, d)).astype(np.float32)
    qg /= np.linalg.norm(qg, axis=-1, keepdims=True)
    jq = jnp.asarray(qg, jnp.bfloat16)
    tb = convert._tensor(np.asarray(jb), "cpu")
    tq = convert._tensor(np.asarray(jq), "cpu")
    return jb, jq, ids, scales, keys, tb, tq


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
def test_ivf_score_plain_matches_pallas(rng, dtype):
    """Plain K3/K4 vs the Pallas kernels (interpreted) within 1e-5 on the
    cosine scale (the Pallas K3/K4 take bf16 blocks: f32 and int8 blocks
    are rounded to bf16 first, as ivf.py's einsum route does); plain K5 vs
    the Pallas K5: values within 1e-5, ids equal (the data has no near-ties:
    checked)."""
    jb, jq, ids, scales, keys, tb, tq = _kernel_inputs(rng, dtype)
    row_scale = scales[keys][:, None, :]
    want = np.asarray(jscore.ivf_score_slots(jb.astype(jnp.bfloat16), jnp.asarray(keys), jq, interpret=True))
    want_g = np.asarray(
        jscore.ivf_score_slots_grouped(jb.astype(jnp.bfloat16), jnp.asarray(keys), jq, group=5, interpret=True)
    )
    for got in (K.ivf_score_slots(tb, _t(keys), tq), K.ivf_score_slots_grouped(tb, _t(keys), tq, group=5)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy() * row_scale, want * row_scale, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy() * row_scale, want_g * row_scale, rtol=0, atol=1e-5)

    for k_out in (5, 20):  # 20 > L: (-inf, -1) padding
        jv, ji = jscore.ivf_score_topk(
            jb, jnp.asarray(ids), jnp.asarray(scales), jnp.asarray(keys), jq, k_out=k_out, interpret=True
        )
        jv, ji = np.asarray(jv), np.asarray(ji)
        fin = np.isfinite(jv)
        gaps = np.abs(np.diff(jv, axis=-1)) <= 1e-5  # neighbours within the value tolerance
        near = np.zeros_like(fin)
        near[..., 1:] |= gaps
        near[..., :-1] |= gaps
        assert near.mean() < 0.02  # the draw is nearly free of near-ties
        tv, ti = K.ivf_score_topk(tb, _t(ids), _t(scales), _t(keys), tq, k_out=k_out)
        assert tv.shape == (12, 8, k_out) and ti.dtype == torch.int32
        assert np.array_equal(np.isfinite(tv.numpy()), fin)
        np.testing.assert_allclose(tv.numpy()[fin], jv[fin], rtol=0, atol=1e-5)
        assert np.array_equal(ti.numpy()[~near], ji[~near])
        assert np.array_equal(ti.numpy()[~fin], ji[~fin])


def test_ivf_score_topk_ties_take_the_lower_column(rng):
    """Exactly duplicated rows tie; the plain K5 and the Pallas K5 both
    rank the lower column first."""
    jb, jq, ids, scales, keys, tb, tq = _kernel_inputs(rng, "bf16")
    b = np.array(jb.astype(jnp.float32))
    b[keys[0], 9] = b[keys[0], 2]
    b[keys[0], 4] = b[keys[0], 2]
    q = np.array(jq.astype(jnp.float32))
    q[0, 0] = b[keys[0], 2]
    jb, jq = jnp.asarray(b, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
    tb, tq = _t(b).to(torch.bfloat16), _t(q).to(torch.bfloat16)
    _, ji = jscore.ivf_score_topk(jb, jnp.asarray(ids), jnp.asarray(scales), jnp.asarray(keys), jq, k_out=4, interpret=True)
    _, ti = K.ivf_score_topk(tb, _t(ids), _t(scales), _t(keys), tq, k_out=4)
    want = ids[keys[0], [2, 4, 9]]
    assert np.array_equal(np.asarray(ji)[0, 0, :3], want) and np.array_equal(ti.numpy()[0, 0, :3], want)


@pytest.mark.parametrize("which", ["slots", "grouped", "topk", "pairs"])
def test_cuda_tensor_raises_without_fallback(monkeypatch, which):
    """On a CPU-only torch a CUDA tensor goes to the kernel, whose build
    fails: the wrapper raises and never runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("needs a torch without CUDA")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(K, "ivf_score_slots_reference", no_fallback)
    monkeypatch.setattr(K, "ivf_score_topk_reference", no_fallback)
    monkeypatch.setattr(K, "ivf_score_pairs_reference", no_fallback)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR.parent / "no_such_build_dir_for_test")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    fn = {"slots": K.ivf_score_slots, "grouped": K.ivf_score_slots_grouped, "topk": K.ivf_score_topk,
          "pairs": K.ivf_score_pairs}[which]
    before = fn.launches
    with FakeTensorMode():
        blocks = torch.zeros((4, 8, 16), dtype=torch.bfloat16, device="cuda")
        keys = torch.zeros((3,), dtype=torch.int32, device="cuda")
        qg = torch.zeros((3, 2, 16), dtype=torch.bfloat16, device="cuda")
        ids = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
        sc = torch.ones((4, 8), dtype=torch.float32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            if which == "topk":
                fn(blocks, ids, sc, keys, qg, k_out=3)
            elif which == "pairs":
                pairs = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
                fn(blocks, ids, sc, keys, qg, pairs, torch.zeros((6, 8), dtype=torch.float32, device="cuda"))
            else:
                fn(blocks, keys, qg)
    assert fn.launches == before
