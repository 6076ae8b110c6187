"""The ops under granne_tpu_torch's IVF search against granne_tpu's: int8
codes (``ops/distance.py``) and probe grouping (``ops/segment.py``), both
exact, so compared bit for bit on the same numpy inputs (fixed seeds); and
the input checks of the slot-scoring wrappers (``ops/kernels/ivf_score.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granne_tpu.ops import distance as jdist
from granne_tpu.ops import segment as jseg
from granne_tpu_torch.ops import distance, segment
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


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_quantize_i8_bit_equal_to_jax(rng, rounding):
    """Codes bit-equal; inverse norms within 1e-7."""
    x = rng.standard_normal((300, 37)).astype(np.float32)
    x[4] = 0.0  # a zero row stays zero
    x[5, 3] = 1e-30
    xn = np.asarray(jdist.normalize(jnp.asarray(x)))
    want = np.asarray(jdist.quantize_i8(jnp.asarray(xn), rounding))
    got = distance.quantize_i8(_t(xn), rounding)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        distance.inv_norms_i8(got).numpy(), np.asarray(jdist.inv_norms_i8(jnp.asarray(want))), rtol=0, atol=1e-7
    )
    assert float(distance.inv_norms_i8(got)[4]) == 0.0
    with pytest.raises(ValueError, match="rounding"):
        distance.quantize_i8(_t(xn), "floor")


@pytest.mark.parametrize(
    "case", ["random-with-invalid", "hot-key-spills", "too-few-slots", "all-invalid"]
)
def test_group_pairs_bit_equal_to_jax(rng, case):
    """All six outputs bit-equal to JAX's."""
    P, cap, num_slots = 200, 8, 64
    keys = rng.integers(-1, 30, P).astype(np.int32)
    if case == "hot-key-spills":
        keys[rng.random(P) < 0.4] = 7  # ~80 items on one key: ten slots of 8
    if case == "too-few-slots":
        num_slots = 9
    if case == "all-invalid":
        keys[:] = -1
    vals = rng.permutation(P).astype(np.int32)
    got = segment.group_pairs(_t(keys), _t(vals), cap=cap, num_slots=num_slots)
    want = jseg.group_pairs(jnp.asarray(keys), jnp.asarray(vals), cap=cap, num_slots=num_slots)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    if case == "too-few-slots":
        assert int((got[2] < 0).sum()) > int((keys < 0).sum())  # items past the last slot are dropped


def test_ivf_score_rejects_bad_inputs():
    """K3/K4/K5's and the pair store's wrappers check dtypes, shapes and the
    group size before anything runs, on any device."""
    blocks = torch.zeros((6, 16, 32), dtype=torch.bfloat16)
    keys = torch.zeros((12,), dtype=torch.int32)
    qg = torch.zeros((12, 8, 32), dtype=torch.bfloat16)
    ids = torch.zeros((6, 16), dtype=torch.int32)
    scales = torch.ones((6, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="qg must"):
        K.ivf_score_slots(blocks, keys, qg.float())
    with pytest.raises(ValueError, match="slot_keys"):
        K.ivf_score_slots_grouped(blocks, keys.long(), qg)
    with pytest.raises(ValueError, match="blocks must"):
        K.ivf_score_slots(blocks.to(torch.float16), keys, qg)
    with pytest.raises(ValueError, match="block_ids"):
        K.ivf_score_topk(blocks, ids[:, :3].contiguous(), scales, keys, qg, k_out=3)
    with pytest.raises(ValueError, match="group"):
        K.ivf_score_slots_grouped(blocks, keys, qg, group=0)
    pairs = torch.full((12, 8), -1, dtype=torch.int32)
    out = torch.zeros((40, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="slot_pairs"):
        K.ivf_score_pairs(blocks, ids, scales, keys, qg, pairs[:, :5], out)
    with pytest.raises(ValueError, match="slot_pairs"):
        K.ivf_score_pairs(blocks, ids, scales, keys, qg, pairs.long(), out)
    with pytest.raises(ValueError, match="out must"):
        K.ivf_score_pairs(blocks, ids, scales, keys, qg, pairs, out[:, :8])
    with pytest.raises(ValueError, match="out must"):
        K.ivf_score_pairs(blocks, ids, scales, keys, qg, pairs, out.to(torch.bfloat16))
    with pytest.raises(ValueError, match="block_scales"):
        K.ivf_score_pairs(blocks, ids, scales.double(), keys, qg, pairs, out)
    with pytest.raises(ValueError, match="group"):
        K.ivf_score_pairs(blocks, ids, scales, keys, qg, pairs, out, group=0)


def test_pair_store_launch_refuses_a_misaligned_out():
    """The pair store's launch refuses an ``out`` that does not start on an
    8-byte boundary (its rows take float2 stores) before it touches the
    library: a contiguous [P, L] view one float into a buffer passes the
    wrapper's shape checks but not this one."""
    blocks = torch.zeros((6, 16, 32), dtype=torch.bfloat16)
    keys = torch.zeros((12,), dtype=torch.int32)
    qg = torch.zeros((12, 8, 32), dtype=torch.bfloat16)
    ids = torch.zeros((6, 16), dtype=torch.int32)
    scales = torch.ones((6, 16), dtype=torch.float32)
    pairs = torch.full((12, 8), -1, dtype=torch.int32)
    out = torch.zeros(40 * 16 + 1, dtype=torch.float32)[1:].view(40, 16)
    assert out.is_contiguous() and out.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="8-byte boundary"):
        K.launch_pairs(None, blocks, ids, scales, keys, qg, pairs, out, 8)
