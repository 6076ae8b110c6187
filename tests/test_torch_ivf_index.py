"""granne_tpu_torch's IVF index construction (index/ivf.py) against
granne_tpu's: the block layout, the files and ``append``.

The same numpy inputs (fixed seeds) go to both packages on the CPU.  Given
one k-means result, the layout is bit-identical, and so are the files
(in both directions) and the appended index.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
import granne_tpu.ops.kmeans as jkmeans
from granne_tpu_torch import IvfIndex, convert
from granne_tpu_torch.index import ivf
from granne_tpu_torch.ops import kmeans


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


def _clustered(rng, n, d, c=30, sigma=0.3):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return (centers[rng.integers(0, c, n)] + sigma * rng.standard_normal((n, d))).astype(np.float32)


def _exactly_normalizable(rng, n, d=32):
    """Rows of 16 entries of +-1 (norm exactly 4) times a power of two, so
    both packages normalize them to the same bits (+-0.25)."""
    x = np.zeros((n, d), np.float32)
    for i in range(n):
        x[i, rng.choice(d, 16, replace=False)] = rng.choice([-1.0, 1.0], 16)
    return x * (2.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)


def _jax_to_port(j) -> IvfIndex:
    return convert.ivf_from_numpy(
        np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids), np.asarray(j.block_scales),
        j.n_total, device="cpu",
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_build_layout_bit_identical_given_the_same_kmeans(rng, monkeypatch, dtype):
    """With one (centroids, assignment) handed to both, blocks, ids,
    centroids and scales are bit-identical; a cluster larger than L spans
    several blocks with duplicated centroid rows."""
    x = _exactly_normalizable(rng, 700)
    cent = rng.standard_normal((9, 32)).astype(np.float32)
    assign = rng.integers(0, 9, 700).astype(np.int32)
    assign[:150] = 3  # one cluster of >= 150 members: at least 3 blocks of 56
    assign[assign == 7] = 0  # one empty cluster: still one block
    monkeypatch.setattr(jkmeans, "train_kmeans", lambda *a, **k: (jnp.asarray(cent), jnp.asarray(assign)))
    monkeypatch.setattr(kmeans, "train_kmeans", lambda *a, **k: (_t(cent), _t(assign)))
    j = jivf.IvfIndex.build(x, n_clusters=9, cluster_cap=52, dtype=dtype)
    t = IvfIndex.build(x, n_clusters=9, cluster_cap=52, dtype=dtype, device="cpu")
    assert t.cluster_cap == 56 and t.k == j.k
    assert np.array_equal(t.centroids.numpy(), np.asarray(j.centroids))
    assert np.array_equal(t.block_ids.numpy(), np.asarray(j.block_ids))
    assert np.array_equal(t.block_scales.numpy(), np.asarray(j.block_scales))
    jb = np.asarray(j.blocks)
    if dtype == "bfloat16":
        jb, tb = jb.view(np.int16), t.blocks.view(torch.int16).numpy()
    else:
        tb = t.blocks.numpy()
    assert t.blocks.dtype == ivf._DTYPES[dtype] and np.array_equal(tb, jb)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_save_load_byte_identical_both_ways(rng, tmp_path, dtype):
    j = jivf.IvfIndex.build(_clustered(rng, 600, 16), n_clusters=8, kmeans_iters=2, cluster_cap=48, dtype=dtype)
    jpath, tpath, back = (str(tmp_path / f) for f in ("j.ivf", "t.ivf", "back.ivf"))
    j.save(jpath)
    t = IvfIndex.load(jpath, device="cpu")  # JAX file -> port
    assert t.blocks.dtype == ivf._DTYPES[dtype] and t.n_total == 600
    t.save(tpath)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    jt = jivf.IvfIndex.load(tpath)  # port file -> JAX
    jt.save(back)
    assert filecmp.cmp(jpath, back, shallow=False)
    conv = _jax_to_port(j)
    for a, b in ((t.blocks, conv.blocks), (t.block_ids, conv.block_ids), (t.block_scales, conv.block_scales)):
        assert torch.equal(a, b)


def test_append_matches_jax(rng):
    """Appending the same vectors to the same index: bit-identical
    centroids, blocks, ids and scales (fill-before-spill and the new
    spill blocks alike), for bf16 and int8 storage."""
    base = _exactly_normalizable(rng, 500)
    new = _exactly_normalizable(rng, 260)
    new[:120] = base[:120] * 2.0  # near an existing cluster: fills, then spills
    for dtype in ("bfloat16", "int8"):
        j = jivf.IvfIndex.build(base, n_clusters=8, kmeans_iters=3, cluster_cap=40, dtype=dtype)
        ja = j.append(new)
        ta = _jax_to_port(j).append(new)
        assert ta.n_total == ja.n_total == 760
        want = _jax_to_port(ja)
        assert ta.k > j.k  # some run spilled into fresh blocks
        for name in ("centroids", "block_ids", "block_scales"):
            assert torch.equal(getattr(ta, name), getattr(want, name)), name
        assert torch.equal(ta.blocks.view(torch.int16) if dtype == "bfloat16" else ta.blocks,
                           want.blocks.view(torch.int16) if dtype == "bfloat16" else want.blocks)
    with pytest.raises(ValueError, match="dimension mismatch"):
        ta.append(np.ones((2, 5), np.float32))
