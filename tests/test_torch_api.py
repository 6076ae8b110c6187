"""granne_tpu_torch public API against granne_tpu: the user flow, files
shared by both packages, and the end-to-end slice (build f32, serve bf16
through the flat neighbor cache).  One JAX build per file (module fixture).
"""

import doctest
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index import io as jio
from granne_tpu_torch import AngularVectors, GranneBuilder, compute_distance, convert, load_granne
from granne_tpu_torch import api
from granne_tpu_torch.index import io
from granne_tpu_torch.index.granne import Granne

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NQ, K = 2000, 32, 256, 10
CFG = dict(num_neighbors=12, max_search=32)


@pytest.fixture(scope="module")
def data():
    """Clustered data and held-out queries, as bench.py makes them, small."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((40, D)).astype(np.float32)
    vecs = (centers[rng.integers(0, 40, N)] + 0.35 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (centers[rng.integers(0, 40, NQ)] + 0.35 * rng.standard_normal((NQ, D))).astype(np.float32)
    return vecs, queries


@pytest.fixture(scope="module")
def jax_index(data):
    vecs, _ = data
    el = J.AngularVectors.from_raw(vecs)
    return J.Granne(layers=J.build_layers(el, J.BuildConfig(**CFG)), elements=el)


def _recall(ids, queries, vecs):
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ vn.T), axis=1)[:, :K]
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(np.asarray(ids), gt)]))


def test_module_doctest():
    result = doctest.testmod(api)
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("compressed", [False, True])
def test_index_files_shared_with_jax(jax_index, tmp_path, compressed):
    jpath, tpath = str(tmp_path / "j.gtz"), str(tmp_path / "t.gtz")
    jio.save_index(jax_index.layers, jpath, compressed=compressed)
    loaded = io.load_index(jpath, device="cpu")
    want = jio.load_index(jpath).as_numpy()  # compressed rows come back sorted
    assert loaded.counts == jax_index.layers.counts
    assert all(np.array_equal(a, b) for a, b in zip(loaded.as_numpy(), want))
    # the same graph saved by the port is the same file, and JAX reads it back
    io.save_index(convert.layers_from_numpy(jax_index.layers.as_numpy(), device="cpu"), tpath, compressed=compressed)
    assert (tmp_path / "t.gtz").read_bytes() == (tmp_path / "j.gtz").read_bytes()
    assert io.read_index_metadata(tpath) == jio.read_index_metadata(jpath)
    assert all(np.array_equal(a, b) for a, b in zip(jio.load_index(tpath).as_numpy(), want))


def test_element_files_shared_with_jax(jax_index, tmp_path):
    jpath, tpath = str(tmp_path / "j.gt"), str(tmp_path / "t.gt")
    jio.save_elements(jax_index.elements, jpath)
    loaded = io.load_elements(jpath, device="cpu")
    assert np.array_equal(loaded.vectors.numpy(), np.asarray(jax_index.elements.vectors))
    io.save_elements(loaded, tpath)
    assert (tmp_path / "t.gt").read_bytes() == (tmp_path / "j.gt").read_bytes()
    assert np.array_equal(np.asarray(jio.load_elements(tpath).vectors), loaded.vectors.numpy())
    # from a bytes buffer too
    assert torch.equal(io.load_elements((tmp_path / "j.gt").read_bytes(), device="cpu").vectors, loaded.vectors)


def test_end_to_end_slice_matches_jax(data, jax_index, tmp_path):
    """append -> build -> save -> load -> bf16 + flat cache -> search_batch:
    self-query top-1 >= 0.95, and recall@10 within 0.02 of the JAX package
    serving the same data the same way."""
    vecs, queries = data
    b = GranneBuilder("angular", wave_size=256, device="cpu", **CFG)
    for lo in range(0, N, 500):
        b.append(vecs[lo : lo + 500])
    b.build()
    assert [b.layer_len(i) for i in range(b.num_layers)] == list(jax_index.layers.counts)
    b.save_index(str(tmp_path / "i.gtz"))
    b.save_elements(str(tmp_path / "e.gt"))
    idx = load_granne(str(tmp_path / "i.gtz"), str(tmp_path / "e.gt"), device="cpu")
    serve = Granne(layers=idx.layers, elements=idx.elements.as_bf16()).with_neighbor_cache("flat")

    ids, d = serve.search_batch(vecs[:500], max_search=32, num_neighbors=1)
    assert float(np.mean(ids[:, 0].numpy() == np.arange(500))) >= 0.95
    ids, d = serve.search_batch(queries, max_search=32, num_neighbors=K)
    assert ids.shape == (NQ, K) and torch.isfinite(d).all()

    jserve = J.Granne(layers=jax_index.layers, elements=jax_index.elements.as_bf16()).with_neighbor_cache("flat")
    jids, _ = jserve.search_batch(jnp.asarray(queries), max_search=32, num_neighbors=K)
    port_recall, jax_recall = _recall(ids.numpy(), queries, vecs), _recall(jids, queries, vecs)
    assert port_recall > 0.9
    assert abs(port_recall - jax_recall) <= 0.02, (port_recall, jax_recall)


def test_resume_from_jax_files(data, tmp_path):
    """A partial index saved by the JAX package resumes in the port."""
    vecs, _ = data
    vecs = vecs[:400]
    jb = J.GranneBuilder("angular", expected_num_elements=400, **CFG)
    jb.append(vecs)
    jb.build(200)
    jb.save_index(str(tmp_path / "i.gtz"))
    jb.save_elements(str(tmp_path / "e.gt"))
    b = GranneBuilder.from_index(
        str(tmp_path / "i.gtz"), str(tmp_path / "e.gt"), device="cpu", expected_num_elements=400, **CFG
    )
    assert b.indexed_elements == 200 and len(b) == 400
    b.build()
    assert b.indexed_elements == 400
    hits = [b.search(vecs[i], 32, 1)[0][0] == i for i in range(0, 400, 7)]
    assert np.mean(hits) > 0.93


def test_snapshot_survives_later_build(rng):
    vecs = rng.standard_normal((300, 12)).astype(np.float32)
    b = GranneBuilder("angular", num_neighbors=8, max_search=16, expected_num_elements=300, device="cpu")
    b.append(vecs)
    b.build(150)
    snap = b.get_index()
    before = [a.clone() for a in snap.layers.layers]
    res = snap.search(vecs[3], 16, 3)
    b.build()
    assert all(torch.equal(a, c) for a, c in zip(snap.layers.layers, before))
    assert snap.search(vecs[3], 16, 3) == res and len(b.get_index()) == 300


def test_builder_surface(rng, tmp_path):
    vecs = rng.standard_normal((120, 10)).astype(np.float32)
    b = GranneBuilder("angular", num_neighbors=8, max_search=16, device="cpu")
    assert b.search(vecs[0]) == [] and b.num_layers == 0
    b.append(vecs[0])
    with pytest.raises(ValueError, match="dimension mismatch"):
        b.append(np.zeros(11, np.float32))
    b.append(vecs[1:])
    b.build()
    assert len(b) == 120 and b.indexed_elements == 120
    assert np.allclose(b.get_element(42), vecs[42] / np.linalg.norm(vecs[42]), atol=1e-6)
    with pytest.raises(IndexError):
        b.get_element(120)
    assert b.get_neighbors(0, b.num_layers - 1) and all(0 <= x < 120 for x in b.get_neighbors(5, b.num_layers - 1))
    with pytest.raises(ValueError, match="not ported"):
        GranneBuilder("angular_int", device="cpu")


def test_compute_distance_and_bad_files(rng, tmp_path):
    a, b = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    want = max(0.0, 1 - float((a / np.linalg.norm(a)) @ (b / np.linalg.norm(b))))
    assert abs(compute_distance("angular", a, b, device="cpu") - want) < 1e-5
    assert abs(compute_distance("angular", a, b, device="cpu") - J.compute_distance("angular", a, b)) < 1e-6
    bad = tmp_path / "bad"
    bad.write_bytes(b"not-a-granne-file" + b"\x00" * 2000)
    with pytest.raises(ValueError, match="bad magic"):
        io.load_index(str(bad), device="cpu")
    i8 = tmp_path / "i8.gt"
    jio.save_elements(J.AngularIntVectors.from_raw(rng.standard_normal((5, 4)).astype(np.float32)), str(i8))
    with pytest.raises(ValueError, match="not ported"):
        io.load_elements(str(i8), device="cpu")
    with pytest.raises(TypeError, match="unsupported"):
        io.save_elements(object(), str(tmp_path / "x.gt"))


def test_port_import_pulls_in_no_jax(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "import granne_tpu_torch as g\n"
        "b = g.GranneBuilder('angular', num_neighbors=4, max_search=8, device='cpu')\n"
        "b.append(np.random.default_rng(0).standard_normal((40, 4)).astype(np.float32))\n"
        "b.build()\n"
        f"b.save_index({str(tmp_path / 'i.gtz')!r}, compressed=True)\n"
        "assert 'jax' not in sys.modules and 'granne_tpu' not in sys.modules, sorted(sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_device_is_explicit():
    """Nothing picks the CPU by itself: the default device is CUDA."""
    if torch.cuda.is_available():
        pytest.skip("needs a torch without CUDA")
    with pytest.raises((AssertionError, RuntimeError)):
        AngularVectors.from_raw(np.ones((2, 3), np.float32))
    b = GranneBuilder("angular")
    b.append(np.ones(3, np.float32))
    with pytest.raises((AssertionError, RuntimeError)):
        b.elements
