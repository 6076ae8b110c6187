"""granne_tpu_torch's host serving (``native.serve.HostGranne``) and the rest
of its native binding, against granne_tpu on the same files.

The port builds one f32 and one int8 graph (n 500, d 25, M 16, ef 30: the
shapes of ``tests/test_native_serve.py``); each is written once by each
package, dense and compressed.  Both packages' ``HostGranne`` serve every
file: ids and distances must be equal, since the two C++ libraries are one
source built with one set of flags.
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu as J
from granne_tpu.index import io as jio
from granne_tpu.native import codec as jcodec
from granne_tpu.native.serve import HostGranne as JHostGranne
from granne_tpu_torch import AngularIntVectors, AngularVectors, BuildConfig, Granne, HostGranne, RwGranneBuilder
from granne_tpu_torch import build_layers
from granne_tpu_torch.index import io
from granne_tpu_torch.native import GXX_CMD, _SIGNATURES, codec, codec_source

REPO = Path(__file__).resolve().parents[1]
N, D = 500, 25
CFG = dict(num_neighbors=16, max_search=30)


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


def _jax_elements(el):
    if isinstance(el, AngularIntVectors):
        return J.AngularIntVectors.from_quantized(jnp.asarray(el.vectors.numpy()))
    return J.AngularVectors.from_normalized(jnp.asarray(el.vectors.numpy()))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{kind: (vecs, port Granne, {(writer, compressed): (index path, elements path)})}."""
    out = {}
    for kind, cls, seed in (("angular", AngularVectors, 3), ("angular_int", AngularIntVectors, 7)):
        vecs = np.random.default_rng(seed).standard_normal((N, D)).astype(np.float32)
        el = cls.from_raw(vecs, device="cpu")
        layers = build_layers(el, BuildConfig(**CFG))
        jlayers, jel = J.LayerStack.from_numpy(layers.as_numpy()), _jax_elements(el)
        base = tmp_path_factory.mktemp(kind)
        paths = {}
        for writer, save_index, save_elements, lay, els in (
            ("port", io.save_index, io.save_elements, layers, el),
            ("jax", jio.save_index, jio.save_elements, jlayers, jel),
        ):
            save_elements(els, str(base / f"{writer}.gt"))
            for compressed in (False, True):
                ipath = str(base / f"{writer}_{int(compressed)}.gtz")
                save_index(lay, ipath, compressed=compressed)
                paths[writer, compressed] = (ipath, str(base / f"{writer}.gt"))
        out[kind] = (vecs, Granne(layers=layers, elements=el), paths)
    return out


@pytest.mark.parametrize("kind", ["angular", "angular_int"])
def test_host_granne_equals_jax_host_granne(files, kind):
    """Both packages' HostGranne on files written by either package, dense
    and compressed: equal ids and distances; self top-1 recall > 0.95
    (test_native_serve's bar); compressed and dense agree as sets."""
    vecs, _, paths = files[kind]
    queries = np.random.default_rng(11).standard_normal((100, D)).astype(np.float32)
    for compressed in (False, True):
        port_bytes = [Path(p).read_bytes() for p in paths["port", compressed]]
        assert port_bytes == [Path(p).read_bytes() for p in paths["jax", compressed]]
        for writer in ("port", "jax"):
            h, jh = HostGranne(*paths[writer, compressed]), JHostGranne(*paths[writer, compressed])
            assert (h.num_elements, h.num_layers) == (N, jh.num_layers) == (jh.num_elements, jh.num_layers)
            for q, ef, k in ((vecs[:200], 20, 1), (queries, 30, 5)):
                ids, d = h.search_batch(q, ef, k)
                jids, jd = jh.search_batch(q, ef, k)
                assert ids.dtype == np.int32 and d.dtype == np.float32
                assert np.array_equal(ids, jids) and np.array_equal(d, jd)
            assert np.mean(h.search_batch(vecs[:200], 20, 1)[0][:, 0] == np.arange(200)) > 0.95
            assert h.search(vecs[3], 20, 3) == jh.search(vecs[3], 20, 3)
    dense, _ = HostGranne(*paths["port", False]).search_batch(queries, 20, 5)
    comp, _ = HostGranne(*paths["port", True]).search_batch(queries, 20, 5)
    assert sum(set(a) == set(b) for a, b in zip(dense.tolist(), comp.tolist())) >= 95


def test_host_threads_agree(files):
    for kind in ("angular", "angular_int"):
        vecs, _, paths = files[kind]
        for compressed in (False, True):
            h = HostGranne(*paths["port", compressed])
            one = h.search_batch(vecs[:100], 20, 5, num_threads=1)
            four = h.search_batch(vecs[:100], 20, 5, num_threads=4)
            assert np.array_equal(one[0], four[0]) and np.array_equal(one[1], four[1])


def test_host_granne_matches_port_search(files):
    """HostGranne against the port's own Granne on the CPU (same graph):
    top-5 overlap > 0.9, as test_native_serve holds the JAX package."""
    for kind in ("angular", "angular_int"):
        vecs, index, paths = files[kind]
        ids_h, _ = HostGranne(*paths["port", True]).search_batch(vecs[:50], 30, 5)
        ids_t, _ = index.search_batch(vecs[:50], 30, 5)
        overlap = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids_h.tolist(), ids_t.tolist())])
        assert overlap > 0.9, (kind, overlap)


def test_offsets_codec():
    rng = np.random.default_rng(0)
    offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 1000, 500))]).astype(np.uint64)
    enc = codec.encode_offsets_py(offsets)
    assert enc == jcodec.encode_offsets_py(offsets) == codec.encode_offsets(offsets)
    assert len(enc) < len(offsets) * 3  # ~2.1 bytes an offset (offsets.rs) against 8 raw
    assert np.array_equal(codec.decode_offsets_py(enc, len(offsets)), offsets)
    assert np.array_equal(codec.decode_offsets(enc, len(offsets)), offsets)
    assert np.array_equal(jcodec.decode_offsets_py(enc, len(offsets)), offsets)
    for i in (0, 59, 60, 61, 123, len(offsets) - 1):
        assert codec.offset_at(enc, i) == offsets[i]
    big = np.asarray([0, 100_000], np.uint64)  # a delta over u16
    assert codec.encode_offsets_py(big) == codec.encode_offsets(big) == jcodec.encode_offsets_py(big) == b""


def test_native_binds_every_function_with_jax_flags():
    """Every extern "C" function of the port's codec.cpp is bound, and the
    library is built with the JAX package's code-generation flags."""
    externs = re.findall(r'extern "C"\s+[\w\s\*]*?\b(gt_\w+)\s*\(', codec_source().read_text())
    assert len(externs) == 12 and set(externs) == set(_SIGNATURES)
    tree = ast.parse((REPO / "granne_tpu" / "native" / "__init__.py").read_text())
    build = next(f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef) and f.name == "_build")
    jax_cmd = [c.value for c in ast.walk(build) if isinstance(c, ast.Constant) and isinstance(c.value, str)]

    def codegen(cmd):
        return [f for f in cmd if f.startswith(("-O", "-m", "-f", "-std"))]

    assert codegen(GXX_CMD) == codegen(jax_cmd) == ["-O3", "-march=native", "-fPIC", "-std=c++17"]


def test_host_granne_outlives_rw_save(tmp_path):
    """save writes each file to a temporary name and moves it into place, so a
    HostGranne opened before an RwGranneBuilder save keeps its old maps."""
    vecs = np.random.default_rng(5).standard_normal((260, D)).astype(np.float32)
    rw = RwGranneBuilder(AngularVectors.from_raw(vecs[:200], device="cpu"), BuildConfig(num_neighbors=12, max_search=20))
    ipath, epath = str(tmp_path / "i.gtz"), str(tmp_path / "e.gt")
    rw.save(ipath, epath)
    old = HostGranne(ipath, epath)
    before = old.search_batch(vecs[:50], 20, 3)
    rw.insert_batch(vecs[200:])
    rw.save(ipath, epath)
    after = old.search_batch(vecs[:50], 20, 3)
    assert old.num_elements == 200 and np.array_equal(before[0], after[0]) and np.array_equal(before[1], after[1])
    assert np.mean(before[0][:, 0] == np.arange(50)) > 0.95
    new = HostGranne(ipath, epath)
    assert new.num_elements == 260
    assert np.mean(new.search_batch(vecs, 20, 1)[0][:, 0] == np.arange(260)) > 0.95
