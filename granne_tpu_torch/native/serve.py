"""Host (CPU) serving: granne's memory-mapped deployment (port of
``granne_tpu/native/serve.py``).

``HostGranne`` serves the files that ``index/io.py`` writes from CPU
threads, with the C++ search of ``csrc/codec.cpp``: the reference's primary
deployment mode (mmap the index and the elements, serve from CPU processes,
``src/lib.rs:16-23``).  It is a host entry point by design, not a fallback
for the card, and it uploads nothing to torch:

* layers are served in place from the memory-mapped index file (the
  reference's ``FileOrMemoryLayers::File``, ``src/index/mod.rs:122-135``):
  a compressed layer decodes each visited row in C++ (its chunk-compressed
  row offsets are read in place), a dense one is read as ``int32[rows, M]``;
* elements are f32 ``angular`` or int8 ``angular_int`` (``i1``) files, also
  memory-mapped, both advised for random access.

Queries are prepared in numpy exactly as the JAX package's ``HostGranne``
prepares them (f32 normalisation; for int8, max-abs truncation to codes and
f32 reciprocal norms), so both packages hand the C++ code the same bytes.
It is also ``bench.py``'s single-core granne baseline.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..index import io as gio
from . import get_lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _inv_norms_i8(codes: np.ndarray) -> np.ndarray:
    """f32 reciprocal row norms of int8 codes: an f32 square root of the
    exact integer sum of squares, 0 for a zero row."""
    v32 = np.asarray(codes, np.int32)
    norms = np.sqrt(np.sum(v32 * v32, axis=1).astype(np.float32))
    return np.where(norms > 0.0, 1.0 / np.where(norms > 0.0, norms, 1.0), 0.0).astype(np.float32)


class HostGranne:
    """CPU-served index over the files of ``save_index``/``save_elements``."""

    def __init__(self, index_path: str, elements_path: str):
        self._lib = get_lib()
        meta = gio.read_index_metadata(index_path)
        emeta = gio.read_elements_metadata(elements_path)
        kinds = {"angular": "<f4", "angular_int": "i1"}
        self._elem_kind = emeta["type"]
        if self._elem_kind not in kinds:
            raise TypeError(f"HostGranne serves f32 angular or int8 elements, not {self._elem_kind!r}")
        self._vectors = np.memmap(
            elements_path, dtype=kinds[self._elem_kind], mode="r", offset=gio.METADATA_LEN,
            shape=(emeta["count"], emeta["dim"]),
        )
        gio._madvise_random(self._vectors)
        self._inv_norms = _inv_norms_i8(self._vectors) if self._elem_kind == "angular_int" else None
        self.num_layers = meta["num_layers"]
        self.num_elements = meta["num_elements"]
        self._compressed = bool(meta.get("compressed"))
        self._width = meta["num_neighbors"]
        # one map per layer, advised for random access (mod.rs:122-135)
        self._layers = []
        offset = gio.METADATA_LEN
        for count, size in zip(meta["layer_counts"], meta["layer_sizes"]):
            buf = np.memmap(index_path, dtype=np.uint8, mode="r", offset=offset, shape=(size,))
            gio._madvise_random(buf)
            self._layers.append(buf if self._compressed else buf.view("<i4").reshape(count, self._width))
            offset += size

    def _prepare_queries(self, queries):
        """Queries in the element space: unit f32 rows, or int8 codes and
        their f32 reciprocal norms (``AngularIntVectors.prepare_queries``)."""
        q = np.asarray(queries, np.float32)
        if self._elem_kind == "angular":
            norms = np.sqrt(np.sum(q * q, axis=1, keepdims=True))
            q = np.where(norms > 0.0, q / np.where(norms > 0.0, norms, 1.0), q)
            return np.ascontiguousarray(q), None
        max_abs = np.max(np.abs(q), axis=1, keepdims=True)
        denom = np.where(max_abs > 0.0, max_abs, 127.0)
        qi = np.trunc(q * 127.0 / denom).astype(np.int8)
        return np.ascontiguousarray(qi), np.ascontiguousarray(_inv_norms_i8(qi))

    def search_batch(self, queries, max_search: int = 200, num_neighbors: int = 10, num_threads: int = 1):
        """Raw f32 [B, d] queries -> (ids int32[B, k], dists f32[B, k]) numpy
        arrays, nearest first, padded with -1; ``num_threads`` CPU threads."""
        q, q_inv = self._prepare_queries(queries)
        nq, k = q.shape[0], num_neighbors
        out_ids = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        n, d = self._vectors.shape
        ptrs = (ctypes.c_void_p * len(self._layers))(*[a.ctypes.data for a in self._layers])
        if self._compressed:
            lens = np.asarray([a.size for a in self._layers], np.uint64)
            graph = [ptrs, _ptr(lens), len(self._layers)]
        else:
            graph = [ptrs, len(self._layers), self._width]
        tail = [nq, max_search, k, num_threads, _ptr(out_ids), _ptr(out_d)]
        if self._elem_kind == "angular":
            search = self._lib.gt_search_compressed if self._compressed else self._lib.gt_search_f32
            search(_ptr(self._vectors), n, d, *graph, _ptr(q), *tail)
        else:
            search = self._lib.gt_search_compressed_i8 if self._compressed else self._lib.gt_search_i8
            search(_ptr(self._vectors), _ptr(self._inv_norms), n, d, *graph, _ptr(q), _ptr(q_inv), *tail)
        return out_ids, out_d

    def search(self, element, max_search: int = 200, num_neighbors: int = 10):
        """Single-query search returning [(id, dist)], nearest first."""
        ids, d = self.search_batch(np.asarray(element)[None], max_search, num_neighbors)
        return [(int(i), float(x)) for i, x in zip(ids[0], d[0]) if i >= 0]
