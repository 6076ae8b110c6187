"""Index + element serialization (port of ``granne_tpu/index/io.py``).

The files are the JAX package's, byte for byte: a 1024-byte metadata block
(ASCII magic + JSON) followed by the layers back to back, dense ``<i4`` or
compressed by the shared C++ codec; elements are a separate file with the
same metadata block and a dense matrix: ``<f4`` for ``"angular"``, the
int8 codes (``i1``) for ``"angular_int"``.  An int8 file does not record the
container's ``rounding``, as in the JAX package: a loaded container extends
with truncated codes.  ``"embeddings"`` (``SumEmbeddings``) files hold the
term lists as CSR (the chunk-compressed offset table, or raw ``<u8``
offsets when a row holds more than 65,535 terms, then the 3-byte term ids)
followed by the ``<f4`` embedding table.  Writes go to ``path.tmp`` and are
moved into place with ``os.replace``.
"""

from __future__ import annotations

import json
import mmap as _mmap
import os

import numpy as np
import torch

from .graph import LayerStack

MAGIC = b"granne-tpu"
ELEMENTS_MAGIC = b"granne-tpu-elements"
METADATA_LEN = 1024
LIBRARY_VERSION = "0.1.0"
SERIALIZATION_VERSION = 1

_WRITE_CHUNK_BYTES = 256 << 20  # bound host memory while streaming a matrix out


def _madvise_random(arr: np.memmap) -> None:
    """Advise the kernel that reads of ``arr``'s map are random (the
    reference's madvise(Random), src/index/mod.rs:123-124): readahead is
    wasted on the row gathers of a graph search.  Best effort: not every
    platform has madvise."""
    try:
        arr._mmap.madvise(_mmap.MADV_RANDOM)
    except (AttributeError, ValueError, OSError):
        pass


class _Source:
    """A file path or an in-memory buffer, read through one interface."""

    def __init__(self, path_or_buf):
        if isinstance(path_or_buf, (str, os.PathLike)):
            self._path, self._buf = os.fspath(path_or_buf), None
        else:
            self._path, self._buf = None, memoryview(path_or_buf)

    def head(self, size: int) -> bytes:
        if self._buf is not None:
            return bytes(self._buf[:size])
        with open(self._path, "rb") as f:
            return f.read(size)

    def region(self, dtype, offset: int, shape) -> np.ndarray:
        count = int(np.prod(shape))
        if self._buf is not None:
            return np.frombuffer(self._buf, dtype=dtype, count=count, offset=offset).reshape(shape)
        return np.memmap(self._path, dtype=dtype, mode="r", offset=offset, shape=tuple(shape))

    def bytes_at(self, offset: int, size: int) -> bytes:
        if self._buf is not None:
            return bytes(self._buf[offset : offset + size])
        with open(self._path, "rb") as f:
            f.seek(offset)
            return f.read(size)


def _write_metadata(f, magic: bytes, meta: dict) -> None:
    blob = magic + json.dumps(meta).encode("utf-8")
    if len(blob) > METADATA_LEN:
        raise ValueError("metadata too large")
    f.write(blob + b"\x00" * (METADATA_LEN - len(blob)))


def _read_metadata(buf: bytes, magic: bytes) -> dict:
    if buf[: len(magic)] != magic:
        raise ValueError(f"invalid file: bad magic (expected {magic!r})")
    return json.loads(buf[len(magic) : METADATA_LEN].rstrip(b"\x00").decode("utf-8"))


# ---------------------------------------------------------------------------
# Index (layer stack)
# ---------------------------------------------------------------------------


def save_index(layers: LayerStack, path: str, compressed: bool = False) -> None:
    """Write the layer stack."""
    arrays = layers.as_numpy()
    if compressed:
        from ..native import codec

        payloads = [codec.encode_adjacency(a) for a in arrays]
    else:
        payloads = [np.ascontiguousarray(a, dtype="<i4").tobytes() for a in arrays]
    meta = {
        "granne_tpu_version": LIBRARY_VERSION,
        "version": SERIALIZATION_VERSION,
        "num_elements": layers.num_elements,
        "num_layers": len(arrays),
        "num_neighbors": layers.num_neighbors,
        "layer_counts": [int(a.shape[0]) for a in arrays],
        "layer_sizes": [len(p) for p in payloads],
        "compressed": bool(compressed),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_metadata(f, MAGIC, meta)
        for p in payloads:
            f.write(p)
    os.replace(tmp, path)


def read_index_metadata(path) -> dict:
    """Validate the magic and return the JSON metadata."""
    return _read_metadata(_Source(path).head(METADATA_LEN), MAGIC)


def load_index(source, device="cuda") -> LayerStack:
    """Load a layer stack from a file path or a bytes-like buffer onto ``device``."""
    src = _Source(source)
    meta = _read_metadata(src.head(METADATA_LEN), MAGIC)
    m = meta["num_neighbors"]
    arrays = []
    offset = METADATA_LEN
    for count, size in zip(meta["layer_counts"], meta["layer_sizes"]):
        if meta.get("compressed"):
            from ..native import codec

            arrays.append(codec.decode_adjacency(src.bytes_at(offset, size), count, m))
        else:
            arrays.append(np.array(src.region("<i4", offset, (count, m))))
        offset += size
    return LayerStack.from_numpy(arrays, device=device)


# ---------------------------------------------------------------------------
# Elements
# ---------------------------------------------------------------------------


def _embeddings_payload(elements):
    """A SumEmbeddings container's CSR blob (offsets then packed term ids)
    and its metadata, in the JAX package's key order."""
    from ..elements import packed
    from ..native import codec

    terms = elements.terms.cpu().numpy().astype("<i4")
    offsets, ids = packed.terms_to_csr(terms)
    off_blob, off_fmt = codec.encode_offsets_py(offsets), "chunked"
    if not off_blob:  # a row longer than 65,535 terms: raw u64 offsets
        off_blob, off_fmt = np.ascontiguousarray(offsets, "<u8").tobytes(), "raw64"
    V, d_emb = elements.embeddings.shape
    meta = {  # count and dim stand where the JAX package first inserts them
        "granne_tpu_version": LIBRARY_VERSION,
        "version": SERIALIZATION_VERSION,
        "type": "embeddings",
        "count": int(terms.shape[0]),
        "dim": int(terms.shape[1]),
        "vocab": int(V),
        "emb_dim": int(d_emb),
        "terms_format": "csr24",
        "offsets_format": off_fmt,
        "offsets_bytes": len(off_blob),
        "num_terms": int(len(ids)),
        "term_width": int(terms.shape[1]),
    }
    return off_blob + packed.pack_u24(ids), meta


def save_elements(elements, path: str) -> None:
    """Write an ``AngularVectors`` container (a bf16 copy is written as f32),
    an ``AngularIntVectors`` one (its int8 codes) or a ``SumEmbeddings`` one
    (CSR terms, then the f32 table), streaming the matrix to the host in
    bounded row chunks."""
    from ..elements.angular import AngularVectors
    from ..elements.angular_int import AngularIntVectors
    from ..elements.embeddings import SumEmbeddings

    head = b""
    if isinstance(elements, SumEmbeddings):
        head, meta = _embeddings_payload(elements)
        dtype, cast, data = "<f4", torch.float32, elements.embeddings
    else:
        if isinstance(elements, AngularVectors):
            kind, dtype, cast = "angular", "<f4", torch.float32
        elif isinstance(elements, AngularIntVectors):
            kind, dtype, cast = "angular_int", "i1", torch.int8
        else:
            raise TypeError(
                f"unsupported element container: {type(elements)!r} (granne_tpu_torch saves "
                "angular, angular_int and SumEmbeddings elements)"
            )
        data = elements.vectors
        meta = {
            "granne_tpu_version": LIBRARY_VERSION,
            "version": SERIALIZATION_VERSION,
            "type": kind,
            "count": int(data.shape[0]),
            "dim": int(data.shape[1]),
        }
    n, d = data.shape
    step = max(1, _WRITE_CHUNK_BYTES // max(1, np.dtype(dtype).itemsize * int(d)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_metadata(f, ELEMENTS_MAGIC, meta)
        f.write(head)
        for lo in range(0, int(n), step):
            chunk = data[lo : lo + step].to(cast).cpu().numpy()
            f.write(np.ascontiguousarray(chunk, dtype=dtype).tobytes())
    os.replace(tmp, path)


def read_elements_metadata(path) -> dict:
    return _read_metadata(_Source(path).head(METADATA_LEN), ELEMENTS_MAGIC)


def _load_embeddings(src, meta, device):
    from ..elements import packed
    from ..elements.embeddings import SumEmbeddings
    from ..native import codec

    if meta.get("terms_format") != "csr24":
        raise ValueError(f"unknown embeddings terms format {meta.get('terms_format')!r}")
    n, off_bytes, num_terms = meta["count"], meta["offsets_bytes"], meta["num_terms"]
    off_blob = src.bytes_at(METADATA_LEN, off_bytes)
    if meta["offsets_format"] == "chunked":
        offsets = codec.decode_offsets_py(off_blob, n + 1)
    else:
        offsets = np.frombuffer(off_blob, "<u8")
    ids = packed.unpack_u24(src.region(np.uint8, METADATA_LEN + off_bytes, (num_terms * 3,)), num_terms)
    terms = packed.csr_to_terms(offsets, ids, meta["term_width"])
    emb = src.region("<f4", METADATA_LEN + off_bytes + num_terms * 3, (meta["vocab"], meta["emb_dim"]))
    return SumEmbeddings.from_parts(np.array(emb), terms, device=device)


def load_elements(source, device="cuda"):
    """Load an element file (path or bytes-like buffer) onto ``device``: the
    matrix is read through a memory map and uploaded whole."""
    from ..elements.angular import AngularVectors
    from ..elements.angular_int import AngularIntVectors

    src = _Source(source)
    meta = _read_metadata(src.head(METADATA_LEN), ELEMENTS_MAGIC)
    if meta["type"] == "embeddings":
        return _load_embeddings(src, meta, device)
    kinds = {
        "angular": ("<f4", AngularVectors.from_normalized),
        "angular_int": ("i1", AngularIntVectors.from_quantized),
    }
    if meta["type"] not in kinds:
        raise ValueError(f"unknown element type {meta['type']!r}")
    dtype, make = kinds[meta["type"]]
    raw = src.region(dtype, METADATA_LEN, (meta["count"], meta["dim"]))
    return make(np.array(raw), device=device)
