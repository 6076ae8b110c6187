"""Index + element serialization (port of ``granne_tpu/index/io.py``).

The files are the JAX package's, byte for byte: a 1024-byte metadata block
(ASCII magic + JSON) followed by the layers back to back, dense ``<i4`` or
compressed by the shared C++ codec; elements are a separate file with the
same metadata block and a dense matrix: ``<f4`` for ``"angular"``, the
int8 codes (``i1``) for ``"angular_int"``.  An int8 file does not record the
container's ``rounding``, as in the JAX package: a loaded container extends
with truncated codes.  Writes go to ``path.tmp`` and are moved into place
with ``os.replace``.

``"embeddings"`` elements are not ported yet; they raise.
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


def save_elements(elements, path: str) -> None:
    """Write an ``AngularVectors`` container (a bf16 copy is written as f32)
    or an ``AngularIntVectors`` one (its int8 codes), streaming the matrix
    to the host in bounded row chunks."""
    from ..elements.angular import AngularVectors
    from ..elements.angular_int import AngularIntVectors

    if isinstance(elements, AngularVectors):
        kind, dtype, cast = "angular", "<f4", torch.float32
    elif isinstance(elements, AngularIntVectors):
        kind, dtype, cast = "angular_int", "i1", torch.int8
    else:
        raise TypeError(
            f"unsupported element container: {type(elements)!r} (granne_tpu_torch "
            "saves angular and angular_int elements; ROADMAP.md, Queue 1 item 10)"
        )
    data = elements.vectors
    n, d = data.shape
    meta = {
        "granne_tpu_version": LIBRARY_VERSION,
        "version": SERIALIZATION_VERSION,
        "type": kind,
        "count": int(n),
        "dim": int(d),
    }
    step = max(1, _WRITE_CHUNK_BYTES // max(1, np.dtype(dtype).itemsize * int(d)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_metadata(f, ELEMENTS_MAGIC, meta)
        for lo in range(0, int(n), step):
            chunk = data[lo : lo + step].to(cast).cpu().numpy()
            f.write(np.ascontiguousarray(chunk, dtype=dtype).tobytes())
    os.replace(tmp, path)


def read_elements_metadata(path) -> dict:
    return _read_metadata(_Source(path).head(METADATA_LEN), ELEMENTS_MAGIC)


def load_elements(source, device="cuda"):
    """Load an element file (path or bytes-like buffer) onto ``device``: the
    matrix is read through a memory map and uploaded whole."""
    from ..elements.angular import AngularVectors
    from ..elements.angular_int import AngularIntVectors

    src = _Source(source)
    meta = _read_metadata(src.head(METADATA_LEN), ELEMENTS_MAGIC)
    kinds = {
        "angular": ("<f4", AngularVectors.from_normalized),
        "angular_int": ("i1", AngularIntVectors.from_quantized),
    }
    if meta["type"] not in kinds:
        raise ValueError(
            f"element type {meta['type']!r} is not ported to granne_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 10)"
        )
    dtype, make = kinds[meta["type"]]
    raw = src.region(dtype, METADATA_LEN, (meta["count"], meta["dim"]))
    return make(np.array(raw), device=device)
