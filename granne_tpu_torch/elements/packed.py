"""Packed 3-byte term ids and CSR term storage (the port's own copy of
``granne_tpu/elements/packed.py``; numpy only).

Term ids go to disk as 3-byte little-endian ints (vocabularies up to 2^24,
the reference's ``ThreeByteInt``, ``odd_byte_int.rs:3-36``), and the CSR
offset table through the chunk-compressed codec of ``native/codec.py``
(``encode_offsets_py``).  On the device the terms are the dense padded
``int32[n, T]`` tensor of ``SumEmbeddings.terms`` (-1 padding): the packed
form is a file and host concern only.
"""

from __future__ import annotations

import numpy as np

U24_MAX = (1 << 24) - 1


def pack_u24(ids: np.ndarray) -> bytes:
    """int array -> packed 3-byte little-endian payload."""
    ids = np.ascontiguousarray(ids, dtype="<u4")
    if ids.size and int(ids.max()) > U24_MAX:
        raise ValueError(f"term id exceeds 3-byte range ({U24_MAX})")
    return np.ascontiguousarray(ids.view(np.uint8).reshape(-1, 4)[:, :3]).tobytes()


def unpack_u24(buf, count: int) -> np.ndarray:
    """Packed 3-byte little-endian payload -> uint32[count]."""
    raw = np.frombuffer(buf, np.uint8, count * 3).reshape(count, 3)
    out = np.zeros((count, 4), np.uint8)
    out[:, :3] = raw
    return out.view("<u4").reshape(count)


def terms_to_csr(terms: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense padded int32[n, T] (-1 padding) -> (offsets u64[n + 1], data u32[nnz])."""
    terms = np.asarray(terms)
    mask = terms >= 0
    offsets = np.zeros(len(terms) + 1, np.uint64)
    np.cumsum(mask.sum(axis=1), out=offsets[1:])
    return offsets, terms[mask].astype(np.uint32)


def csr_to_terms(offsets: np.ndarray, data: np.ndarray, width: int | None = None) -> np.ndarray:
    """(offsets, data) -> dense padded int32[n, T] with -1 padding; a row
    longer than ``width`` keeps its first ``width`` terms."""
    offsets = np.asarray(offsets, np.int64)
    counts = np.diff(offsets)
    n = len(counts)
    if width is None:
        width = max(1, int(counts.max()) if n else 1)
    out = np.full((n, width), -1, np.int32)
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(len(data)) - np.repeat(offsets[:-1], counts)
    keep = cols < width
    out[rows[keep], cols[keep]] = data[keep].astype(np.int32)
    return out
