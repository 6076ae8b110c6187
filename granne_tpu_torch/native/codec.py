"""Compressed adjacency encode/decode through the port's C++ codec.

Format v2 of ``csrc/codec.cpp`` (the JAX package's format): ``u32 rows, u32 width,
u32 flags, u32 reserved, u64 payload_len``, per-row payloads (sorted ids,
delta + StreamVByte coded, or raw u32), then the row-offset table.  Decoded
rows come back sorted, as in the reference.

The row-offset table's chunk-compressed form (``{u64 initial, u16
deltas[60]}`` per 60 offsets after a ``u64`` count) has two codecs that
give the same bytes: the C++ one (``encode_offsets``/``decode_offsets``/
``offset_at``) and a numpy one (``encode_offsets_py``/``decode_offsets_py``,
copied from the JAX package's ``native/codec.py``).  Either encoder gives
``b""`` when a delta does not fit in u16 (the caller keeps a raw table).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib

OFFSETS_PER_CHUNK = 60  # offsets.rs:7-8
_CHUNK_BYTES = 8 + 2 * OFFSETS_PER_CHUNK


def encode_adjacency(adj: np.ndarray) -> bytes:
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    rows, width = adj.shape
    lib = get_lib()
    out = np.empty(lib.gt_encode_bound(rows, width), np.uint8)
    n = lib.gt_encode_adjacency(
        adj.ctypes.data_as(ctypes.c_void_p), rows, width, out.ctypes.data_as(ctypes.c_void_p)
    )
    return out[:n].tobytes()


def decode_adjacency(buf: bytes, rows: int, width: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8)
    if raw.size < 24:
        raise ValueError("truncated compressed adjacency block")
    lib = get_lib()
    r, w = ctypes.c_uint32(0), ctypes.c_uint32(0)
    lib.gt_adjacency_shape(raw.ctypes.data_as(ctypes.c_void_p), ctypes.byref(r), ctypes.byref(w))
    if (r.value, w.value) != (rows, width):
        raise ValueError(f"encoded block is {r.value}x{w.value}, metadata says {rows}x{width}")
    out = np.empty((rows, width), np.int32)
    lib.gt_decode_adjacency(raw.ctypes.data_as(ctypes.c_void_p), len(buf), out.ctypes.data_as(ctypes.c_void_p))
    return out


# ---------------------------------------------------------------------------
# The chunk-compressed offset table
# ---------------------------------------------------------------------------


def encode_offsets(offsets) -> bytes:
    """Chunk-compress a monotone u64 offset array with the C++ codec."""
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lib = get_lib()
    out = np.zeros(lib.gt_offsets_encoded_size(len(offsets)), np.uint8)
    n = lib.gt_offsets_encode(offsets.ctypes.data_as(ctypes.c_void_p), len(offsets), out.ctypes.data_as(ctypes.c_void_p))
    return out[:n].tobytes()


def decode_offsets(buf: bytes, count: int) -> np.ndarray:
    """Decode a chunk-compressed offset table to u64[count] with the C++ codec."""
    raw = np.frombuffer(buf, np.uint8)
    out = np.empty(count, np.uint64)
    get_lib().gt_offsets_decode(raw.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), count)
    return out


def offset_at(buf: bytes, index: int) -> int:
    """One offset of a chunk-compressed table, read in place."""
    raw = np.frombuffer(buf, np.uint8)
    return int(get_lib().gt_offsets_get(raw.ctypes.data_as(ctypes.c_void_p), index))


def encode_offsets_py(offsets: np.ndarray) -> bytes:
    """Chunk-compress a monotone u64 offset array (offsets.rs format).

    Returns b"" when some delta exceeds u16 (caller uses a raw table).
    """
    offsets = np.asarray(offsets, np.uint64)
    count = len(offsets)
    deltas = np.diff(offsets)
    if len(deltas) and int(deltas.max()) > 0xFFFF:
        return b""
    n_chunks = (count + OFFSETS_PER_CHUNK - 1) // OFFSETS_PER_CHUNK
    d16 = np.zeros(n_chunks * OFFSETS_PER_CHUNK, "<u2")
    d16[: len(deltas)] = deltas.astype("<u2")
    out = bytearray(int(count).to_bytes(8, "little"))
    for c in range(n_chunks):
        out += int(offsets[c * OFFSETS_PER_CHUNK]).to_bytes(8, "little")
        out += d16[c * OFFSETS_PER_CHUNK : (c + 1) * OFFSETS_PER_CHUNK].tobytes()
    return bytes(out)


def decode_offsets_py(buf: bytes, count: int) -> np.ndarray:
    """Decode a chunk-compressed offset table back to u64[count]."""
    out = np.empty(count, np.uint64)
    pos = 8
    done = 0
    while done < count:
        initial = int.from_bytes(buf[pos : pos + 8], "little")
        deltas = np.frombuffer(buf[pos + 8 : pos + _CHUNK_BYTES], "<u2")
        take = min(OFFSETS_PER_CHUNK, count - done)
        vals = initial + np.concatenate([[0], np.cumsum(deltas[: take - 1], dtype=np.uint64)])
        out[done : done + take] = vals[:take]
        done += take
        pos += _CHUNK_BYTES
    return out
