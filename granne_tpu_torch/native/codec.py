"""Compressed adjacency encode/decode through the port's C++ codec.

Format v2 of ``csrc/codec.cpp`` (the JAX package's format): ``u32 rows, u32 width,
u32 flags, u32 reserved, u64 payload_len``, per-row payloads (sorted ids,
delta + StreamVByte coded, or raw u32), then the row-offset table.  Decoded
rows come back sorted, as in the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib


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
