"""ctypes binding of the port's C++ runtime (``csrc/codec.cpp``).

The compressed index format and the host search are defined by
``csrc/codec.cpp``, the port's own copy of the JAX package's
``granne_tpu/native/codec.cpp``: the two copies define one format (their
code is the same line for line, and a port index file equals the JAX
package's byte for byte, both checked by the tests).  It is built with g++
and the JAX package's flags (``-O3 -march=native``: the same program, down
to which ``a*b+c`` become fused multiply-adds) into ``build/granne_tpu_torch``
beside the package at first use and loaded with ctypes.  A failed build
raises.  Every ``extern "C"`` function of the source is bound here.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..ops.kernels.build import BUILD_DIR, CSRC_DIR, load_library

GXX_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_P, _U32, _U64, _SIZE = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_size_t

_SIGNATURES = {
    "gt_encode_bound": (_SIZE, [_U32, _U32]),
    "gt_encode_adjacency": (_SIZE, [_P, _U32, _U32, _P]),
    "gt_decode_adjacency": (ctypes.c_int, [_P, _SIZE, _P]),
    "gt_adjacency_shape": (ctypes.c_int, [_P, _P, _P]),
    # the chunk-compressed offset table (offsets.rs format)
    "gt_offsets_encoded_size": (_SIZE, [_U32]),
    "gt_offsets_encode": (_SIZE, [_P, _U32, _P]),  # offsets, count, out
    "gt_offsets_get": (_U64, [_P, _U32]),  # buf, index
    "gt_offsets_decode": (ctypes.c_int, [_P, _P, _U32]),  # buf, out, count
    # host HNSW search; every one ends in (nq, ef, k, num_threads, out_ids, out_dists)
    # vectors, n, d, layers (ptr array), num_layers, width, queries, ...
    "gt_search_f32": (None, [_P, _U32, _U32, _P, _U32, _U32, _P, _U32, _U32, _U32, _U32, _P, _P]),
    # vectors (i8), inv_norms, n, d, layers, num_layers, width, queries (i8), query inv_norms, ...
    "gt_search_i8": (None, [_P, _P, _U32, _U32, _P, _U32, _U32, _P, _P, _U32, _U32, _U32, _U32, _P, _P]),
    # vectors, n, d, layer buffers (ptr array), layer lengths (u64), num_layers, queries, ...
    "gt_search_compressed": (None, [_P, _U32, _U32, _P, _P, _U32, _P, _U32, _U32, _U32, _U32, _P, _P]),
    # vectors (i8), inv_norms, n, d, layer buffers, layer lengths, num_layers, queries (i8), query inv_norms, ...
    "gt_search_compressed_i8": (
        None, [_P, _P, _U32, _U32, _P, _P, _U32, _P, _P, _U32, _U32, _U32, _U32, _P, _P]
    ),
}


def codec_source() -> Path:
    """The runtime's C++ source, inside this package."""
    return CSRC_DIR / "codec.cpp"


def get_lib() -> ctypes.CDLL:
    """Load the runtime library, building it first if it is missing or stale."""
    return load_library(codec_source(), BUILD_DIR / "libgranne_codec.so", lambda: GXX_CMD, _SIGNATURES)
