"""ctypes binding of the port's adjacency codec.

The compressed index format is defined by ``csrc/codec.cpp``, the port's
own copy of the JAX package's ``granne_tpu/native/codec.cpp``: the two
copies define one format (their code is the same line for line, and a port
index file equals the JAX package's byte for byte, both checked by the
tests).  It is built with g++ into ``build/granne_tpu_torch`` beside the
package at first use and loaded with ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..ops.kernels.build import BUILD_DIR, CSRC_DIR, load_library

GXX_CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_SIGNATURES = {
    "gt_encode_bound": (ctypes.c_size_t, [ctypes.c_uint32, ctypes.c_uint32]),
    "gt_encode_adjacency": (
        ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    ),
    "gt_decode_adjacency": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]),
    "gt_adjacency_shape": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
}


def codec_source() -> Path:
    """The codec's C++ source, inside this package."""
    return CSRC_DIR / "codec.cpp"


def get_lib() -> ctypes.CDLL:
    """Load the codec library, building it first if it is missing or stale."""
    return load_library(codec_source(), BUILD_DIR / "libgranne_codec.so", lambda: GXX_CMD, _SIGNATURES)
