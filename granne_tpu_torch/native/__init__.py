"""ctypes binding of the adjacency codec shared with the JAX package.

The compressed index format is defined by ONE C++ source,
``granne_tpu/native/codec.cpp``.  It is read where it lies (located through
the import system, without importing ``granne_tpu``, whose ``__init__``
pulls in jax), built with g++ into ``build/granne_tpu_torch`` beside the
package at first use, and loaded with ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import importlib.util
from pathlib import Path

from ..ops.kernels.build import BUILD_DIR, load_library

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
    spec = importlib.util.find_spec("granne_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise RuntimeError("granne_tpu/native/codec.cpp not found: the granne_tpu package is not on the path")
    return Path(next(iter(spec.submodule_search_locations))) / "native" / "codec.cpp"


def get_lib() -> ctypes.CDLL:
    """Load the codec library, building it first if it is missing or stale."""
    return load_library(codec_source(), BUILD_DIR / "libgranne_codec.so", lambda: GXX_CMD, _SIGNATURES)
