"""granne_tpu_torch: the PyTorch / CUDA port of granne_tpu for NVIDIA Hopper.

HNSW build (wave-parallel) and batched beam search over f32 or int8 cosine
vectors, served through a flat neighbor cache scored by a hand-written CUDA
kernel (``csrc/nbr_score.cu``), with an exact rerank of the final beam; the
IVF engine, whose slot scorers are hand-written CUDA kernels
(``csrc/ivf_score.cu``), and the exact brute-force engine, with the same
serving API.  Saved files are also served on the host from memory maps by
the C++ search (``HostGranne``), an index can be renumbered for locality
(``Granne.reorder``), and ``RwGranneBuilder`` inserts into a live index.
The module layout mirrors ``granne_tpu``; the on-disk formats are the same
files.  This package imports torch and numpy, never jax.
"""

from .api import GranneBuilder, compute_distance, load_granne
from .elements.angular import AngularVectors
from .elements.angular_int import AngularIntVectors
from .index.builder import MAX_ELEMENTS, BuildConfig, build_layers
from .index.granne import Granne
from .index.graph import LayerStack
from .index.ivf import IvfIndex
from .index.reorder import compute_order, order_by_keys, reorder_by_keys, reorder_index
from .index.rw import RwGranneBuilder
from .models.brute import BruteForceIndex
from .native.serve import HostGranne

__all__ = [
    "AngularIntVectors",
    "AngularVectors",
    "BruteForceIndex",
    "BuildConfig",
    "Granne",
    "GranneBuilder",
    "HostGranne",
    "IvfIndex",
    "LayerStack",
    "MAX_ELEMENTS",
    "RwGranneBuilder",
    "build_layers",
    "compute_distance",
    "compute_order",
    "load_granne",
    "order_by_keys",
    "reorder_by_keys",
    "reorder_index",
]
