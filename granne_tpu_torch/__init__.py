"""granne_tpu_torch: the PyTorch / CUDA port of granne_tpu for NVIDIA Hopper.

HNSW build (wave-parallel) and batched beam search over f32 or int8 cosine
vectors, served through a flat neighbor cache scored by a hand-written CUDA
kernel (``csrc/nbr_score.cu``), with an exact rerank of the final beam; the
IVF engine, whose slot scorers are hand-written CUDA kernels
(``csrc/ivf_score.cu``), and the exact brute-force engine, with the same
serving API.  The module layout mirrors ``granne_tpu``; the on-disk formats
are the same files.  This package imports torch and numpy, never jax.
"""

from .api import GranneBuilder, compute_distance, load_granne
from .elements.angular import AngularVectors
from .elements.angular_int import AngularIntVectors
from .index.builder import MAX_ELEMENTS, BuildConfig, build_layers
from .index.granne import Granne
from .index.graph import LayerStack
from .index.ivf import IvfIndex
from .models.brute import BruteForceIndex

__all__ = [
    "AngularIntVectors",
    "AngularVectors",
    "BruteForceIndex",
    "BuildConfig",
    "Granne",
    "GranneBuilder",
    "IvfIndex",
    "LayerStack",
    "MAX_ELEMENTS",
    "build_layers",
    "compute_distance",
    "load_granne",
]
