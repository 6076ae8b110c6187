"""granne_tpu_torch: the PyTorch / CUDA port of granne_tpu for NVIDIA Hopper.

HNSW build (wave-parallel) and batched beam search over f32 cosine vectors,
served from a bf16 copy through a flat neighbor cache scored by a
hand-written CUDA kernel (``csrc/nbr_score.cu``).  The module layout
mirrors ``granne_tpu``; the on-disk formats are the same files.  This
package imports torch and numpy, never jax.
"""

from .api import GranneBuilder, compute_distance, load_granne
from .elements.angular import AngularVectors
from .index.builder import MAX_ELEMENTS, BuildConfig, build_layers
from .index.granne import Granne
from .index.graph import LayerStack

__all__ = [
    "AngularVectors",
    "BuildConfig",
    "Granne",
    "GranneBuilder",
    "LayerStack",
    "MAX_ELEMENTS",
    "build_layers",
    "compute_distance",
    "load_granne",
]
