"""granne_tpu_torch: the PyTorch / CUDA port of granne_tpu for NVIDIA Hopper.

HNSW build (wave-parallel) and batched beam search over f32 or int8 cosine
vectors, served through a flat neighbor cache scored by a hand-written CUDA
kernel (``csrc/nbr_score.cu``), with an exact rerank of the final beam; the
IVF engine, whose slot scorers are hand-written CUDA kernels
(``csrc/ivf_score.cu``), and the exact brute-force engine, with the same
serving API.  Saved files are also served on the host from memory maps by
the C++ search (``HostGranne``), an index can be renumbered for locality
(``Granne.reorder``), and ``RwGranneBuilder`` inserts into a live index.
Bag-of-embeddings elements (``SumEmbeddings``) build and serve through
the same kernels, with their ETL and a text-query index
(``WordEmbeddingsGranne``); ``TieredIvf`` serves an IVF index whose blocks
stay in host memory and stream to the card a batch at a time.  Several
devices serve one index over ``torch.distributed`` (one process a rank):
``ShardedIvf`` and ``TieredShardedIvf`` split the IVF blocks,
``ShardedGranne`` the elements, each merging the ranks' top-k; and several
ranks build one HNSW graph together (``build_layers(..., group=...)``,
each wave's search split over them).
The module layout mirrors ``granne_tpu``; the on-disk formats are the same
files.  This package imports torch and numpy, never jax.
"""

from .api import (
    Embeddings,
    GranneBuilder,
    WordEmbeddingsGranne,
    compute_distance,
    compute_embeddings_and_save_to_disk,
    load_granne,
    parse_elements_and_save_to_disk,
)
from .elements.angular import AngularVectors
from .elements.angular_int import AngularIntVectors
from .elements.embeddings import SumEmbeddings, reorder_keys
from .elements.embeddings_etl import WordDict
from .index.builder import MAX_ELEMENTS, BuildConfig, build_layers
from .index.granne import Granne
from .index.graph import LayerStack
from .index.ivf import IvfIndex
from .index.reorder import compute_order, order_by_keys, reorder_by_keys, reorder_index
from .index.rw import RwGranneBuilder
from .models.brute import BruteForceIndex
from .native.serve import HostGranne
from .parallel.mesh import Group, all_gather_topk, make_group, run_ranks
from .parallel.sharded import ShardedGranne
from .parallel.sharded_ivf import ShardedIvf
from .parallel.tiering import TieredIvf, TieredShardedIvf

__all__ = [
    "AngularIntVectors",
    "AngularVectors",
    "BruteForceIndex",
    "BuildConfig",
    "Embeddings",
    "Granne",
    "GranneBuilder",
    "Group",
    "HostGranne",
    "IvfIndex",
    "LayerStack",
    "MAX_ELEMENTS",
    "RwGranneBuilder",
    "ShardedGranne",
    "ShardedIvf",
    "SumEmbeddings",
    "TieredIvf",
    "TieredShardedIvf",
    "WordDict",
    "WordEmbeddingsGranne",
    "all_gather_topk",
    "build_layers",
    "compute_distance",
    "compute_embeddings_and_save_to_disk",
    "compute_order",
    "load_granne",
    "make_group",
    "order_by_keys",
    "parse_elements_and_save_to_disk",
    "reorder_by_keys",
    "reorder_index",
    "reorder_keys",
    "run_ranks",
]
