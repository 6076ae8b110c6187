"""Carry an index across from the JAX package.

``granne_tpu``'s ``LayerStack.as_numpy()``, its ``AngularVectors.vectors``,
its ``AngularIntVectors.vectors`` (int8 codes, with the container's
``rounding``) and its ``SumEmbeddings`` (``embeddings`` and ``terms``), as
numpy arrays, become the port's objects on ``device``; the tests use
this to run the port on JAX-built graphs.  A JAX sharded index comes
across one rank at a time (``sharded_ivf_from_numpy``,
``sharded_granne_from_numpy``): each rank takes only its own shard.  The IVF and brute-force engines'
arrays come across the same way (bf16 as numpy's extension ``bfloat16``
dtype or as raw uint16 bits).  Files written by either package load in the other
(``index.io``, ``IvfIndex.save``/``load``), so this is the in-memory path
only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .elements.angular import AngularVectors
from .elements.angular_int import AngularIntVectors
from .elements.embeddings import SumEmbeddings
from .index.granne import Granne
from .index.graph import LayerStack
from .index.ivf import IvfIndex
from .models.brute import BruteForceIndex


def layers_from_numpy(layer_arrays, device="cuda") -> LayerStack:
    """Per-layer int32 adjacency arrays (trimmed to their counts) -> LayerStack."""
    return LayerStack.from_numpy(layer_arrays, device=device)


def int8_elements_from_numpy(codes, rounding: str = "trunc", device="cuda") -> AngularIntVectors:
    """int8 codes [n, d] and the quantizer that made them -> AngularIntVectors
    (reciprocal norms recomputed, bit-equal to the JAX package's)."""
    el = AngularIntVectors.from_quantized(np.asarray(codes, np.int8), device=device)
    return dataclasses.replace(el, rounding=rounding)


def sum_embeddings_from_numpy(embeddings, terms, device="cuda") -> SumEmbeddings:
    """An embedding table f32[V, d] and padded terms int32[n, T] (-1 padding)
    -> SumEmbeddings."""
    return SumEmbeddings.from_parts(np.asarray(embeddings, np.float32), np.asarray(terms, np.int32), device=device)


def granne_from_numpy(layer_arrays, vectors, device="cuda") -> Granne:
    """Adjacency arrays + unit-norm f32 vectors [n, d], int8 codes, or a
    port container (e.g. from ``sum_embeddings_from_numpy``) -> Granne."""
    if isinstance(vectors, SumEmbeddings):
        return Granne(layers=layers_from_numpy(layer_arrays, device=device), elements=vectors)
    vectors = np.asarray(vectors)
    if vectors.dtype == np.int8:
        elements = int8_elements_from_numpy(vectors, device=device)
    else:
        elements = AngularVectors.from_normalized(np.asarray(vectors, np.float32), device=device)
    return Granne(layers=layers_from_numpy(layer_arrays, device=device), elements=elements)


def _tensor(arr, device) -> torch.Tensor:
    """A numpy array (copied) as a tensor on ``device``; bf16 (the
    extension ``bfloat16`` dtype or raw uint16 bits) becomes ``torch.bfloat16``."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.as_tensor(np.array(a).view(np.int16), device=device).view(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def neighbor_cache_from_numpy(tab, device="cuda") -> torch.Tensor:
    """A JAX neighbor-cache table (as numpy) -> the port's: int16 flat bf16
    rows and int32 flat f32 rows keep their integer type, a bf16 tiled
    table becomes ``torch.bfloat16``."""
    return _tensor(tab, device)


def ivf_from_numpy(centroids, blocks, block_ids, block_scales, n_total, device="cuda") -> IvfIndex:
    """A JAX ``IvfIndex``'s arrays (as numpy) -> the port's ``IvfIndex``."""
    return IvfIndex(
        centroids=_tensor(np.asarray(centroids, np.float32), device),
        blocks=_tensor(blocks, device),
        block_ids=_tensor(np.asarray(block_ids, np.int32), device),
        block_scales=_tensor(np.asarray(block_scales, np.float32), device),
        n_total=int(n_total),
    )


def brute_from_numpy(vectors, scale, n_total, device="cuda") -> BruteForceIndex:
    """A JAX ``BruteForceIndex``'s arrays (as numpy) -> the port's."""
    return BruteForceIndex(
        vectors=_tensor(vectors, device),
        scale=_tensor(np.asarray(scale, np.float32), device),
        n_total=int(n_total),
    )


def sharded_ivf_from_numpy(centroids, blocks, block_ids, block_scales, n_total, group):
    """A JAX ``IvfIndex``'s (or ``ShardedIvf``'s unpadded) arrays -> this
    rank's ``ShardedIvf`` rows on ``group.device``; only the rank's rows
    go to its device."""
    from .parallel.sharded_ivf import ShardedIvf

    return ShardedIvf.from_ivf(ivf_from_numpy(centroids, blocks, block_ids, block_scales, n_total, "cpu"), group)


def sharded_granne_from_numpy(layer_arrays_of_shard, vectors_of_shard, offset, n_total, group):
    """One shard of a JAX ``ShardedGranne`` -> this rank's ``ShardedGranne``:
    the shard's layers trimmed to their counts
    (``np.asarray(sg.layers[i][s])[:sg.counts[i][s]]``), its elements
    (``sg.elements.vectors[s]``, padding rows included), its first global
    id (the contiguous split's, which is checked) and the index's size."""
    from .parallel.sharded import ShardedGranne, shard_bounds

    offsets = tuple(int(o) for o in shard_bounds(n_total, group.world)[:-1])
    if offsets[group.rank] != int(offset):
        raise ValueError(f"rank {group.rank}'s shard starts at {offsets[group.rank]}, not {offset}")
    index = granne_from_numpy(layer_arrays_of_shard, vectors_of_shard, device=group.device)
    return ShardedGranne(group, index, offsets, int(n_total))
