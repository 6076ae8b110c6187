"""Element-container protocol (port of ``granne_tpu/elements/base.py``).

A container holds its vectors as device tensors and offers *batched*
distance methods that the beam search and the neighbor-selection heuristic
drive as gathers plus contractions.  Mutation (``extend``) returns a new
container.

The capabilities the beam dispatches on are declared, not sniffed: a
container that can feed the neighbor-vector cache subclasses
``NeighborCacheScoring`` and ``supports_cache`` tests for that class.  The
class also says how the container's queries become the kernels' bf16 lanes
(``query_lanes``) and how their dots become distances
(``dist_from_dots_q``), and whether it can feed the tiled layout
(``tiled_refusal``).  A query batch is whatever ``prepare_queries``
returns: a tensor, or a small object with ``.shape`` and ``.device``
(``elements.angular_int.IntQueries``).
"""

from __future__ import annotations

import abc
from typing import ClassVar, Optional, Protocol, runtime_checkable

import torch


@runtime_checkable
class ElementContainer(Protocol):
    """Batched analogue of granne's ``ElementContainer``."""

    def __len__(self) -> int: ...

    @property
    def dim(self) -> int: ...

    @property
    def device(self) -> torch.device: ...

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather element vectors (in the container's dtype) for any id shape."""
        ...

    def prepare_queries(self, raw: torch.Tensor):
        """Convert raw f32 queries [B, d] into the container's query batch."""
        ...

    def dist_ids_to_queries(self, ids: torch.Tensor, queries) -> torch.Tensor:
        """dist(element[ids[b, c]], query[b]) -> f32[B, C]."""
        ...

    def pairwise_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """dist(element[ids[b, i]], element[ids[b, j]]) -> f32[B, C, C]."""
        ...

    def queries_from_ids(self, ids: torch.Tensor):
        """Make a query batch out of stored elements (self-query / build)."""
        ...

    def self_dist(self, ids: torch.Tensor) -> torch.Tensor:
        """dist(element[i], element[i]): nonzero only for zero vectors
        (the zero-element skip rule of the build)."""
        ...

    def permute(self, order) -> "ElementContainer":
        """A new container whose element ``i`` is this one's ``order[i]``
        (``index.reorder``)."""
        ...


class NeighborCacheScoring(abc.ABC):
    """Capability: the container can fill and score a neighbor-vector cache
    (``ops.nbr_cache``, ``ops.kernels.nbr_score``), feed the build's
    cache-fed merges, and re-score a final beam exactly.

    ``tiled_refusal`` is None when the container can feed the tiled layout
    (K2), else the reason it cannot; ``ops.nbr_cache`` raises with it."""

    tiled_refusal: ClassVar[Optional[str]] = None

    @abc.abstractmethod
    def cache_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """bf16 vector rows [..., d] for the cache table."""

    @abc.abstractmethod
    def cache_rows_exact(self, ids: torch.Tensor) -> torch.Tensor:
        """f32 vector rows [..., d] for a ``cache_dtype="f32"`` table."""

    @abc.abstractmethod
    def score_block(self, block: torch.Tensor, queries) -> torch.Tensor:
        """Distance for pre-gathered rows: block [B, K, d] x the query batch -> f32[B, K]."""

    @abc.abstractmethod
    def query_lanes(self, queries) -> torch.Tensor:
        """The query batch as the bf16[B, d] lanes the cache scorers (K1, K2)
        take; ``dist_from_dots_q`` turns their dots into distances."""

    @abc.abstractmethod
    def dist_from_dots_q(self, dots: torch.Tensor, queries) -> torch.Tensor:
        """Distance from raw dots of cache rows with ``query_lanes(queries)`` (f32)."""

    @abc.abstractmethod
    def pairwise_from_vecs(self, vecs: torch.Tensor) -> torch.Tensor:
        """Pairwise distances of pre-gathered rows [B, C, d] -> f32[B, C, C]."""

    @abc.abstractmethod
    def rerank_dists(self, ids: torch.Tensor, queries) -> torch.Tensor:
        """f32 re-scoring of a final beam: ids [B, K] x the query batch -> f32[B, K]."""


def supports_cache(elements) -> bool:
    """Whether ``elements`` declares the neighbor-cache capability."""
    return isinstance(elements, NeighborCacheScoring)
