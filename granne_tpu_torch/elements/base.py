"""Element-container protocol (port of ``granne_tpu/elements/base.py``).

A container holds its vectors as device tensors and offers *batched*
distance methods that the beam search and the neighbor-selection heuristic
drive as gathers plus contractions.  Mutation (``extend``) returns a new
container.

The capabilities the beam dispatches on are declared, not sniffed: a
container that can feed the neighbor-vector cache subclasses
``NeighborCacheScoring`` and ``supports_cache`` tests for that class.
"""

from __future__ import annotations

import abc
from typing import Protocol, runtime_checkable

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

    def prepare_queries(self, raw: torch.Tensor) -> torch.Tensor:
        """Convert raw f32 queries [B, d] into the container's query batch."""
        ...

    def dist_ids_to_queries(self, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """dist(element[ids[b, c]], query[b]) -> f32[B, C]."""
        ...

    def pairwise_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """dist(element[ids[b, i]], element[ids[b, j]]) -> f32[B, C, C]."""
        ...

    def queries_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Make a query batch out of stored elements (self-query / build)."""
        ...

    def self_dist(self, ids: torch.Tensor) -> torch.Tensor:
        """dist(element[i], element[i]): nonzero only for zero vectors
        (the zero-element skip rule of the build)."""
        ...


class NeighborCacheScoring(abc.ABC):
    """Capability: the container can fill and score a neighbor-vector cache
    (``ops.nbr_cache``, ``ops.kernels.nbr_score``)."""

    @abc.abstractmethod
    def cache_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """bf16 vector rows [..., d] for the cache table."""

    @abc.abstractmethod
    def score_block(self, block: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """Distance for pre-gathered rows: block [B, K, d] x queries [B, d]."""

    @abc.abstractmethod
    def dist_from_dots(self, dots: torch.Tensor) -> torch.Tensor:
        """Distance from raw query . neighbor dot products (f32)."""


def supports_cache(elements) -> bool:
    """Whether ``elements`` declares the neighbor-cache capability."""
    return isinstance(elements, NeighborCacheScoring)
