"""f32 cosine ("angular") element container (port of
``granne_tpu/elements/angular.py``).

Vectors are L2-normalized on ingest so the distance is ``max(0, 1 - dot)``.
Storage is one dense ``float32[n, d]`` device tensor; ``as_bf16`` makes the
bf16 serving copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import distance as D
from .base import NeighborCacheScoring


@dataclass(frozen=True)
class AngularVectors(NeighborCacheScoring):
    """Dense unit-norm vectors with batched cosine distance."""

    vectors: torch.Tensor  # float32|bfloat16 [n, d], rows unit-norm (or zero)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_raw(cls, raw, device="cuda") -> "AngularVectors":
        """Build from unnormalized f32 data [n, d]; normalizes each row."""
        arr = D.as_f32(raw, device)
        if arr.ndim != 2:
            raise ValueError(f"expected [n, d] array, got shape {tuple(arr.shape)}")
        return cls(vectors=D.normalize(arr))

    @classmethod
    def from_normalized(cls, vectors, device="cuda") -> "AngularVectors":
        return cls(vectors=D.as_f32(vectors, device))

    def as_bf16(self) -> "AngularVectors":
        """A bfloat16 serving copy (half the gathered bytes; dots still
        accumulate in f32).  Build with the f32 container, serve with this."""
        return dataclasses.replace(self, vectors=self.vectors.to(torch.bfloat16))

    # -- container protocol ------------------------------------------------

    def __len__(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1).clamp(0, self.vectors.shape[0] - 1).long()
        return self.vectors.index_select(0, flat).reshape(*ids.shape, self.dim)

    def prepare_queries(self, raw: torch.Tensor) -> torch.Tensor:
        # normalize in f32, then match the element dtype (bf16 serving copy)
        return D.normalize(D.as_f32(raw, self.device)).to(self.vectors.dtype)

    def dist_ids_to_queries(self, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return D.angular_dist_gathered(self.get(ids), queries)

    def pairwise_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return D.angular_pairwise_gathered(self.get(ids))

    def queries_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids)

    # -- neighbor-vector cache capability (ops.nbr_cache) --------------------

    def cache_rows(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids).to(torch.bfloat16)

    def cache_rows_exact(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids).to(torch.float32)

    def score_block(self, block: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return D.angular_dist_gathered(block, queries.to(block.dtype))

    def query_lanes(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.to(torch.bfloat16).contiguous()

    def dist_from_dots_q(self, dots: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(1.0 - dots.to(torch.float32), 0.0)

    def pairwise_from_vecs(self, vecs: torch.Tensor) -> torch.Tensor:
        return D.angular_pairwise_gathered(vecs)

    def rerank_dists(self, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """Exact on the f32 container; on the bf16 copy the same bf16 rows
        with f32 accumulation (pass the f32 container as ``rerank_with``
        for a precision gain)."""
        return D.angular_dist_gathered(self.get(ids).to(torch.float32), queries.to(torch.float32))

    def self_dist(self, ids: torch.Tensor) -> torch.Tensor:
        v = self.get(ids).to(torch.float32)
        return torch.clamp_min(1.0 - torch.sum(v * v, dim=-1), 0.0)

    def permute(self, order) -> "AngularVectors":
        """A new container whose row ``i`` is this one's row ``order[i]``
        (rows gathered on the container's device, in its dtype)."""
        order = torch.as_tensor(order, device=self.device).long()
        return dataclasses.replace(self, vectors=self.vectors.index_select(0, order))

    def extend(self, raw) -> "AngularVectors":
        """Functional append: a new container; this one is left as it is."""
        new = D.normalize(D.as_f32(raw, self.device)).to(self.vectors.dtype)
        return dataclasses.replace(self, vectors=torch.cat([self.vectors, new], dim=0))

    # -- convenience -------------------------------------------------------

    def dist(self, i: int, j: int) -> float:
        """Scalar distance between stored elements."""
        vi = self.vectors[i].to(torch.float32)
        vj = self.vectors[j].to(torch.float32)
        return float(torch.clamp_min(1.0 - torch.dot(vi, vj), 0.0))
