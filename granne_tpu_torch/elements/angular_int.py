"""int8 quantized cosine element container (port of
``granne_tpu/elements/angular_int.py``).

f32 rows are max-abs scaled into [-127, 127] and stored as int8, with each
row's reciprocal norm computed once at ingest; the distance is
``max(0, 1 - r * |x|^-1 * |y|^-1)`` with ``r`` the exact integer dot
(``ops.distance.i8_dots``).  The codes and norms are bit-equal to the JAX
package's.

The neighbor cache stores bf16 (or, ``cache_rows_exact``, f32) *unit* rows
made from the codes, so cached scoring is one dot with the query lanes.
With the exact f32 unit query (``IntQueries.unit``, filled by
``prepare_queries`` and ``queries_from_ids``) the lanes are that query in
bf16 and the dot is the cosine; without it the lanes are the int8 codes as
bf16 (exact, up to 127) and the dot is scaled by the query's reciprocal
norm.  The JAX package's tiled route cannot score ``IntQueries``, so this
container refuses the tiled layout (``tiled_refusal``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import distance as D
from .base import NeighborCacheScoring


@dataclass(frozen=True)
class IntQueries:
    """A prepared int8 query batch: codes, reciprocal norms and, optionally,
    the unquantized f32 unit query (``unit``), which cached scoring and the
    exact rerank use.  Unpacks as ``(vecs, inv_norms)``."""

    vecs: torch.Tensor  # int8[B, d]
    inv_norms: torch.Tensor  # f32[B]
    unit: Optional[torch.Tensor] = None  # f32[B, d] unit-norm

    @property
    def shape(self):
        return self.vecs.shape

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    def __iter__(self):
        return iter((self.vecs, self.inv_norms))


def _as_i8(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int8)
    return torch.tensor(np.asarray(x, dtype=np.int8), device=device)


@dataclass(frozen=True)
class AngularIntVectors(NeighborCacheScoring):
    """Dense int8 vectors + precomputed reciprocal norms."""

    vectors: torch.Tensor  # int8[n, d]
    inv_norms: torch.Tensor  # f32[n], 0.0 for zero rows
    # the quantizer of ``from_raw`` ("trunc" | "nearest"); ``extend`` reuses it
    rounding: str = "trunc"

    tiled_refusal = (
        "int8 elements feed the flat layout only (the JAX package's tiled route "
        "cannot score int8 queries)"
    )

    # -- construction ------------------------------------------------------

    @classmethod
    def from_raw(cls, raw, rounding: str = "trunc", device="cuda") -> "AngularIntVectors":
        """Quantize f32 [n, d] rows: ``"trunc"`` truncates as the reference
        does, ``"nearest"`` rounds to nearest (same format, about half the
        quantization error)."""
        arr = D.as_f32(raw, device)
        if arr.ndim != 2:
            raise ValueError(f"expected [n, d] array, got shape {tuple(arr.shape)}")
        q = D.quantize_i8(arr, rounding=rounding)
        return cls(vectors=q, inv_norms=D.inv_norms_i8(q), rounding=rounding)

    @classmethod
    def from_quantized(cls, vectors, device="cuda") -> "AngularIntVectors":
        """Wrap int8 codes [n, d]; ``rounding`` keeps its default, as in the
        JAX package (an element file does not record it)."""
        v = _as_i8(vectors, device)
        return cls(vectors=v, inv_norms=D.inv_norms_i8(v))

    def dequantized(self):
        """A bf16 unit-row serving copy (``AngularVectors``): traversal then
        runs on the bf16 path, and ``search_layers(rerank=True,
        rerank_with=<this container>, rerank_queries=<f32 unit queries>)``
        re-scores the final beam exactly against the codes."""
        from .angular import AngularVectors

        unit = self.vectors.to(torch.float32) * self.inv_norms[:, None]
        return AngularVectors(vectors=unit.to(torch.bfloat16))

    # -- container protocol ------------------------------------------------

    def __len__(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        return ids.reshape(-1).clamp(0, self.vectors.shape[0] - 1).long()

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        return self.vectors.index_select(0, self._rows(ids)).reshape(*ids.shape, self.dim)

    def _get_inv_norms(self, ids: torch.Tensor) -> torch.Tensor:
        return self.inv_norms.index_select(0, self._rows(ids)).reshape(ids.shape)

    def _unit_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The exact dequantized unit rows of ``ids``: f32[..., d]."""
        return self.get(ids).to(torch.float32) * self._get_inv_norms(ids)[..., None]

    def prepare_queries(self, raw) -> IntQueries:
        raw = D.as_f32(raw, self.device)
        q = D.quantize_i8(raw)
        return IntQueries(q, D.inv_norms_i8(q), unit=D.normalize(raw))

    def dist_ids_to_queries(self, ids: torch.Tensor, queries) -> torch.Tensor:
        qv, qn = queries
        return D.i8_dist_gathered(self.get(ids), self._get_inv_norms(ids), qv, qn)

    def pairwise_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return D.i8_pairwise_gathered(self.get(ids), self._get_inv_norms(ids))

    def pairwise_from_vecs(self, vecs: torch.Tensor) -> torch.Tensor:
        """Pairwise distances of pre-gathered unit rows [B, C, d] (cache rows)."""
        return D.angular_pairwise_gathered(vecs)

    def queries_from_ids(self, ids: torch.Tensor) -> IntQueries:
        """Stored rows as queries; ``unit`` is the row's dequantized unit vector."""
        v = self.get(ids)
        inv = self._get_inv_norms(ids)
        return IntQueries(v, inv, unit=v.to(torch.float32) * inv[..., None])

    # -- neighbor-vector cache capability (ops.nbr_cache) --------------------

    def cache_rows(self, ids: torch.Tensor) -> torch.Tensor:
        return self._unit_rows(ids).to(torch.bfloat16)

    def cache_rows_exact(self, ids: torch.Tensor) -> torch.Tensor:
        return self._unit_rows(ids)

    def score_block(self, block: torch.Tensor, queries: IntQueries) -> torch.Tensor:
        """Distance of pre-gathered unit rows [B, K, d] to the queries: with
        ``unit`` 1 - dot (the query cast to the rows' dtype), else the codes
        (cast the same way) and their reciprocal norm."""
        if queries.unit is not None:
            return D.angular_dist_gathered(block, queries.unit.to(block.dtype))
        qv, qn = queries
        dots = torch.bmm(block.to(torch.float32), qv.to(block.dtype).to(torch.float32)[:, :, None])[..., 0]
        return torch.clamp_min(1.0 - dots * qn[:, None], 0.0)

    def query_lanes(self, queries: IntQueries) -> torch.Tensor:
        """``unit`` in bf16 when present, else the int8 codes as bf16 (exact)."""
        lanes = queries.unit if queries.unit is not None else queries.vecs
        return lanes.to(torch.bfloat16).contiguous()

    def dist_from_dots_q(self, dots: torch.Tensor, queries: IntQueries) -> torch.Tensor:
        if queries.unit is not None:
            return torch.clamp_min(1.0 - dots.to(torch.float32), 0.0)
        return torch.clamp_min(1.0 - dots.to(torch.float32) * queries.inv_norms[:, None], 0.0)

    def rerank_dists(self, ids: torch.Tensor, queries) -> torch.Tensor:
        """Exact f32 re-scoring of a final beam [B, K]: dequantized unit rows
        against ``queries`` given as ``IntQueries`` (its ``unit`` if
        present), as a plain f32|bf16 [B, d] unit tensor (the dequantized
        serving route's queries), or as a ``(vecs, inv_norms)`` pair."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(torch.float32)
        elif getattr(queries, "unit", None) is not None:
            q = queries.unit.to(torch.float32)
        else:
            qv, qn = queries
            q = qv.to(torch.float32) * qn[:, None]
        return D.angular_dist_gathered(self._unit_rows(ids), q)

    def self_dist(self, ids: torch.Tensor) -> torch.Tensor:
        # dist(x, x) is 0 unless x is the zero row (then 1)
        inv = self._get_inv_norms(ids)
        return torch.where(inv > 0.0, 0.0, 1.0)

    def permute(self, order) -> "AngularIntVectors":
        order = torch.as_tensor(order, device=self.device).long()
        return dataclasses.replace(
            self, vectors=self.vectors.index_select(0, order), inv_norms=self.inv_norms.index_select(0, order)
        )

    def extend(self, raw) -> "AngularIntVectors":
        """Functional append, quantized with this container's ``rounding``."""
        q = D.quantize_i8(D.as_f32(raw, self.device), rounding=self.rounding)
        return dataclasses.replace(
            self,
            vectors=torch.cat([self.vectors, q], dim=0),
            inv_norms=torch.cat([self.inv_norms, D.inv_norms_i8(q)], dim=0),
        )

    # -- convenience -------------------------------------------------------

    def dist(self, i: int, j: int) -> float:
        """Scalar distance between stored elements (integer dot)."""
        r = torch.sum(self.vectors[i].to(torch.int64) * self.vectors[j].to(torch.int64)).to(torch.float32)
        cos = r * self.inv_norms[i] * self.inv_norms[j]
        return float(torch.clamp_min(1.0 - cos, 0.0))
