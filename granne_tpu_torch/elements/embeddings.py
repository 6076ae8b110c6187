"""Bag-of-embeddings ("SumEmbeddings") element container (port of
``granne_tpu/elements/embeddings.py``).

An element is a list of term ids; its vector is the sum of those terms'
rows of an embedding table, normalized (the reference's
``elements/embeddings/mod.rs:97-143``).  On the device the lists are one
dense ``int32[n, T]`` tensor with -1 padding, so a vector is a gather, a
masked sum and a normalization.  The ``T`` columns are summed one after
another, in column order: that is the JAX package's order on the CPU
(XLA's reduction over that axis), and it gives the same bits on the card.
A row of -1 only stays a zero vector, at distance 1 from itself, which is
the build's zero-element skip rule.

Two behaviours of the JAX container are not copied: ``create_embedding``
sums every term of its list (JAX pads the list to the container's width
and drops the rest), and ``extend`` widens ``terms`` with -1 columns for a
list longer than ``T`` (JAX truncates it).

The neighbor cache stores the summed unit rows (bf16, or exact f32 for a
``cache_dtype="f32"`` table), so a cached candidate costs one row read
instead of ``T`` table rows; both cache layouts take these rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import distance as D
from .base import NeighborCacheScoring


def pad_term_lists(term_lists, width: int | None = None) -> np.ndarray:
    """Ragged lists -> dense int32[n, T] with -1 padding (``width`` defaults
    to the longest list; a longer list keeps its first ``width`` terms)."""
    if width is None:
        width = max(1, max((len(t) for t in term_lists), default=1))
    out = np.full((len(term_lists), width), -1, np.int32)
    for i, terms in enumerate(term_lists):
        t = list(terms)[:width]
        out[i, : len(t)] = t
    return out


def _as_terms(term_lists, device) -> torch.Tensor:
    if isinstance(term_lists, torch.Tensor):
        return term_lists.to(device=device, dtype=torch.int32)
    if isinstance(term_lists, np.ndarray) and term_lists.ndim == 2:
        return torch.as_tensor(term_lists.astype(np.int32), device=device)
    return torch.as_tensor(pad_term_lists(term_lists), device=device)


@dataclass(frozen=True)
class SumEmbeddings(NeighborCacheScoring):
    """Elements as term lists over a shared embedding table."""

    embeddings: torch.Tensor  # f32[V, d], not normalized
    terms: torch.Tensor  # int32[n, T], -1 padding

    @classmethod
    def from_parts(cls, embeddings, term_lists, device="cuda") -> "SumEmbeddings":
        """An embedding table [V, d] and term lists (ragged lists, or a
        -1-padded [n, T] array or tensor) on ``device``."""
        emb = D.as_f32(embeddings, device)
        if emb.ndim != 2:
            raise ValueError(f"expected an embedding table [V, d], got shape {tuple(emb.shape)}")
        return cls(embeddings=emb, terms=_as_terms(term_lists, emb.device))

    # -- vectors (mod.rs:124-143) --------------------------------------------

    def _sums(self, term_rows: torch.Tensor) -> torch.Tensor:
        """int32[..., T] term ids -> f32[..., d] unnormalized sums, the T
        columns added in column order (-1 adds nothing)."""
        safe = term_rows.reshape(-1).clamp(0, self.embeddings.shape[0] - 1).long()
        rows = self.embeddings.index_select(0, safe).reshape(*term_rows.shape, self.dim)
        rows = torch.where((term_rows >= 0)[..., None], rows, 0.0)
        acc = rows[..., 0, :]
        for t in range(1, rows.shape[-2]):
            acc = acc + rows[..., t, :]
        return acc

    def create_embedding(self, term_ids) -> np.ndarray:
        """The unit vector of an ad-hoc term list (every term summed)."""
        row = torch.as_tensor(pad_term_lists([list(term_ids)]), device=self.device)
        return D.normalize(self._sums(row))[0].cpu().numpy()

    def get_terms(self, idx: int) -> list[int]:
        return [int(t) for t in self.terms[idx].cpu().tolist() if t >= 0]

    # -- container protocol ------------------------------------------------

    def __len__(self) -> int:
        return int(self.terms.shape[0])

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    @property
    def device(self) -> torch.device:
        return self.terms.device

    def get(self, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1).clamp(0, self.terms.shape[0] - 1).long()
        rows = self.terms.index_select(0, flat).reshape(*ids.shape, self.terms.shape[1])
        return D.normalize(self._sums(rows))

    def prepare_queries(self, raw) -> torch.Tensor:
        return D.normalize(D.as_f32(raw, self.device))

    def dist_ids_to_queries(self, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return D.angular_dist_gathered(self.get(ids), queries)

    def pairwise_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return D.angular_pairwise_gathered(self.get(ids))

    def queries_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids)

    def self_dist(self, ids: torch.Tensor) -> torch.Tensor:
        v = self.get(ids)
        return torch.clamp_min(1.0 - torch.sum(v * v, dim=-1), 0.0)

    # -- neighbor-vector cache capability (ops.nbr_cache) --------------------

    def cache_rows(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids).to(torch.bfloat16)

    def cache_rows_exact(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get(ids)

    def score_block(self, block: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return D.angular_dist_gathered(block, queries.to(block.dtype))

    def query_lanes(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.to(torch.bfloat16).contiguous()

    def dist_from_dots_q(self, dots: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(1.0 - dots.to(torch.float32), 0.0)

    def pairwise_from_vecs(self, vecs: torch.Tensor) -> torch.Tensor:
        return D.angular_pairwise_gathered(vecs)

    def rerank_dists(self, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return D.angular_dist_gathered(self.get(ids), queries.to(torch.float32))

    # -- functional updates --------------------------------------------------

    def permute(self, order) -> "SumEmbeddings":
        order = torch.as_tensor(order, device=self.device).long()
        return dataclasses.replace(self, terms=self.terms.index_select(0, order))

    def extend(self, term_lists) -> "SumEmbeddings":
        """Append elements; ``terms`` widens with -1 columns to hold the
        longest new list, so no term is dropped."""
        T = int(self.terms.shape[1])
        width = max(T, max((len(t) for t in term_lists), default=0))
        rows = torch.as_tensor(pad_term_lists(term_lists, width), device=self.device)
        old = self.terms
        if width > T:
            old = torch.cat([old, torch.full((old.shape[0], width - T), -1, dtype=torch.int32, device=self.device)], 1)
        return dataclasses.replace(self, terms=torch.cat([old, rows], dim=0))

    def dist(self, i: int, j: int) -> float:
        v = self.get(torch.tensor([i, j], device=self.device))
        return float(torch.clamp_min(1.0 - torch.dot(v[0], v[1]), 0.0))


def unit_rows_lane_order(container: SumEmbeddings, ids: torch.Tensor) -> torch.Tensor:
    """``container.get(ids)`` for ids [m], with the sum of squares also
    taken lane by lane in order and the square root and division correctly
    rounded: the same bits on the card and the CPU at any width, and the
    JAX package's bits on the CPU where XLA sums the lanes in order (widths
    up to 24 at least).  Used where the bits feed int8 codes."""
    sums = container._sums(container.terms.index_select(0, ids.long()))
    sq = sums * sums
    acc = sq[:, 0]
    for lane in range(1, sq.shape[1]):
        acc = acc + sq[:, lane]
    norm = torch.sqrt(acc.to(torch.float64)).to(torch.float32)
    ok = (norm > 0.0)[:, None]
    unit = (sums.to(torch.float64) / torch.where(ok, norm[:, None], 1.0).to(torch.float64)).to(torch.float32)
    return torch.where(ok, unit, sums)


def reorder_keys(container: SumEmbeddings, max_terms: int = 8) -> np.ndarray:
    """Locality sort keys (``embeddings/reorder.rs:32-56``): each element's
    term ids ordered by descending embedding norm (stable, so equal norms
    keep list order), cut to ``max_terms`` and padded with V (sorts last).
    Returns int64[n, max_terms], equal to the JAX package's."""
    norms = torch.linalg.vector_norm(container.embeddings, dim=1).cpu().numpy()
    terms = container.terms.cpu().numpy()
    V = int(container.embeddings.shape[0])
    valid = terms >= 0
    by_norm = np.where(valid, -norms[np.maximum(terms, 0)], np.inf)
    order = np.argsort(by_norm, axis=1, kind="stable")
    ranked = np.take_along_axis(np.where(valid, terms, V).astype(np.int64), order, axis=1)
    keys = np.full((terms.shape[0], max_terms), V, np.int64)
    w = min(max_terms, terms.shape[1])
    keys[:, :w] = ranked[:, :w]
    return keys
