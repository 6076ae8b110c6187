"""Exact brute-force index: one dense scan (port of ``granne_tpu/models/brute.py``).

Serves as the exact engine at small and medium scale and as the ground
truth generator for recall checks.  The JAX package ranks with
``lax.approx_max_k``, a TPU partial reduction; here the top-k is an exact
``torch.topk``, so the port's recall is at least the JAX package's.

Every product runs on f32 operands (bf16 and int8 storage are upcast, which
is exact), so only the f32 accumulation rounds, as with JAX's
``preferred_element_type=float32``.  The JAX package has no Pallas kernel
here: the scan is a plain matrix product.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import distance as D
from ..ops.topk import top_k


def _brute_topk(xb, q, *, k):
    """bf16 rows x bf16 queries, f32 accumulation, exact top-k."""
    dots = q.to(torch.float32) @ xb.to(torch.float32).T
    v, i = torch.topk(dots, k, dim=1)
    return i.to(torch.int32), torch.clamp_min(1.0 - v, 0.0)


def _brute_topk_i8(xi, inv_norm, q, *, k):
    # int8 rows and bf16-rounded queries (both exact in f32); cosine =
    # dot * inv_norm (the query is unit norm; its bf16 noise is shared)
    dots = q.to(torch.bfloat16).to(torch.float32) @ xi.to(torch.float32).T
    v, i = torch.topk(dots * inv_norm[None, :], k, dim=1)
    return i.to(torch.int32), torch.clamp_min(1.0 - v, 0.0)


def merge_chunk_topk(best_v: np.ndarray, best_i: np.ndarray, v: torch.Tensor, i: torch.Tensor, k: int):
    """Fold one chunk's candidates (best first, possibly fewer than ``k``)
    into a running numpy top-``k``; equal scores keep the earlier entry."""
    all_v = np.concatenate([best_v, v.cpu().numpy()], axis=1)
    all_i = np.concatenate([best_i, i.cpu().numpy().astype(np.int64)], axis=1)
    pos = np.argsort(-all_v, kind="stable", axis=1)[:, :k]
    return np.take_along_axis(all_v, pos, axis=1), np.take_along_axis(all_i, pos, axis=1)


def exact_topk(x, q, k: int, *, chunk: int = 262144):
    """Exact cosine ground truth: f32 scores, ties to the lower id.

    Chunked over the database so a multi-million-row scan never holds a
    [B, n] score matrix.  ``x``: f32[n, d] unit-norm rows (numpy or tensor;
    a tensor is scanned where it lies); ``q``: f32[B, d] unit-norm queries.
    Returns numpy (ids int64[B, k], dists f32[B, k]).
    """
    dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    qt = D.as_f32(q, dev)
    best_v = np.full((qt.shape[0], k), -np.inf, np.float32)
    best_i = np.full((qt.shape[0], k), -1, np.int64)
    for lo in range(0, x.shape[0], chunk):
        v, i = top_k(qt @ D.as_f32(x[lo : lo + chunk], dev).T, k)
        best_v, best_i = merge_chunk_topk(best_v, best_i, v, i + lo, k)
    return best_i, np.maximum(0.0, 1.0 - best_v)


@dataclass(frozen=True)
class BruteForceIndex:
    """Exact cosine top-k over unit-norm rows (bf16 or int8 storage)."""

    vectors: torch.Tensor  # bf16[n_pad, d] or i8[n_pad, d]
    scale: torch.Tensor  # f32[n_pad] per-row scale to undo storage quantization
    n_total: int

    @classmethod
    def build(cls, raw_vectors, *, storage: str = "bfloat16", device="cuda") -> "BruteForceIndex":
        """storage: 'bfloat16' (default) or 'int8' (half the bytes read)."""
        if storage not in ("bfloat16", "int8"):
            raise ValueError(f"storage must be 'bfloat16' or 'int8', got {storage!r}")
        x = D.normalize(D.as_f32(raw_vectors, device))
        n = x.shape[0]
        pad = (-n) % 128  # the JAX package's row padding, kept so both hold the same arrays
        if pad:
            x = torch.cat([x, torch.zeros((pad, x.shape[1]), dtype=torch.float32, device=x.device)])
        if storage == "int8":
            xi = D.quantize_i8(x)
            return cls(vectors=xi, scale=D.inv_norms_i8(xi), n_total=n)
        return cls(
            vectors=x.to(torch.bfloat16),
            scale=torch.ones((x.shape[0],), dtype=torch.float32, device=x.device),
            n_total=n,
        )

    def search_batch(self, queries, num_neighbors: int = 10):
        """Top ``num_neighbors`` (ids int32[B, k], dists f32[B, k]), nearest first."""
        q = D.normalize(D.as_f32(queries, self.vectors.device))
        if self.vectors.dtype == torch.int8:
            ids, dists = _brute_topk_i8(self.vectors, self.scale, q, k=num_neighbors)
        else:
            ids, dists = _brute_topk(self.vectors, q.to(torch.bfloat16), k=num_neighbors)
        return torch.where(ids < self.n_total, ids, -1), dists
