"""Batched HNSW neighbor-selection heuristic (port of
``granne_tpu/index/heuristic.py``).

Given distance-sorted candidates, keep candidate ``j`` iff
``d(query, j) <= d(k, j)`` for every already-kept ``k``, up to
``max_neighbors``; with at most ``max_neighbors`` valid candidates the
heuristic is bypassed (the reference's ``select_neighbors``).

The pairwise candidate distances are one batched contraction; the keep rule
stays sequential in ``j``: C small steps per call, which in eager PyTorch is
C rounds of launches.  It is the build's likely host-bound spot and has no
kernel in the JAX package either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import compact_by_mask

EPS100 = float(np.float32(100.0) * np.finfo(np.float32).eps)  # zero/dup threshold

# Tie tolerance for the keep rule: query->candidate and candidate->candidate
# distances come from different contractions, so exact duplicates can differ
# by float noise; without slack they would be dropped nondeterministically.
TIE_EPS = 1e-6


def select_neighbors(elements, cand_ids, cand_d, valid, max_neighbors: int):
    """Batched select_neighbors.

    Args:
      cand_ids: int32[B, C] candidate ids, ascending by distance, -1 invalid.
      cand_d: f32[B, C] distances to the (implicit) query.
      valid: bool[B, C].
      max_neighbors: M.

    Returns (ids int32[B, M], dists f32[B, M]): kept neighbors in distance
    order, padded with (-1, inf).
    """
    C = cand_ids.shape[1]
    pair = elements.pairwise_from_ids(cand_ids)  # [B, C, C]
    bypass = valid.sum(dim=1) <= max_neighbors
    # closer[b, j, k]: kept k would be strictly closer to j than the query is.
    # The reference stops at max_neighbors keeps; the cap is applied after the
    # loop (compact_by_mask takes the first M), which gives the same set since
    # a keep decision never looks forward.
    closer = pair < (cand_d[:, :, None] - TIE_EPS)
    keep = torch.zeros_like(valid)
    for j in range(C):
        keep[:, j] = valid[:, j] & ~torch.any(keep & closer[:, j, :], dim=1)
    keep = torch.where(bypass[:, None], valid, keep)
    return compact_by_mask(cand_ids, cand_d, keep, max_neighbors)
