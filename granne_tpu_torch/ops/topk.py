"""Sorted top-k / masked compaction helpers (port of ``granne_tpu/ops/topk.py``).

The JAX package merges with a bitonic network, a TPU choice; here a merge is
one stable ``torch.sort`` over the concatenation.
"""

from __future__ import annotations

import torch

INF = float("inf")
UNUSED = -1  # adjacency padding sentinel


def sort_by_key(key: torch.Tensor, *values: torch.Tensor):
    """Stable ascending sort of ``key`` along the last axis, carrying ``values``."""
    sk, order = torch.sort(key, dim=-1, stable=True)
    return (sk,) + tuple(torch.gather(v, -1, order) for v in values)


def merge_sorted_topk(a_d, a_vals, b_d, b_vals, k: int):
    """Merge two keyed sets along the last axis; keep the ``k`` smallest,
    sorted ascending.  Ties keep the ``a`` side (stable sort over
    ``[a, b]``), and ``b`` need not be sorted.

    ``a_vals``/``b_vals`` are tuples of same-shaped value tensors carried
    along.  Returns ``(keys[..., :k], tuple of values[..., :k])``.
    """
    d = torch.cat([a_d, b_d], dim=-1)
    vals = [torch.cat([a, b], dim=-1) for a, b in zip(a_vals, b_vals)]
    sd, *svals = sort_by_key(d, *vals)
    return sd[..., :k], tuple(v[..., :k] for v in svals)


def compact_by_mask(ids: torch.Tensor, dists: torch.Tensor, keep: torch.Tensor, k: int):
    """Left-compact kept entries into fixed-width [B, k] buffers.

    ``ids``/``dists``/``keep`` are [B, C]; entries with ``keep`` move to the
    front in order (at most ``k``); the rest is padded with (-1, +inf).
    Entries that do not fit land in a spare column ``k`` that is cut off,
    so no boolean indexing waits on the device.
    """
    B = ids.shape[0]
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    slot = torch.where(keep & (rank < k), rank, k).long()
    out_ids = torch.full((B, k + 1), UNUSED, dtype=ids.dtype, device=ids.device)
    out_d = torch.full((B, k + 1), INF, dtype=dists.dtype, device=dists.device)
    out_ids = out_ids.scatter(1, slot, ids)
    out_d = out_d.scatter(1, slot, dists)
    return out_ids[:, :k], out_d[:, :k]
