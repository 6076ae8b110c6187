"""Locality reordering of a built index (port of ``granne_tpu/index/reorder.py``).

Ids are renumbered so that elements close in the graph get close ids: better
page and cache locality for the memory-mapped host serving path
(``native.serve.HostGranne``).  The reference's key is each element's
"entrypoint trail", the node it reaches in each of the top ``MAX_TRAIL``
upper layers by a greedy descent (``reorder.rs:177-207``); within each
layer's band of ids the elements are sorted by their trails, so every layer
stays an id prefix (``compute_order``, ``reorder.rs:127-174``).  The
adjacency is then rewritten through the map and the elements permuted
(``reorder.rs:209-278``).

The trails run the port's beam (``ef=1``, ``expand=1``) on the elements'
device in a host loop over batches; a query's beam does not depend on the
other queries of its batch, so a batch on the card is large.  The sort is
numpy; the rewrite runs in torch on the layers' device.

Every function returns ``order`` with ``order[new_id] = old_id``, so a
caller translates ids found in the reordered index back to the old ones
(the reference's doctest contract, ``reorder.rs:19-57``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import frontier
from .graph import LayerStack

MAX_TRAIL = 8  # the reference caps the trail at 8 upper layers (reorder.rs:142-158)
TRAIL_BATCH_CPU, TRAIL_BATCH_CARD = 1024, 65536  # elements a trail batch


def _entrypoint_trails(layers: LayerStack, elements, batch: int | None = None) -> np.ndarray:
    """For each element, the ef=1 descent trail through the top ``MAX_TRAIL``
    upper layers: int32[n, L], the topmost layer first."""
    n = layers.num_elements
    upper = layers.layers[:-1][-MAX_TRAIL:]
    if len(upper) == 0:
        return np.zeros((n, 0), np.int32)
    dev = elements.device
    batch = batch or (TRAIL_BATCH_CPU if dev.type == "cpu" else TRAIL_BATCH_CARD)
    trails = torch.empty((n, len(upper)), dtype=torch.int32, device=dev)
    for lo in range(0, n, batch):
        ids = torch.arange(lo, min(n, lo + batch), dtype=torch.int32, device=dev)
        q = elements.queries_from_ids(ids)
        ep = torch.zeros_like(ids)
        for li, adj in enumerate(upper):
            r, _ = frontier.beam_search(adj, elements, q, ep, ef=1, expand=1)
            ep = torch.where(r[:, 0] >= 0, r[:, 0], ep)
            trails[lo : lo + len(ids), li] = ep
    return trails.cpu().numpy()


def banded_order(counts, keys: np.ndarray) -> np.ndarray:
    """The layer-respecting order of per-element keys [n, K]: within each
    layer's band of ids, sorted by the keys (column 0 most significant),
    ties broken by old id.  With the entrypoint trails as keys this is the
    locality order.  Returns ``order`` with ``order[new_id] = old_id``."""
    order = np.empty(keys.shape[0], np.int64)
    prev = 0
    for count in counts:
        band = np.arange(prev, count)
        if len(band):
            # np.lexsort's PRIMARY key is the LAST column: keys[:, 0] goes
            # last, the old id first as the final tiebreak
            cols = [band] + [keys[band, c] for c in reversed(range(keys.shape[1]))]
            order[prev:count] = band[np.lexsort(cols)]
        prev = count
    return order


def compute_order(layers: LayerStack, elements) -> np.ndarray:
    """Layer-respecting locality order; ``order[new_id] = old_id``."""
    return banded_order(layers.counts, _entrypoint_trails(layers, elements))


def order_by_keys(layers: LayerStack, keys) -> np.ndarray:
    """Layer-respecting stable sort over external per-element keys
    (``reorder_by_keys``'s order, reorder.rs:90-125).

    ``keys`` is [n] or [n, K] (K columns compared left to right).  Returns
    ``order`` with ``order[new_id] = old_id``.
    """
    keys = np.asarray(keys)
    if keys.ndim == 1:
        keys = keys[:, None]
    n = layers.num_elements
    if keys.shape[0] != n:
        raise ValueError(f"need one key per element ({n}), got {keys.shape[0]}")
    return banded_order(layers.counts, keys)


def reorder_by_keys(layers: LayerStack, elements, keys):
    """Reorder a built index by external keys (reorder.rs:90-125).
    Returns (layers, elements, order) with ``order[new_id] = old_id``."""
    return reorder_index(layers, elements, order_by_keys(layers, keys))


def reorder_index(layers: LayerStack, elements, order=None):
    """Renumber a built index; returns (layers, elements, order) with
    ``order[new_id] = old_id``.

    ``order=None`` computes the entrypoint-trail order (``Granne::reorder``,
    reorder.rs:59-82); a given permutation is applied as it is
    (``reorder_by_keys``).  It must keep every layer an id prefix.
    """
    n = layers.num_elements
    if order is None:
        order = compute_order(layers, elements)
    order = np.asarray(order, np.int64)
    if order.shape != (n,) or not np.array_equal(np.sort(order), np.arange(n)):
        raise ValueError("order must be a permutation of 0..n")
    for count in layers.counts[:-1]:
        if count and order[:count].max() >= count:
            raise ValueError(f"order must keep every layer an id prefix (band [0, {count}) leaves it)")
    dev = layers.layers[0].device if len(layers) else elements.device
    o = torch.as_tensor(order, device=dev)
    inv = torch.empty(n, dtype=torch.int32, device=dev)
    inv[o] = torch.arange(n, dtype=torch.int32, device=dev)
    new_layers = []
    for adj, count in zip(layers.layers, layers.counts):
        # new row r = the old row of order[r], its ids mapped (reorder.rs:209-278)
        rows = adj.index_select(0, o[:count])
        new_layers.append(torch.where(rows >= 0, inv[rows.clamp_min(0).long()], rows))
    return LayerStack(layers=tuple(new_layers), counts=tuple(layers.counts)), elements.permute(o), order
