"""Batched frontier (beam) search (port of ``granne_tpu/ops/frontier.py``).

A batch of B queries advances in lockstep.  Per query the reference's
candidate heap, result heap and visited set collapse into ONE sorted beam of
``ef`` (id, dist, expanded) entries: the first E unexpanded entries are
expanded each iteration, their neighbors are scored as one batched
contraction, and the candidates are merged back into the beam.  The search
ends when no unexpanded entry is left (or after ``max_iters`` iterations).
With ``ef=1`` the same loop is the greedy upper-layer descent.

Candidates come from one of four places:

* the plain adjacency gather plus ``elements.dist_ids_to_queries`` (the
  build and serving without a cache); ``gather_budget`` then scores only
  the first G candidates that survive the dedupe;
* a flat bf16 neighbor cache (``ops.nbr_cache``) through the fused kernel
  ``ops.kernels.nbr_score.gather_score_flat`` (K1): one row read per
  expanded node yields the neighbor ids and their dots at once;
* a tiled bf16 cache: ids from the adjacency, dots from the kernel
  ``gather_score`` (K2) through ``nbr_cache.score_cached``.  Both kernels
  take ``elements.query_lanes(queries)``, made once a search, and their
  dots become distances through ``elements.dist_from_dots_q``;
* a flat f32 cache: one row gather yields the ids and exact f32 vectors,
  scored by ``elements.score_block`` (plain PyTorch: the JAX package has no
  kernel for it either); the seeds are scored from the same exact rows.

Testing for convergence costs a device-to-host sync, so the loop tests it
only every ``_CHECK_EVERY`` iterations.  That changes nothing: once no
entry is open, an iteration selects nothing, every candidate is invalid,
and the stable merge keeps the beam as it is.
"""

from __future__ import annotations

import torch

from .kernels.nbr_score import gather_score_flat
from .nbr_cache import check_layout, row_vecs, score_cached, table_kind, unpack_ids
from .topk import INF, UNUSED, merge_sorted_topk, sort_by_key

_CHECK_EVERY = 4


def default_max_iters(ef: int, expand: int) -> int:
    """Iteration cap: ~2 expansions per beam slot plus slack."""
    return (2 * ef) // max(1, expand) + 16


def beam_search(
    adj: torch.Tensor,
    elements,
    queries: torch.Tensor,
    entry_ids: torch.Tensor,
    *,
    ef: int,
    expand: int = 1,
    max_iters: int | None = None,
    gather_budget: int | None = None,
    nbr_vecs: torch.Tensor | None = None,
):
    """Run batched beam search over one graph layer.

    Args:
      adj: int32[n_rows, M] adjacency with UNUSED=-1 padding.
      elements: an element container.
      queries: prepared query batch of B queries (``elements.prepare_queries``:
        a [B, d] tensor, or the container's own batch type such as
        ``IntQueries``, read only through the container and ``.shape``).
      entry_ids: int32[B] or int32[B, K] entry points per query.
      ef: beam width (the reference's ``max_search``).
      expand: beam slots expanded per iteration.
      max_iters: iteration cap (default ``default_max_iters``).
      gather_budget: if set (< expand*M), the candidates that survive the
        dedupe are left-compacted and only the first ``gather_budget`` are
        scored; the rest are dropped (closest parent first).  A cache
        overrides it: cache rows are read per expanded node.
      nbr_vecs: optional neighbor cache of THIS layer (any layout of
        ``ops.nbr_cache``).

    Returns:
      (ids int32[B, ef], dists f32[B, ef]), ascending by distance, padded
      with (-1, +inf).
    """
    if max_iters is None:
        max_iters = default_max_iters(ef, expand)
    B = entry_ids.shape[0]
    M = adj.shape[1]
    E = expand
    EM = E * M
    dev = adj.device
    kind = None
    if nbr_vecs is not None:
        kind = table_kind(nbr_vecs)
        check_layout(elements, "tiled" if kind == "tiled" else "flat")
        q_lanes = elements.query_lanes(queries)
        d_q = elements.dim
        gather_budget = None  # cache rows are keyed by expanded node, not candidate
    G = EM if gather_budget is None else max(1, min(gather_budget, EM))

    # seed the beam with one entry per query ([B]) or K entries ([B, K])
    if entry_ids.ndim == 1:
        entry_ids = entry_ids[:, None]
    K = min(entry_ids.shape[1], ef)
    entry_ids = entry_ids[:, :K]
    if kind == "flat-f32":
        # one exact metric for every beam entry: seeds scored as the cached candidates are
        e_d = elements.score_block(elements.cache_rows_exact(entry_ids.clamp_min(0)), queries)
    else:
        e_d = elements.dist_ids_to_queries(entry_ids, queries)
    e_valid = entry_ids >= 0
    if K > 1:  # drop duplicate seeds (first occurrence wins)
        eq_s = entry_ids[:, :, None] == entry_ids[:, None, :]
        earlier_s = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
        e_valid &= ~torch.any(eq_s & earlier_s[None] & e_valid[:, None, :], dim=2)
    e_d = torch.where(e_valid, e_d, INF)
    e_ids = torch.where(e_valid, entry_ids, UNUSED)
    if K > 1:
        e_d, e_ids = sort_by_key(e_d, e_ids)
    bids = torch.full((B, ef), UNUSED, dtype=torch.int32, device=dev)
    bd = torch.full((B, ef), INF, dtype=torch.float32, device=dev)
    bids[:, :K] = e_ids
    bd[:, :K] = e_d
    bexp = torch.zeros((B, ef), dtype=torch.bool, device=dev)

    # candidate j is a duplicate if an earlier candidate of the round equals it
    earlier = torch.ones((EM, EM), dtype=torch.bool, device=dev).tril(-1)
    no_flags = torch.zeros((B, G), dtype=torch.bool, device=dev)

    for it in range(max_iters):
        open_ = ~bexp & (bids >= 0)
        if it % _CHECK_EVERY == 0 and not bool(open_.any()):
            break

        # 1. the first E open slots (the beam is sorted, so these are best)
        open_rank = torch.cumsum(open_.to(torch.int32), dim=1) - 1
        sel = open_ & (open_rank < E)
        slot = torch.where(sel, open_rank, E).long()
        sel_ids = torch.full((B, E + 1), UNUSED, dtype=torch.int32, device=dev)
        sel_ids = sel_ids.scatter(1, slot, bids)[:, :E].contiguous()
        sel_valid = sel_ids >= 0
        bexp = bexp | sel

        # 2. candidate ids (and, from a flat cache, their dots or vectors)
        if kind == "flat-bf16":
            dots, nbrs = gather_score_flat(nbr_vecs, sel_ids, q_lanes, M=M, d=d_q)
        elif kind == "flat-f32":
            crows = nbr_vecs.index_select(0, sel_ids.reshape(-1).clamp(0, nbr_vecs.shape[0] - 1).long())
            nbrs = unpack_ids(crows, M, d_q).reshape(B, EM)
        else:
            rows = sel_ids.reshape(-1).clamp(0, adj.shape[0] - 1).long()
            nbrs = adj.index_select(0, rows).reshape(B, EM)
        cand_valid = (nbrs >= 0) & sel_valid.repeat_interleave(M, dim=1)

        # 3. dedupe: within the round (first occurrence wins) and against the beam
        eq = nbrs[:, :, None] == nbrs[:, None, :]
        cand_valid &= ~torch.any(eq & earlier[None] & cand_valid[:, None, :], dim=2)
        cand_valid &= ~torch.any(nbrs[:, :, None] == bids[:, None, :], dim=2)

        if G < EM:  # left-compact the survivors, score only the first G
            ranks = torch.cumsum(cand_valid.to(torch.int32), dim=1) - 1
            slot = torch.where(cand_valid & (ranks < G), ranks, G).long()
            nbrs = torch.full((B, G + 1), UNUSED, dtype=torch.int32, device=dev).scatter(1, slot, nbrs)[:, :G]
            cand_valid = nbrs >= 0

        # 4. distances of the whole candidate block
        if kind == "flat-bf16":
            cand_d = elements.dist_from_dots_q(dots, queries)
        elif kind == "flat-f32":
            cand_d = elements.score_block(row_vecs(crows, M, d_q).reshape(B, EM, d_q), queries)
        elif kind == "tiled":
            cand_d = score_cached(nbr_vecs, sel_ids, queries, elements, M, lanes=q_lanes)
        else:
            cand_d = elements.dist_ids_to_queries(nbrs, queries)
        cand_d = torch.where(cand_valid, cand_d, INF)
        cand_ids = torch.where(cand_valid, nbrs, UNUSED)

        # 5. merge into the sorted beam, keep the best ef
        bd, (bids, bexp) = merge_sorted_topk(bd, (bids, bexp), cand_d, (cand_ids, no_flags), ef)
    return bids, bd


def descend(layers, elements, queries, entry_ids: torch.Tensor, *, max_iters: int = 48):
    """Greedy entry-point descent through upper layers (ef=1 beam per layer),
    as the reference's ``find_entrypoint``."""
    ep = entry_ids
    for adj in layers:
        ids, _ = beam_search(adj, elements, queries, ep, ef=1, expand=1, max_iters=max_iters)
        ep = torch.where(ids[:, 0] >= 0, ids[:, 0], ep)
    return ep


def search_layers(
    layers,
    elements,
    queries: torch.Tensor,
    *,
    ef: int,
    num_neighbors: int,
    expand: int = 1,
    max_iters: int | None = None,
    descent_iters: int = 48,
    descent_ef: int = 1,
    gather_budget: int | None = None,
    nbr_vecs: torch.Tensor | None = None,
    rerank: bool = False,
    rerank_with=None,
    rerank_queries: torch.Tensor | None = None,
):
    """Full multi-layer search (``search_internal`` in the reference).

    ``layers`` is a sequence of adjacency tensors, top (smallest) first.
    ``descent_ef > 1`` widens the LAST upper-layer descent to that beam width
    and seeds the bottom beam with its entries.  ``nbr_vecs`` is a neighbor
    cache of the bottom layer.

    ``rerank=True`` re-scores the whole final beam (all ``ef`` entries) with
    ``rerank_dists`` and sorts by those distances before keeping
    ``num_neighbors``.  ``rerank_with`` swaps in another container for that
    pass (serve bf16, rerank against the f32 originals); ``rerank_queries``
    swaps in its queries (the unrounded f32 unit queries, so the pass carries
    no query-side serving-dtype error).

    Returns (ids int32[B, num_neighbors], dists f32[B, num_neighbors]).
    """
    B = queries.shape[0]
    dev = queries.device
    if len(layers) == 0:
        return (
            torch.full((B, num_neighbors), UNUSED, dtype=torch.int32, device=dev),
            torch.full((B, num_neighbors), INF, dtype=torch.float32, device=dev),
        )
    ep = torch.zeros((B,), dtype=torch.int32, device=dev)
    upper = layers[:-1]
    if descent_ef > 1 and len(upper) > 0:
        ep = descend(upper[:-1], elements, queries, ep, max_iters=descent_iters)
        seeds, _ = beam_search(
            upper[-1], elements, queries, ep, ef=descent_ef, expand=1, max_iters=descent_iters
        )
        ep = torch.where(seeds >= 0, seeds, ep[:, None])
    else:
        ep = descend(upper, elements, queries, ep, max_iters=descent_iters)
    ids, d = beam_search(
        layers[-1], elements, queries, ep, ef=ef, expand=expand, max_iters=max_iters,
        gather_budget=gather_budget, nbr_vecs=nbr_vecs,
    )
    if rerank:
        scorer = elements if rerank_with is None else rerank_with
        rd = scorer.rerank_dists(ids, queries if rerank_queries is None else rerank_queries)
        d, ids = sort_by_key(torch.where(ids >= 0, rd, INF), ids)
    return ids[:, :num_neighbors], d[:, :num_neighbors]
