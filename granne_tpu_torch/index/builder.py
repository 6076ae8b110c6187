"""Wave-parallel HNSW construction (port of ``granne_tpu/index/builder.py``).

A wave of W elements (1) batch-searches the graph as it stood before the
wave (entry descent through the finished layers, then an ``ef = max_search``
beam on the layer under construction), (2) runs the select-neighbors
heuristic, (3) applies the reference's zero-element and duplicate-dead-node
rules, (4) writes the forward edges (each wave element owns its row) and
(5) resolves reverse edges deterministically: edges are sorted by target,
the nearest ``reverse_cap`` incoming per target are merged with the
target's row and re-pruned with the same heuristic.

Semantics kept from the reference because they change the graph: the
geometric layer schedule, M/2 on upper layers, geometric warm-up waves,
the reverse-order reinsert pass at max_search/2, the final prune, and the
zero/duplicate skip rules.

With ``BuildConfig.neighbor_cache`` the layer under construction carries a
neighbor cache (``ops.nbr_cache``, flat or tiled): the wave beam scores
through it (K1 or K2), and the merges read existing rows' vectors from it
and write the kept vectors back, so the cache stays coherent with the
adjacency on every valid id slot (pad slots hold arbitrary vectors; their
ids are -1).

The build updates the layer under construction and its cache in place, but
never a tensor it was handed: ``build_layers`` copies a resumed layer
before it writes to it, so a ``Granne`` snapshot taken earlier stays as it
was.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import torch

from ..elements.base import supports_cache
from ..ops import distance, frontier
from ..ops.nbr_cache import make_neighbor_cache, pack_rows, rows_to_vecs
from ..ops.topk import INF, UNUSED, sort_by_key
from ..utils import trace
from ..utils.progress import ProgressBar
from . import schedule
from .graph import LayerStack, empty_layer, grow_layer
from .heuristic import EPS100, select_neighbors

_BIG = torch.iinfo(torch.int32).max  # sort key of invalid edges

# Hard element-count limit: ids are int32 (the reference's u32 analogue is
# 2^32 - 2).
MAX_ELEMENTS = 2**31 - 2


@dataclass(frozen=True)
class BuildConfig:
    """Build parameters (the reference's ``BuildConfig`` plus wave knobs).

    ``neighbor_cache`` keeps a neighbor cache of the layer under
    construction in ``neighbor_cache_layout`` ("flat": K1, "tiled": K2,
    d <= 128) for the wave beam and the merges.  ``gather_budget`` caps the
    candidates the uncached build beam scores per iteration
    (``ops.frontier.beam_search``); graph quality must be checked per
    configuration.
    """

    layer_multiplier: float = 15.0
    num_neighbors: int = 30
    max_search: int = 200
    reinsert_elements: bool = True
    expected_num_elements: Optional[int] = None
    show_progress: bool = False
    wave_size: int = 256  # elements inserted per frozen-graph wave
    expand: int = 4  # beam slots expanded per search iteration during build
    reverse_cap: int = 8  # nearest incoming reverse edges per target per wave
    merge_chunk: int = 1024  # row chunk of the batched re-prune
    build_max_iters: int | None = None  # beam iteration cap (None: to convergence)
    neighbor_cache: bool = False
    neighbor_cache_layout: str = "flat"
    gather_budget: int | None = None


def _layout(nbr_tab) -> str:
    return "tiled" if nbr_tab.ndim == 3 else "flat"


def _write_rows(tab, rows, new, keep=None):
    """``tab[rows] = new`` in place; with ``keep`` (bool[N]) only where it
    is set, the other rows keep their old contents."""
    if keep is not None:
        mask = keep.reshape(-1, *([1] * (new.ndim - 1)))
        new = torch.where(mask, new, tab.index_select(0, rows))
    tab.index_copy_(0, rows, new)


# ---------------------------------------------------------------------------
# Row merge: combine existing rows with incoming candidates and re-prune
# (the reference's connect_nodes / add_and_limit_neighbors).
# ---------------------------------------------------------------------------


def _merge_rows(elements, node_ids, exist, inc_ids, inc_d, node_valid, limit,
                exist_vecs=None, inc_vecs=None, return_vecs=False):
    """Merge incoming neighbor candidates into existing rows.

    node_ids: int32[N]; exist: int32[N, Ms]; inc_ids/inc_d: [N, R];
    node_valid: bool[N]; limit: max row occupancy after the merge.
    ``exist_vecs``/``inc_vecs`` ([N, Ms, d] / [N, R, d], both or neither)
    are the candidates' pre-gathered vectors (the cache-fed merge): the
    existing-row distances and the heuristic's pairwise matrix then come
    from them.  Returns int32[N, Ms] new rows (distance-sorted, -1 padded);
    with ``return_vecs`` also the kept vectors [N, Ms, d] (pad slots
    arbitrary), which refresh the cache without a gather.
    """
    Ms = exist.shape[1]
    tq = elements.queries_from_ids(node_ids)
    exist_valid = (exist >= 0) & node_valid[:, None]
    if exist_vecs is not None:
        exist_d = elements.score_block(exist_vecs, tq)
    else:
        exist_d = elements.dist_ids_to_queries(exist, tq)
    exist_d = torch.where(exist_valid, exist_d, INF)

    # drop incoming that duplicate an existing neighbor or the node itself
    dup = torch.any((inc_ids[:, :, None] == exist[:, None, :]) & exist_valid[:, None, :], dim=2)
    inc_valid = (inc_ids >= 0) & ~dup & node_valid[:, None] & (inc_ids != node_ids[:, None])
    inc_d = torch.where(inc_valid, inc_d, INF)

    all_ids = torch.cat([torch.where(exist_valid, exist, UNUSED), torch.where(inc_valid, inc_ids, UNUSED)], dim=1)
    all_d = torch.cat([exist_d, inc_d], dim=1)
    sel_vecs = None
    if exist_vecs is None:
        if return_vecs:
            raise ValueError("return_vecs needs the cache-fed merge")
        sd, sids = sort_by_key(all_d, all_ids)
        sel_ids, _ = select_neighbors(elements, sids, sd, sids >= 0, limit)
    else:
        perm = torch.arange(all_ids.shape[1], device=all_ids.device).expand_as(all_ids)
        sd, sids, sperm = sort_by_key(all_d, all_ids, perm)
        all_vecs = torch.cat([exist_vecs, inc_vecs], dim=1)
        svecs = torch.gather(all_vecs, 1, sperm[:, :, None].expand(-1, -1, all_vecs.shape[2]))
        out = select_neighbors(elements, sids, sd, sids >= 0, limit, cand_vecs=svecs, return_vecs=return_vecs)
        sel_ids = out[0]
        if return_vecs:
            sel_vecs = out[2]
    if limit < Ms:
        pad = torch.full((sel_ids.shape[0], Ms - limit), UNUSED, dtype=torch.int32, device=sel_ids.device)
        sel_ids = torch.cat([sel_ids, pad], dim=1)
        if sel_vecs is not None:
            vpad = sel_vecs.new_zeros((sel_vecs.shape[0], Ms - limit, sel_vecs.shape[2]))
            sel_vecs = torch.cat([sel_vecs, vpad], dim=1)
    if return_vecs:
        return sel_ids, sel_vecs
    return sel_ids


def _merge_rows_chunked(elements, node_ids, exist, inc_ids, inc_d, node_valid, limit, chunk,
                        nbr_tab=None, inc_pos=None, wave_rows=None, return_vecs=False):
    """``_merge_rows`` over row chunks of ``chunk`` rows, which bounds the
    [chunk, C, C] pairwise working set.  Rows are independent.

    ``nbr_tab`` makes the merge cache-fed: every caller passes
    ``exist == adj[node_ids]``, which is what the cache rows of
    ``node_ids`` hold, so existing vectors come from one row read per node.
    Incoming vectors are picked from the [W, d] wave block ``wave_rows``
    by their wave position ``inc_pos`` when given (an ``index_select``: the
    same bits as the JAX package's one-hot matmul), else gathered from the
    elements.  With ``return_vecs`` returns (rows, kept vectors).
    """
    cached = nbr_tab is not None
    Ms = exist.shape[1]
    rows, vecs = [], []
    for lo in range(0, node_ids.shape[0], chunk):
        nid, ii = node_ids[lo : lo + chunk], inc_ids[lo : lo + chunk]
        ev = iv = None
        if cached:
            ev = rows_to_vecs(nbr_tab, nid, Ms, elements.dim)
            if inc_pos is not None:
                ip = inc_pos[lo : lo + chunk]
                iv = wave_rows.index_select(0, ip.reshape(-1).long()).reshape(*ip.shape, -1)
            else:
                iv = elements.cache_rows(ii)
        out = _merge_rows(
            elements, nid, exist[lo : lo + chunk], ii, inc_d[lo : lo + chunk],
            node_valid[lo : lo + chunk], limit, ev, iv, return_vecs=return_vecs and cached,
        )
        if return_vecs and cached:
            rows.append(out[0])
            vecs.append(out[1])
        else:
            rows.append(out)
    if not rows:
        rows.append(exist.new_full((0, Ms), UNUSED))
        if return_vecs and cached:
            vecs.append(elements.cache_rows(exist[:0]))
    if return_vecs and cached:
        return torch.cat(rows), torch.cat(vecs)
    return torch.cat(rows)


# ---------------------------------------------------------------------------
# Reverse-edge application
# ---------------------------------------------------------------------------


def _apply_reverse_edges(adj, elements, tgt, src, d, *, reverse_cap, merge_chunk,
                         nbr_tab=None, src_pos=None, wave_rows=None):
    """Deterministically apply reverse edges (``src -> tgt`` joins tgt's row),
    updating ``adj`` (and the cache rows it rewrites) in place.

    tgt/src: int32[T]; d: f32[T]; invalid edges have tgt == -1.  Per target
    the ``reverse_cap`` nearest incoming edges are merged with the existing
    row; overflow beyond the row width is re-pruned with the heuristic (the
    final per-layer prune later re-limits to M_eff).  With a cache,
    ``src_pos`` (int32[T]) is each edge's wave position in ``wave_rows``.
    """
    T = tgt.shape[0]
    R = reverse_cap
    dev = adj.device

    # sort by (target, distance), stable: two stable passes, minor key first
    key_t = torch.where(tgt >= 0, tgt, _BIG)
    order = torch.sort(d, stable=True).indices
    order = order[torch.sort(key_t[order], stable=True).indices]
    st, sd, ss = key_t[order], d[order], src[order]

    valid = st != _BIG
    first = torch.cat([valid[:1], (st[1:] != st[:-1]) & valid[1:]])
    uidx = torch.cumsum(first.to(torch.int64), dim=0) - 1  # unique-target slot per edge
    pos = torch.arange(T, device=dev)
    seg_start = torch.cummax(torch.where(first, pos, -1), dim=0).values
    rank = pos - seg_start
    edge_ok = valid & (rank < R)

    # scatter the kept edges into [targets, R]; the rest land in a spare row T
    cell = torch.where(edge_ok, uidx * R + rank, T * R)
    inc_ids = torch.full(((T + 1) * R,), UNUSED, dtype=torch.int32, device=dev)
    inc_d = torch.full(((T + 1) * R,), INF, dtype=torch.float32, device=dev)
    inc_ids = inc_ids.scatter(0, cell, ss).view(T + 1, R)
    inc_d = inc_d.scatter(0, cell, sd).view(T + 1, R)
    inc_pos = None
    if nbr_tab is not None:
        inc_pos = torch.zeros(((T + 1) * R,), dtype=torch.int32, device=dev)
        inc_pos = inc_pos.scatter(0, cell, src_pos[order]).view(T + 1, R)

    n_targets = int(first.sum())  # one sync; rows past it hold no target
    utgt = torch.full((T + 1,), UNUSED, dtype=torch.int32, device=dev)
    utgt = utgt.scatter(0, torch.where(first, uidx, T), st)[:n_targets]
    rows = utgt.long()
    res = _merge_rows_chunked(
        elements, utgt, adj.index_select(0, rows), inc_ids[:n_targets], inc_d[:n_targets],
        torch.ones(n_targets, dtype=torch.bool, device=dev), adj.shape[1], merge_chunk,
        nbr_tab=nbr_tab, inc_pos=None if inc_pos is None else inc_pos[:n_targets],
        wave_rows=wave_rows, return_vecs=nbr_tab is not None,
    )
    if nbr_tab is None:
        adj.index_copy_(0, rows, res)
        return
    new_rows, new_vecs = res
    adj.index_copy_(0, rows, new_rows)
    nbr_tab.index_copy_(0, rows, pack_rows(new_vecs, _layout(nbr_tab), ids=new_rows))


# ---------------------------------------------------------------------------
# One wave of insertions, in two phases: A. search + select, B. graph mutation
# ---------------------------------------------------------------------------


def search_select_phase(
    prev_layers,
    adj,
    elements,
    wave_ids,
    wave_valid,
    *,
    m_eff: int,
    max_search: int,
    expand: int,
    max_iters: int | None = None,
    gather_budget: int | None = None,
    nbr_vecs=None,
):
    """Phase A of a wave: frozen-graph search + heuristic for each wave
    element (the search/select half of the reference's ``index_element``).
    ``nbr_vecs`` is the cache of ``adj``.  Returns (sel_ids, sel_d, active,
    zero_sel)."""
    W = wave_ids.shape[0]
    q = elements.queries_from_ids(wave_ids)

    # entry point: greedy descent through all previously completed layers
    ep = torch.zeros((W,), dtype=torch.int32, device=wave_ids.device)
    ep = frontier.descend(prev_layers, elements, q, ep)

    cand_ids, cand_d = frontier.beam_search(
        adj, elements, q, ep, ef=max_search, expand=expand, max_iters=max_iters,
        gather_budget=gather_budget, nbr_vecs=nbr_vecs,
    )

    # drop self hits
    cvalid = (cand_ids >= 0) & (cand_ids != wave_ids[:, None])
    cand_d = torch.where(cvalid, cand_d, INF)
    cand_ids = torch.where(cvalid, cand_ids, UNUSED)

    # zero-element skip
    active = wave_valid & (elements.self_dist(wave_ids) <= EPS100)

    sel_ids, sel_d = select_neighbors(elements, cand_ids, cand_d, cvalid, m_eff)

    # zero-distance duplicates among the raw candidates (equal to counting
    # the selected zeros in exact arithmetic, but robust to f32 noise)
    zero_sel = torch.clamp_max(torch.sum((cand_ids >= 0) & (cand_d < EPS100), dim=1), m_eff)
    return sel_ids, sel_d, active, zero_sel


def apply_wave_edges(
    adj,
    elements,
    wave_ids,
    wave_valid,
    sel_ids,
    sel_d,
    active,
    zero_sel,
    *,
    m_eff: int,
    reinsert: bool,
    reverse_cap: int,
    merge_chunk: int,
    nbr_tab=None,
):
    """Phase B of a wave: the deterministic graph mutation (the linking half
    of ``index_element``).  ``wave_ids`` must be distinct.  Updates ``adj``
    and its cache ``nbr_tab`` in place and returns ``(adj, nbr_tab)``.

    The cache rows are written by the merges from the vectors they already
    hold; the forward write comes before the reverse merge reads the cache,
    so same-wave reverse targets read post-forward rows.  Inactive wave
    rows keep their old adjacency and cache rows."""
    W = wave_ids.shape[0]
    Ms = adj.shape[1]
    rows = wave_ids.long()
    cached = nbr_tab is not None
    wave_rows = elements.cache_rows(wave_ids) if cached else None  # [W, d]

    # duplicate dead-node rule: a node whose (M/2)-th selected neighbor is a
    # ~zero-distance duplicate stays unconnected.  Duplicates in this wave are
    # invisible to the frozen-graph search, so they are counted from the
    # intra-wave distances (earlier wave positions only, as sequential
    # insertion would see them).
    pair_w = elements.pairwise_from_ids(wave_ids[None, :])[0]  # [W, W]
    lower = torch.ones((W, W), dtype=torch.bool, device=adj.device).tril(-1)
    wave_dups_before = torch.sum((pair_w < EPS100) & lower & wave_valid[None, :], dim=1)
    active = active & ~((zero_sel + wave_dups_before) > m_eff // 2)

    sel_ids = torch.where(active[:, None], sel_ids, UNUSED)
    sel_d = torch.where(active[:, None], sel_d, INF)

    # forward edges
    exist = adj.index_select(0, rows)
    fvecs = None
    if reinsert:
        # the node is already in the graph: merge the selection into its row
        res = _merge_rows_chunked(
            elements, wave_ids, exist, sel_ids, sel_d, active, Ms, merge_chunk,
            nbr_tab=nbr_tab, return_vecs=cached,
        )
        fwd, fvecs = res if cached else (res, None)
    elif Ms > m_eff:
        fwd = torch.cat([sel_ids, exist.new_full((W, Ms - m_eff), UNUSED)], dim=1)
    else:
        fwd = sel_ids
    _write_rows(adj, rows, fwd, active)
    if cached:
        if fvecs is None:  # fresh rows: their vectors from the elements
            fvecs = elements.cache_rows(fwd.clamp_min(0))
        _write_rows(nbr_tab, rows, pack_rows(fvecs, _layout(nbr_tab), ids=fwd), active)

    # reverse edges
    tgt = torch.where(active[:, None], sel_ids, UNUSED).reshape(-1)
    src = wave_ids[:, None].expand(W, m_eff).reshape(-1)
    src_pos = None
    if cached:  # each edge's source vector sits in wave_rows at its wave position
        src_pos = torch.arange(W, dtype=torch.int32, device=adj.device)[:, None].expand(W, m_eff).reshape(-1)
    _apply_reverse_edges(
        adj, elements, tgt, src, sel_d.reshape(-1), reverse_cap=reverse_cap, merge_chunk=merge_chunk,
        nbr_tab=nbr_tab, src_pos=src_pos, wave_rows=wave_rows,
    )
    return adj, nbr_tab


# ---------------------------------------------------------------------------
# Final per-layer prune pass
# ---------------------------------------------------------------------------


def prune_layer(adj, elements, *, m_eff: int, merge_chunk: int, nbr_tab=None, rebuild_cache: bool = True):
    """Re-limit every row to ``m_eff`` via the heuristic, in place, chunk by
    chunk (rows are independent).  With ``nbr_tab`` the merges are fed from
    the cache; every row can change, so the cache is then rebuilt from the
    pruned adjacency (``rebuild_cache``) or dropped.  Returns
    ``(adj, nbr_tab)``."""
    N = adj.shape[0]
    Ms = adj.shape[1]
    for lo in range(0, N, merge_chunk):
        sl = adj[lo : lo + merge_chunk]
        n = sl.shape[0]
        node_ids = torch.arange(lo, lo + n, dtype=torch.int32, device=adj.device)
        node_valid = torch.any(sl >= 0, dim=1)
        no_inc = sl.new_full((n, 1), UNUSED)
        ev = iv = None
        if nbr_tab is not None:
            ev = rows_to_vecs(nbr_tab, node_ids, Ms, elements.dim)
            iv = elements.cache_rows(no_inc)
        new_rows = _merge_rows(
            elements, node_ids, sl, no_inc, torch.full((n, 1), INF, device=adj.device),
            node_valid, m_eff, ev, iv,
        )
        adj[lo : lo + n] = torch.where(node_valid[:, None], new_rows, sl)
    if nbr_tab is None or not rebuild_cache:
        return adj, None
    return adj, make_neighbor_cache(adj, elements, rows=nbr_tab.shape[0], layout=_layout(nbr_tab))


# ---------------------------------------------------------------------------
# Build loop
# ---------------------------------------------------------------------------


def _wave_ranges(start: int, end: int, wave_size: int):
    """Geometric warm-up then fixed-size waves: a wave never exceeds the
    number of elements already in the layer, so the first elements of a
    layer form good chains."""
    cur = start
    while cur < end:
        size = min(wave_size, max(8, cur), end - cur)
        yield cur, cur + size
        cur += size


def _run_waves(prev_layers, adj, elements, start, end, cfg: BuildConfig, m_eff, max_search, reinsert,
               nbr_tab=None, group=None):
    """Insert (or, with ``reinsert``, re-insert back to front) the elements
    [start, end) wave by wave.  ``adj`` and its cache ``nbr_tab`` are
    updated in place.

    On one device each wave runs in a ``trace.span`` ("build/insert_wave"
    or "build/reinsert_wave"): one span a wave, where the JAX package counts
    one a warm-up wave or an on-device segment of waves.  With
    ``cfg.show_progress`` a ``ProgressBar`` on stderr advances a wave at a
    time.  With a ``group`` the waves are split over its ranks
    (``parallel.dp_build``) in the JAX package's mesh schedule, without a
    bar or spans."""
    if group is not None:
        _run_waves_group(prev_layers, adj, elements, start, end, cfg, m_eff, max_search, reinsert, nbr_tab, group)
        return
    kw = dict(m_eff=m_eff, reverse_cap=cfg.reverse_cap, merge_chunk=cfg.merge_chunk)
    phase = "build/reinsert_wave" if reinsert else "build/insert_wave"
    bar = ProgressBar(end - start, prefix="reinsert " if reinsert else "insert ") if cfg.show_progress else None

    def wave(lo, hi):
        with trace.span(phase):
            ids = torch.arange(lo, hi, dtype=torch.int32, device=adj.device)
            valid = torch.ones((hi - lo,), dtype=torch.bool, device=adj.device)
            sel_ids, sel_d, active, zero_sel = search_select_phase(
                prev_layers, adj, elements, ids, valid, m_eff=m_eff, max_search=max_search,
                expand=cfg.expand, max_iters=cfg.build_max_iters, gather_budget=cfg.gather_budget,
                nbr_vecs=nbr_tab,
            )
            apply_wave_edges(
                adj, elements, ids, valid, sel_ids, sel_d, active, zero_sel, reinsert=reinsert, nbr_tab=nbr_tab, **kw
            )
        if bar is not None:
            bar.add(hi - lo)

    if reinsert:
        hi = end
        while hi > start:
            lo = max(start, hi - cfg.wave_size)
            wave(lo, hi)
            hi = lo
    else:
        for lo, hi in _wave_ranges(start, end, cfg.wave_size):
            wave(lo, hi)
    if bar is not None:
        bar.finish()


def _run_waves_group(prev_layers, adj, elements, start, end, cfg, m_eff, max_search, reinsert, nbr_tab, group):
    """``_run_waves`` over a group, in the JAX package's mesh schedule: the
    wave is ``W = max(S, (wave_size // S) * S)`` for S ranks; an insert
    pass first inserts geometrically growing prefixes of ``max(S, min(W,
    cur or S))`` while the layer holds fewer than W, then the rest in waves
    of W, back to front when reinserting.  (The JAX package runs those
    waves in segments of 128, one dispatch each; the segments are whole
    waves aligned to the same end, so the waves are these.)"""
    from ..parallel import dp_build

    S = group.world
    W = max(S, (cfg.wave_size // S) * S)
    cur = start
    if not reinsert:
        while cur < min(end, W):
            size = min(max(S, min(W, cur or S)), end - cur)
            dp_build.dp_build_waves(
                group, prev_layers, adj, elements, torch.arange(cur, cur + size, dtype=torch.int32, device=adj.device),
                cfg, m_eff, max_search, nbr_tab=nbr_tab,
            )
            cur += size
    dp_build.dp_waves(
        group, prev_layers, adj, elements, cur, end, wave_size=W, m_eff=m_eff, max_search=max_search,
        expand=cfg.expand, reinsert=reinsert, reverse_cap=cfg.reverse_cap, merge_chunk=cfg.merge_chunk,
        reverse_order=reinsert, max_iters=cfg.build_max_iters, gather_budget=cfg.gather_budget, nbr_tab=nbr_tab,
    )


def _index_layer(layers: list, counts: list, elements, cfg: BuildConfig, num_elements: int, group=None):
    """Build out the last layer (the reference's
    ``index_elements_in_last_layer``)."""
    total = max(cfg.expected_num_elements or len(elements), len(elements))
    layer_idx = len(layers) - 1
    ideal = schedule.num_elements_in_layer(total, cfg.layer_multiplier, layer_idx)
    if ideal <= counts[-1]:
        return
    target = min(num_elements, ideal)
    m_eff = cfg.num_neighbors if ideal >= total else max(1, cfg.num_neighbors // 2)

    adj = grow_layer(layers[-1], target)
    if adj is layers[-1]:
        adj = adj.clone()  # never write into a tensor the caller may hold
    prev = tuple(layers[:-1])

    if cfg.show_progress:
        print(f"[granne-tpu-torch] building layer {layer_idx}: {counts[-1]} -> {target} "
              f"(M_eff={m_eff})", file=sys.stderr)

    # the cache of the layer under construction, a build accelerator only
    nbr_tab = None
    if cfg.neighbor_cache and supports_cache(elements):
        nbr_tab = make_neighbor_cache(adj, elements, rows=target, layout=cfg.neighbor_cache_layout)

    _run_waves(prev, adj, elements, counts[-1], target, cfg, m_eff, cfg.max_search, False, nbr_tab, group)
    _, nbr_tab = prune_layer(
        adj, elements, m_eff=m_eff, merge_chunk=cfg.merge_chunk, nbr_tab=nbr_tab,
        rebuild_cache=cfg.reinsert_elements,
    )
    if cfg.reinsert_elements:
        half = max(1, cfg.max_search // 2)
        _run_waves(prev, adj, elements, 0, target, cfg, m_eff, half, True, nbr_tab, group)
        # the last prune scores from the elements, not the cache: the JAX
        # package measured the cache's bf16 vectors degrading it
        prune_layer(adj, elements, m_eff=m_eff, merge_chunk=cfg.merge_chunk)

    layers[-1] = adj
    counts[-1] = target


def build_layers(
    elements,
    cfg: BuildConfig,
    num_elements: Optional[int] = None,
    state: Optional[LayerStack] = None,
    group=None,
) -> LayerStack:
    """Build (or continue building) the layer stack.

    Resumable and idempotent like the reference's ``build_partial``: elements
    already indexed in ``state`` are not indexed again.  ``state`` itself is
    left unchanged.

    With a ``group`` (``parallel.mesh.Group``) every rank calls this with the
    same elements, config and state, and each wave is split over the ranks
    (``parallel.dp_build``); the graph, its cache and the elements stay
    whole on every rank, and every rank returns the same ``LayerStack``.
    The ranks first check, in one small all-gather, that they hold equal
    element counts, widths, ``num_elements``, ``state.counts`` and config,
    and raise ``ValueError`` where they do not.
    """
    if num_elements is None:
        num_elements = len(elements)
    if group is not None:
        from ..parallel.dp_build import check_same_inputs

        check_same_inputs(group, elements, cfg, num_elements, state)
    if num_elements == 0:
        return state if state is not None else LayerStack(layers=(), counts=())
    if num_elements > MAX_ELEMENTS:
        raise ValueError(f"at most {MAX_ELEMENTS} elements can be indexed (int32 ids)")
    if num_elements > len(elements):
        raise ValueError("Cannot index more elements than exist.")
    if state is not None and state.counts and num_elements < state.counts[-1]:
        raise ValueError("Cannot index fewer elements than already in index.")
    distance.full_f32()

    layers = list(state.layers) if state is not None else []
    counts = list(state.counts) if state is not None else []

    # re-open with a wider num_neighbors: widen the rows with UNUSED padding
    # (narrower configs keep the loaded width as row capacity)
    if layers and layers[0].shape[1] < cfg.num_neighbors:
        layers = [
            torch.cat([a, a.new_full((a.shape[0], cfg.num_neighbors - a.shape[1]), UNUSED)], dim=1)
            for a in layers
        ]

    if layers:
        _index_layer(layers, counts, elements, cfg, num_elements, group)

    while (counts[-1] if counts else 0) < num_elements:
        if layers:
            # the next layer starts as the finished one (_index_layer copies it)
            layers.append(layers[-1])
            counts.append(counts[-1])
        else:
            layers.append(empty_layer(0, cfg.num_neighbors, elements.device))
            counts.append(0)
        _index_layer(layers, counts, elements, cfg, num_elements, group)

    return LayerStack(layers=tuple(layers), counts=tuple(counts))
