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

The build updates the layer under construction in place, but never a
tensor it was handed: ``build_layers`` copies a resumed layer before it
writes to it, so a ``Granne`` snapshot taken earlier stays as it was.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import distance, frontier
from ..ops.topk import INF, UNUSED, sort_by_key
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

    ``neighbor_cache``, ``neighbor_cache_layout="tiled"`` and
    ``gather_budget`` are not ported yet (ROADMAP.md, Queue 1 item 8) and
    raise ``NotImplementedError``.
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

    def __post_init__(self):
        for name, on in (
            ("neighbor_cache=True", self.neighbor_cache),
            ("neighbor_cache_layout='tiled'", self.neighbor_cache_layout == "tiled"),
            ("gather_budget", self.gather_budget is not None),
        ):
            if on:
                raise NotImplementedError(
                    f"BuildConfig({name}) is not ported to granne_tpu_torch yet "
                    "(ROADMAP.md, Queue 1 item 8)"
                )


# ---------------------------------------------------------------------------
# Row merge: combine existing rows with incoming candidates and re-prune
# (the reference's connect_nodes / add_and_limit_neighbors).
# ---------------------------------------------------------------------------


def _merge_rows(elements, node_ids, exist, inc_ids, inc_d, node_valid, limit):
    """Merge incoming neighbor candidates into existing rows.

    node_ids: int32[N]; exist: int32[N, Ms]; inc_ids/inc_d: [N, R];
    node_valid: bool[N]; limit: max row occupancy after the merge.
    Returns int32[N, Ms] new rows (distance-sorted, -1 padded).
    """
    Ms = exist.shape[1]
    tq = elements.queries_from_ids(node_ids)
    exist_valid = (exist >= 0) & node_valid[:, None]
    exist_d = torch.where(exist_valid, elements.dist_ids_to_queries(exist, tq), INF)

    # drop incoming that duplicate an existing neighbor or the node itself
    dup = torch.any((inc_ids[:, :, None] == exist[:, None, :]) & exist_valid[:, None, :], dim=2)
    inc_valid = (inc_ids >= 0) & ~dup & node_valid[:, None] & (inc_ids != node_ids[:, None])
    inc_d = torch.where(inc_valid, inc_d, INF)

    all_ids = torch.cat([torch.where(exist_valid, exist, UNUSED), torch.where(inc_valid, inc_ids, UNUSED)], dim=1)
    all_d = torch.cat([exist_d, inc_d], dim=1)
    sd, sids = sort_by_key(all_d, all_ids)
    sel_ids, _ = select_neighbors(elements, sids, sd, sids >= 0, limit)
    if limit < Ms:
        pad = torch.full((sel_ids.shape[0], Ms - limit), UNUSED, dtype=torch.int32, device=sel_ids.device)
        sel_ids = torch.cat([sel_ids, pad], dim=1)
    return sel_ids


def _merge_rows_chunked(elements, node_ids, exist, inc_ids, inc_d, node_valid, limit, chunk):
    """``_merge_rows`` over row chunks of ``chunk`` rows, which bounds the
    [chunk, C, C] pairwise working set.  Rows are independent."""
    out = [
        _merge_rows(
            elements, node_ids[lo : lo + chunk], exist[lo : lo + chunk],
            inc_ids[lo : lo + chunk], inc_d[lo : lo + chunk], node_valid[lo : lo + chunk], limit,
        )
        for lo in range(0, node_ids.shape[0], chunk)
    ]
    if not out:
        return exist.new_full((0, exist.shape[1]), UNUSED)
    return torch.cat(out, dim=0)


# ---------------------------------------------------------------------------
# Reverse-edge application
# ---------------------------------------------------------------------------


def _apply_reverse_edges(adj, elements, tgt, src, d, *, reverse_cap, merge_chunk):
    """Deterministically apply reverse edges (``src -> tgt`` joins tgt's row),
    updating ``adj`` in place.

    tgt/src: int32[T]; d: f32[T]; invalid edges have tgt == -1.  Per target
    the ``reverse_cap`` nearest incoming edges are merged with the existing
    row; overflow beyond the row width is re-pruned with the heuristic (the
    final per-layer prune later re-limits to M_eff).
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

    n_targets = int(first.sum())  # one sync; rows past it hold no target
    utgt = torch.full((T + 1,), UNUSED, dtype=torch.int32, device=dev)
    utgt = utgt.scatter(0, torch.where(first, uidx, T), st)[:n_targets]
    exist = adj.index_select(0, utgt.long())
    new_rows = _merge_rows_chunked(
        elements, utgt, exist, inc_ids[:n_targets], inc_d[:n_targets],
        torch.ones(n_targets, dtype=torch.bool, device=dev), adj.shape[1], merge_chunk,
    )
    adj.index_copy_(0, utgt.long(), new_rows)
    return adj


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
):
    """Phase A of a wave: frozen-graph search + heuristic for each wave
    element (the search/select half of the reference's ``index_element``).
    Returns (sel_ids, sel_d, active, zero_sel)."""
    W = wave_ids.shape[0]
    q = elements.queries_from_ids(wave_ids)

    # entry point: greedy descent through all previously completed layers
    ep = torch.zeros((W,), dtype=torch.int32, device=wave_ids.device)
    ep = frontier.descend(prev_layers, elements, q, ep)

    cand_ids, cand_d = frontier.beam_search(
        adj, elements, q, ep, ef=max_search, expand=expand, max_iters=max_iters
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
):
    """Phase B of a wave: the deterministic graph mutation (the linking half
    of ``index_element``).  ``wave_ids`` must be distinct.  Updates ``adj``
    in place and returns it."""
    W = wave_ids.shape[0]
    Ms = adj.shape[1]
    rows = wave_ids.long()

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

    # forward edges; inactive rows are written back unchanged
    exist = adj.index_select(0, rows)
    if reinsert:
        # the node is already in the graph: merge the selection into its row
        fwd = _merge_rows_chunked(
            elements, wave_ids, exist, sel_ids, sel_d, active, Ms, merge_chunk
        )
    elif Ms > m_eff:
        fwd = torch.cat([sel_ids, exist.new_full((W, Ms - m_eff), UNUSED)], dim=1)
    else:
        fwd = sel_ids
    adj.index_copy_(0, rows, torch.where(active[:, None], fwd, exist))

    # reverse edges
    tgt = torch.where(active[:, None], sel_ids, UNUSED).reshape(-1)
    src = wave_ids[:, None].expand(W, m_eff).reshape(-1)
    return _apply_reverse_edges(
        adj, elements, tgt, src, sel_d.reshape(-1), reverse_cap=reverse_cap, merge_chunk=merge_chunk
    )


# ---------------------------------------------------------------------------
# Final per-layer prune pass
# ---------------------------------------------------------------------------


def prune_layer(adj, elements, *, m_eff: int, merge_chunk: int):
    """Re-limit every row to ``m_eff`` via the heuristic, in place, chunk by
    chunk (rows are independent).  Returns ``adj``."""
    N = adj.shape[0]
    for lo in range(0, N, merge_chunk):
        sl = adj[lo : lo + merge_chunk]
        n = sl.shape[0]
        node_ids = torch.arange(lo, lo + n, dtype=torch.int32, device=adj.device)
        node_valid = torch.any(sl >= 0, dim=1)
        new_rows = _merge_rows(
            elements, node_ids, sl,
            sl.new_full((n, 1), UNUSED), torch.full((n, 1), INF, device=adj.device),
            node_valid, m_eff,
        )
        adj[lo : lo + n] = torch.where(node_valid[:, None], new_rows, sl)
    return adj


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


def _run_waves(prev_layers, adj, elements, start, end, cfg: BuildConfig, m_eff, max_search, reinsert):
    """Insert (or, with ``reinsert``, re-insert back to front) the elements
    [start, end) wave by wave.  Returns ``adj``, updated in place."""
    kw = dict(m_eff=m_eff, reverse_cap=cfg.reverse_cap, merge_chunk=cfg.merge_chunk)

    def wave(lo, hi):
        ids = torch.arange(lo, hi, dtype=torch.int32, device=adj.device)
        valid = torch.ones((hi - lo,), dtype=torch.bool, device=adj.device)
        sel_ids, sel_d, active, zero_sel = search_select_phase(
            prev_layers, adj, elements, ids, valid, m_eff=m_eff, max_search=max_search,
            expand=cfg.expand, max_iters=cfg.build_max_iters,
        )
        apply_wave_edges(adj, elements, ids, valid, sel_ids, sel_d, active, zero_sel, reinsert=reinsert, **kw)

    if reinsert:
        hi = end
        while hi > start:
            lo = max(start, hi - cfg.wave_size)
            wave(lo, hi)
            hi = lo
    else:
        for lo, hi in _wave_ranges(start, end, cfg.wave_size):
            wave(lo, hi)
    return adj


def _index_layer(layers: list, counts: list, elements, cfg: BuildConfig, num_elements: int):
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

    _run_waves(prev, adj, elements, counts[-1], target, cfg, m_eff, cfg.max_search, False)
    prune_layer(adj, elements, m_eff=m_eff, merge_chunk=cfg.merge_chunk)
    if cfg.reinsert_elements:
        half = max(1, cfg.max_search // 2)
        _run_waves(prev, adj, elements, 0, target, cfg, m_eff, half, True)
        prune_layer(adj, elements, m_eff=m_eff, merge_chunk=cfg.merge_chunk)

    layers[-1] = adj
    counts[-1] = target


def build_layers(
    elements,
    cfg: BuildConfig,
    num_elements: Optional[int] = None,
    state: Optional[LayerStack] = None,
) -> LayerStack:
    """Build (or continue building) the layer stack.

    Resumable and idempotent like the reference's ``build_partial``: elements
    already indexed in ``state`` are not indexed again.  ``state`` itself is
    left unchanged.
    """
    if num_elements is None:
        num_elements = len(elements)
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
        _index_layer(layers, counts, elements, cfg, num_elements)

    while (counts[-1] if counts else 0) < num_elements:
        if layers:
            # the next layer starts as the finished one (_index_layer copies it)
            layers.append(layers[-1])
            counts.append(counts[-1])
        else:
            layers.append(empty_layer(0, cfg.num_neighbors, elements.device))
            counts.append(0)
        _index_layer(layers, counts, elements, cfg, num_elements)

    return LayerStack(layers=tuple(layers), counts=tuple(counts))

