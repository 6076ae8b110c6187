"""Data-parallel wave insertion over a process group (port of
``granne_tpu/parallel/dp_build.py``).

The build-time counterpart of sharded serving: the expensive half of a
wave (entry descent, the ``ef`` beam over the frozen graph, the
select-neighbors heuristic) is independent per element, so each rank runs
it on its own contiguous slice of the wave (data parallelism over
insertions, the reference's rayon ``par_iter``).  The graph mutation must
be the same everywhere, so every rank all-gathers the selected edges and
applies the same deterministic forward write and reverse-edge merge to its
replica of the layer.

There is one wave implementation: ``builder.search_select_phase`` (the
split half) and ``builder.apply_wave_edges`` (the replicated half) are the
functions the one-device build composes, so a build over a group inherits
every builder rule (the intra-wave duplicate rule, the reinsert merge, the
reverse-edge heuristic).  ``build_layers(..., group=...)`` drives the full
multi-layer schedule through this step.

Replicated on every rank: the layer under construction, the finished
layers, the elements and, with ``BuildConfig.neighbor_cache``, the cache
(each rank's beam reads its own copy through K1 or K2, and the replicated
merge refreshes every copy alike).  A rank pays the whole graph's and
cache's memory, as in the JAX package; the search's operations divide by
the ranks.

The JAX package runs a segment of waves in one on-device loop per dispatch
and keys its compiled programs by their arguments.  Here every wave is a
host step of eager operations: nothing is compiled per key, and every
``BuildConfig`` field takes effect in every call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..index import builder as B
from .mesh import Group


def check_same_inputs(group: Group, elements, cfg, num_elements: int, state) -> None:
    """Raise ``ValueError`` on every rank unless all ranks hold the same
    element count and width, ``num_elements``, ``state.counts`` and config
    (one small all-gather), rather than hang in a later collective or build
    different graphs."""
    mine = (len(elements), elements.dim, num_elements, tuple(state.counts) if state is not None else (), cfg)
    every = [None] * group.world
    dist.all_gather_object(every, mine, group=group.pg)
    if any(other != every[0] for other in every):
        raise ValueError(
            "the ranks of a data-parallel build hold different inputs "
            "(len(elements), dim, num_elements, state.counts, config): "
            + "; ".join(f"rank {r}: {other[:4]}" for r, other in enumerate(every))
        )


def _gather_wave(group: Group, sel_ids, sel_d, active, zero_sel):
    """Every rank's phase-A results in rank order, on every rank: one
    all-gather of an int32 buffer [w, 2·m + 2] per rank (``sel_d``
    bit-viewed, so the distances arrive exactly).  gloo moves host copies,
    NCCL the tensors on the card."""
    m = sel_ids.shape[1]
    packed = torch.cat(
        [sel_ids, sel_d.view(torch.int32), active[:, None].to(torch.int32), zero_sel[:, None].to(torch.int32)],
        dim=1,
    )
    src = packed.cpu() if group.on_host else packed.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts).to(sel_ids.device)
    return out[:, :m], out[:, m : 2 * m].view(torch.float32), out[:, 2 * m] != 0, out[:, 2 * m + 1]


def dp_wave_step(
    group: Group,
    prev_layers: tuple,
    adj: torch.Tensor,
    elements,
    wave_ids: torch.Tensor,
    wave_valid: torch.Tensor,
    *,
    m_eff: int,
    max_search: int,
    expand: int,
    reinsert: bool,
    reverse_cap: int,
    merge_chunk: int,
    max_iters: int | None = None,
    gather_budget: int | None = None,
    nbr_tab: torch.Tensor | None = None,
):
    """One wave split over the group; ``adj`` and ``nbr_tab`` are updated
    in place and returned.

    Every rank passes the whole padded wave (int32 ids and bool validity,
    length W a multiple of the world size S).  Rank r searches positions
    ``[r·W/S, (r+1)·W/S)`` (``shard_map``'s ``P(SHARD_AXIS)`` split), the
    results are all-gathered, and every rank applies the wave's valid
    positions in wave order: the slices are contiguous, so that is the
    wave's own order, and the intra-wave duplicate rule sees what
    sequential insertion would.  Padding never reaches the replicated half
    (``apply_wave_edges`` needs distinct ids)."""
    S, W = group.world, wave_ids.shape[0]
    if W % S:
        raise ValueError(f"a wave of {W} does not split over {S} ranks")
    w = W // S
    mine = slice(group.rank * w, (group.rank + 1) * w)
    found = B.search_select_phase(
        prev_layers, adj, elements, wave_ids[mine], wave_valid[mine],
        m_eff=m_eff, max_search=max_search, expand=expand,
        max_iters=max_iters, gather_budget=gather_budget, nbr_vecs=nbr_tab,
    )
    sel_ids, sel_d, active, zero_sel = _gather_wave(group, *found)
    keep = wave_valid.nonzero().squeeze(1)
    if keep.numel():
        B.apply_wave_edges(
            adj, elements, wave_ids[keep], wave_valid[keep], sel_ids[keep], sel_d[keep], active[keep],
            zero_sel[keep], m_eff=m_eff, reinsert=reinsert, reverse_cap=reverse_cap, merge_chunk=merge_chunk,
            nbr_tab=nbr_tab,
        )
    return adj, nbr_tab


def dp_waves(
    group: Group,
    prev_layers: tuple,
    adj: torch.Tensor,
    elements,
    start: int,
    end: int,
    *,
    wave_size: int,
    m_eff: int,
    max_search: int,
    expand: int,
    reinsert: bool,
    reverse_cap: int,
    merge_chunk: int,
    reverse_order: bool = False,
    max_iters: int | None = None,
    gather_budget: int | None = None,
    nbr_tab: torch.Tensor | None = None,
):
    """Every wave of ``[start, end)`` through ``dp_wave_step`` (the
    counterpart of JAX's ``dp_waves_while``, a host loop here).  Wave w
    holds ``lo + arange(wave_size)`` with ``lo = end - (w+1)·wave_size``
    (``reverse_order``) or ``start + w·wave_size``, valid where in
    ``[start, end)``; out-of-range ids are clipped to ``[0, end - 1]``.
    ``wave_size`` must be a multiple of the world size (else
    ``ValueError``).  Returns ``(adj, nbr_tab)``."""
    S = group.world
    if wave_size % S:
        raise ValueError(f"wave_size {wave_size} must be a multiple of the world size {S}")
    offs = torch.arange(wave_size, dtype=torch.int32, device=adj.device)
    n_waves = max(-(-(end - start) // wave_size), 0)
    for w in range(n_waves):
        lo = end - (w + 1) * wave_size if reverse_order else start + w * wave_size
        ids = lo + offs
        valid = (ids >= start) & (ids < end)
        dp_wave_step(
            group, prev_layers, adj, elements, ids.clamp(0, max(end - 1, 0)), valid, m_eff=m_eff,
            max_search=max_search, expand=expand, reinsert=reinsert, reverse_cap=reverse_cap,
            merge_chunk=merge_chunk, max_iters=max_iters, gather_budget=gather_budget, nbr_tab=nbr_tab,
        )
    return adj, nbr_tab


def dp_build_waves(group: Group, prev_layers, adj, elements, ids, cfg, m_eff: int, max_search: int,
                   *, reinsert: bool = False, nbr_tab=None):
    """Insert ``ids`` (int32) in waves of ``W = max(S, (cfg.wave_size // S)
    * S)`` split over the group's S ranks, back to front with ``reinsert``
    (the reference's reverse-order reinsert).  A short last wave is padded
    to a multiple of S, not to W as in the JAX package, whose compiled
    programs need the one shape: padding is searched and dropped, so the
    graph is the same.  Honours ``build_max_iters``, ``gather_budget`` and
    the cache.  Returns ``(adj, nbr_tab)``."""
    S = group.world
    W = max(S, (cfg.wave_size // S) * S)
    ids = torch.as_tensor(ids, dtype=torch.int32).to(adj.device)
    ranges = list(range(0, len(ids), W))
    if reinsert:
        ranges.reverse()
    for lo in ranges:
        chunk = ids[lo : lo + W]
        pad = -len(chunk) % S
        wave = torch.cat([chunk, chunk.new_zeros(pad)])
        valid = torch.arange(len(wave), device=adj.device) < len(chunk)
        dp_wave_step(
            group, prev_layers, adj, elements, wave, valid, m_eff=m_eff, max_search=max_search,
            expand=cfg.expand, reinsert=reinsert, reverse_cap=cfg.reverse_cap, merge_chunk=cfg.merge_chunk,
            max_iters=cfg.build_max_iters, gather_budget=cfg.gather_budget, nbr_tab=nbr_tab,
        )
    return adj, nbr_tab
