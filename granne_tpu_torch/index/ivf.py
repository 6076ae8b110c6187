"""IVF (inverted-file) index (port of ``granne_tpu/index/ivf.py``).

Elements are permuted cluster by cluster into a padded dense tensor
[k, L, d] plus an id map [k, L] (-1 padding).  A search is:

    1. score queries against the k centroids        (one f32 matrix product)
    2. pick the top-``nprobe`` blocks per query      (``ranked``: ties probe
                                                      the lower block, as
                                                      ``lax.top_k`` does)
    3. group (query, block) pairs into slots and score every slot's block
       against its query group                      (the pair store: K4,
                                                      or K3 with
                                                      ``slot_group=1``; or
                                                      K5 with ``fused_topk``)
    4. merge the per-block candidates into each query's top-k

The pair store (``ops/kernels/ivf_score.py::ivf_score_pairs``) writes each
query's scaled, masked score rows straight into the merge's [B * nprobe,
L] buffer, which the merge reads as [B, nprobe * L]: nothing runs between
the kernel and the merge's top-k, whose k winners alone look up their ids.
K5's route keeps its own epilogue and scatter.

Steps 1-2, 3's grouping, 3's scoring and 4 run in the ``utils.trace``
spans ``ivf/probe``, ``ivf/group``, ``ivf/score`` and ``ivf/merge``, and
``IvfIndex.search_batch`` in ``ivf/search``; inside ``ivf/score``, the
span ``ivf/epilogue`` holds what of the epilogue runs outside the kernel:
on the pair store's route the -inf fill of the pair rows (before the
kernel: the rows of the pairs that no slot holds stay -inf), on K5's the
mask of empty places and the row gather.  While a profiler records, the
grouping counts the slots scored (``ivf/slots``), the distinct blocks
among them (``ivf/blocks``), the (query, block) pairs (``ivf/pairs``), the
query rows of the slots (``ivf/slot_rows``, slots times the group cap) and
the pairs that no slot holds (``ivf/dropped_pairs``: past the last of
``num_slots``, so -inf rows in the merge).  The
probe's, the merge's and the ungrouped search's top-k go through
``ranked``: the card's row top-k kernel for k up to ``K_MAX``, the
whole-row stable sort past it, the rows of each counted
(``topk/kernel_rows``, ``topk/sort_rows``) while a profiler records.
Off the profiler, ``IvfIndex.search_batch`` replays a grouped search of
CUDA queries from a CUDA graph captured at the first call of its shape,
so ``ivf/search`` is then its only span.

A cluster larger than L spans several physical blocks, each with a copy of
the cluster's centroid row, so the coarse probe reaches every sub-block of
a near cluster and no element leaves its true cluster.  Exact within the
probed blocks; recall is tuned by ``nprobe``.  Files are the JAX package's,
byte for byte.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import distance as D
from ..ops import kmeans
from ..ops.kernels import ivf_score
from ..ops.kernels.row_topk import K_MAX, row_top_k
from ..ops.segment import group_pairs
from ..ops.topk import top_k
from ..utils import trace
from . import io as gio

IVF_MAGIC = b"granne-tpu-ivf"
GRAPHS_KEPT = 2  # captured grouped searches an index holds, the most recently used

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
_FILE_DTYPES = {"bfloat16": np.dtype("<i2"), "float32": np.dtype("<f4"), "int8": np.dtype("i1")}


def layout_blocks(x: np.ndarray, centroids: np.ndarray, assign: np.ndarray, k: int, L: int):
    """Fixed-size physical sub-blocks (host numpy).

    A cluster of s members occupies max(1, ceil(s / L)) blocks, each with a
    copy of the cluster's centroid row, members in ascending id order.
    Returns (blocks x.dtype[k_phys, L, d] zero-padded, ids int32[k_phys, L],
    physical centroids [k_phys, d]).
    """
    n, d = x.shape
    counts = np.bincount(assign, minlength=k)
    blocks_per_cluster = np.maximum(1, -(-counts // L))
    block_base = np.concatenate([[0], np.cumsum(blocks_per_cluster)])
    k_phys = int(block_base[-1])

    order = np.argsort(assign, kind="stable")
    a_s = assign[order]
    starts = np.searchsorted(a_s, np.arange(k))
    rank = np.arange(n) - starts[a_s]
    phys_block = block_base[a_s] + rank // L
    phys_pos = rank % L

    blocks = np.zeros((k_phys, L, d), x.dtype)
    ids = np.full((k_phys, L), -1, np.int32)
    blocks[phys_block, phys_pos] = x[order]
    ids[phys_block, phys_pos] = order
    return blocks, ids, np.repeat(centroids, blocks_per_cluster, axis=0)


@dataclass(frozen=True)
class IvfIndex:
    """Padded-cluster IVF index over unit-norm f32 (or int8) vectors."""

    centroids: torch.Tensor  # f32[k, d]
    blocks: torch.Tensor  # bf16|f32|i8[k, L, d] cluster-padded vectors
    block_ids: torch.Tensor  # int32[k, L], -1 padding
    block_scales: torch.Tensor  # f32[k, L]: per-row score scale (1.0 unless int8)
    n_total: int
    _graphs: OrderedDict = field(default_factory=OrderedDict, init=False, repr=False, compare=False)

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def cluster_cap(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def rows(self, lo: int, hi: int) -> "IvfIndex":
        """Block rows [lo, hi) as an index of their own (views, no copy)."""
        return IvfIndex(
            centroids=self.centroids[lo:hi], blocks=self.blocks[lo:hi], block_ids=self.block_ids[lo:hi],
            block_scales=self.block_scales[lo:hi], n_total=self.n_total,
        )

    @classmethod
    def build(
        cls,
        raw_vectors,
        *,
        n_clusters: int | None = None,
        kmeans_iters: int = 12,
        cluster_cap: int | None = None,
        dtype: str = "bfloat16",
        seed: int = 0,
        device="cuda",
    ) -> "IvfIndex":
        """Train the coarse quantizer on ``device`` and lay out fixed-size
        sub-blocks (``cluster_cap`` rounded up to a multiple of 8 is the
        block size L)."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        x = D.normalize(D.as_f32(raw_vectors, device))
        n = x.shape[0]
        if n_clusters is None:
            n_clusters = max(8, int(np.sqrt(n) * 1.5) // 8 * 8)
        k = n_clusters
        centroids, assign = kmeans.train_kmeans(x, k, iters=kmeans_iters, seed=seed)
        if cluster_cap is None:
            cluster_cap = min(512, max(64, int(np.ceil(n / k * 1.5))))
        L = -(-cluster_cap // 8) * 8
        blocks, ids, cent = layout_blocks(x.cpu().numpy(), centroids.cpu().numpy(), assign.cpu().numpy(), k, L)
        return cls._from_f32_blocks(blocks, ids, cent, n, dtype, x.device)

    @classmethod
    def _from_f32_blocks(cls, blocks, ids, cent, n, dtype, device) -> "IvfIndex":
        b = torch.as_tensor(blocks, device=device)
        scales = torch.ones(ids.shape, dtype=torch.float32, device=device)
        if dtype == "int8":
            # rows are unit-norm f32 before quantization; int8 rows are not,
            # so cosine ranking needs the per-row reciprocal norm as a scale
            b = D.quantize_i8(b)
            scales = D.inv_norms_i8(b)
        else:
            b = b.to(_DTYPES[dtype])
        return cls(
            centroids=torch.as_tensor(cent, device=device),
            blocks=b,
            block_ids=torch.as_tensor(ids, device=device),
            block_scales=scales,
            n_total=n,
        )

    # -- extension -----------------------------------------------------------

    def append(self, raw_vectors) -> "IvfIndex":
        """Extend a built index with new elements (functional update).

        Each new vector goes to its nearest existing cluster, fills that
        cluster's free padding slots first, and only the overflow is laid
        out as fresh sub-blocks carrying a copy of the cluster's centroid
        row.  New elements get ids ``n_total .. n_total + len(raw) - 1``.
        """
        x_t = D.normalize(D.as_f32(raw_vectors, self.device))
        x = x_t.cpu().numpy()
        m, d = x.shape
        if d != self.blocks.shape[2]:
            raise ValueError(f"dimension mismatch: {d} != {self.blocks.shape[2]}")
        L = self.cluster_cap

        # nearest physical centroid; duplicated rows tie and argmax takes the
        # first, i.e. the first block of the cluster's contiguous run
        assign = kmeans.assign_clusters(x_t, self.centroids).cpu().numpy()

        # runs of bit-identical (duplicated) centroid rows: one logical cluster each
        cent_np = self.centroids.cpu().numpy()
        same = np.all(cent_np[1:] == cent_np[:-1], axis=1)
        run_id = np.concatenate([[0], np.cumsum(~same)]).astype(np.int64)
        n_runs = int(run_id[-1]) + 1

        # free slots, grouped by run (block-major order keeps runs contiguous)
        ids_np = self.block_ids.cpu().numpy()
        free_b, free_p = np.nonzero(ids_np < 0)
        free_run = run_id[free_b]
        free_count = np.bincount(free_run, minlength=n_runs)
        free_start = np.concatenate([[0], np.cumsum(free_count)])

        # rank each new member within its run
        member_run = run_id[assign]
        order = np.argsort(member_run, kind="stable")
        r_s = member_run[order]
        uniq, starts = np.unique(r_s, return_index=True)
        rank = np.arange(m) - starts[np.searchsorted(uniq, r_s)]

        in_free = rank < free_count[r_s]
        slot_idx = free_start[r_s] + np.minimum(rank, np.maximum(free_count[r_s] - 1, 0))
        fill_b = free_b[slot_idx[in_free]]
        fill_p = free_p[slot_idx[in_free]]
        fill_x = x[order[in_free]]
        fill_ids = (self.n_total + order[in_free]).astype(np.int32)

        # overflow spills into fresh sub-blocks per run
        sp_mask = ~in_free
        sp_run = r_s[sp_mask]
        sp_rank = rank[sp_mask] - free_count[sp_run]
        sp_uniq, sp_starts = np.unique(sp_run, return_index=True)
        sp_sizes = np.diff(np.append(sp_starts, len(sp_run)))
        blocks_per = -(-sp_sizes // L)
        new_base = np.concatenate([[0], np.cumsum(blocks_per)])
        k_new = int(new_base[-1])

        grp = np.searchsorted(sp_uniq, sp_run)
        new_blocks = np.zeros((k_new, L, d), np.float32)
        new_ids = np.full((k_new, L), -1, np.int32)
        new_blocks[new_base[grp] + sp_rank // L, sp_rank % L] = x[order[sp_mask]]
        new_ids[new_base[grp] + sp_rank // L, sp_rank % L] = self.n_total + order[sp_mask]
        # centroid row of each spilling run = its first block's row
        run_first = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        new_cent = np.repeat(cent_np[run_first[sp_uniq]], blocks_per, axis=0)

        # updated copies (functional update), written on the index's device
        dev = self.device
        fb = torch.as_tensor(fill_b, device=dev)
        fp = torch.as_tensor(fill_p, device=dev)
        blocks = self.blocks.clone()
        scales = self.block_scales.clone()
        ids_out = self.block_ids.clone()
        fx = torch.as_tensor(fill_x, device=dev)
        nb = torch.as_tensor(new_blocks, device=dev)
        if self.blocks.dtype == torch.int8:
            q8 = D.quantize_i8(fx)
            blocks[fb, fp] = q8
            scales[fb, fp] = D.inv_norms_i8(q8)
            nb = D.quantize_i8(nb)
            nscales = D.inv_norms_i8(nb)
        else:
            blocks[fb, fp] = fx.to(blocks.dtype)
            nb = nb.to(blocks.dtype)
            nscales = torch.ones((k_new, L), dtype=torch.float32, device=dev)
        ids_out[fb, fp] = torch.as_tensor(fill_ids, device=dev)

        return IvfIndex(
            centroids=torch.cat([self.centroids, torch.as_tensor(new_cent, device=dev)]),
            blocks=torch.cat([blocks, nb]),
            block_ids=torch.cat([ids_out, torch.as_tensor(new_ids, device=dev)]),
            block_scales=torch.cat([scales, nscales]),
            n_total=self.n_total + m,
        )

    # -- persistence ---------------------------------------------------------
    # The JAX package's single-artifact format: the 1024-byte metadata block,
    # then centroids, blocks, ids and (int8 only) scales back to back.  bf16
    # blocks are written and read as their raw 16-bit patterns.

    def save(self, path: str) -> None:
        dtype = _DTYPE_NAMES[self.blocks.dtype]
        blocks = self.blocks.view(torch.int16) if dtype == "bfloat16" else self.blocks
        k, L, d = self.blocks.shape
        meta = {
            "granne_tpu_version": gio.LIBRARY_VERSION,
            "version": gio.SERIALIZATION_VERSION,
            "k_phys": int(k),
            "cluster_cap": int(L),
            "dim": int(d),
            "dtype": dtype,
            "n_total": int(self.n_total),
            "has_scales": dtype == "int8",
        }
        parts = [self.centroids, blocks, self.block_ids] + ([self.block_scales] if dtype == "int8" else [])
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            gio._write_metadata(f, IVF_MAGIC, meta)
            for t in parts:
                f.write(np.ascontiguousarray(t.cpu().numpy()).tobytes())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, device="cuda", rows: tuple[int, int] | None = None) -> "IvfIndex":
        """Load an index written by either package onto ``device``; with
        ``rows=(lo, hi)`` only block rows [lo, hi) are read (through the
        file's memory map), ``n_total`` still the whole index's."""
        meta, (cent, blocks, bids, *scales) = file_rows(path, rows)

        def take(arr):
            return torch.as_tensor(np.array(arr), device=device)

        blocks = take(blocks)
        if meta["dtype"] == "bfloat16":
            blocks = blocks.view(torch.bfloat16)
        bids = take(bids)
        scales = take(scales[0]) if scales else torch.ones(bids.shape, dtype=torch.float32, device=device)
        return cls(centroids=take(cent), blocks=blocks, block_ids=bids, block_scales=scales, n_total=meta["n_total"])

    # -- search ------------------------------------------------------------

    def search_batch(
        self,
        queries,
        num_neighbors: int = 10,
        *,
        nprobe: int = 16,
        query_chunk: int = 256,
        grouped: bool = True,
        group_cap: int = 32,
        fused_topk: bool = False,
        slot_group: int = 8,
        graph: bool = True,
    ):
        """Top ``num_neighbors`` of each query: (ids int32[B, k], dists f32[B, k]).

        ``grouped`` (default) scores each probed block once against every
        query that probes it: with CUDA tensors through K4 (``slot_group``
        slots per thread block; ``slot_group=1`` is K3), or through the
        fused score + top-k kernel K5 with ``fused_topk=True``.
        ``grouped=False`` gathers each query's blocks (plain PyTorch, in
        chunks of ``query_chunk`` queries).

        With ``graph`` (default), a grouped search of CUDA queries replays
        a CUDA graph of the whole search, normalization included, captured
        at the first call of its shape and options (``_replay``): one
        launch in place of some eighty, so the host no longer sets the
        pace.  While a profiler records, the search runs op by op, so its
        spans and counters see every stage.  Threads that search one index
        at once take ``graph=False``: a graph has one input buffer.
        """
        with trace.span("ivf/search"):
            x = D.as_f32(queries, self.device)
            if not grouped:
                return _ivf_search(
                    self.centroids, self.blocks, self.block_ids, self.block_scales, D.normalize(x),
                    nprobe=nprobe, k_out=num_neighbors, query_chunk=query_chunk,
                )
            num_slots = slot_count(self.k, x.shape[0], nprobe, group_cap)

            def run(x):
                return _ivf_search_grouped(
                    self.centroids, self.blocks, self.block_ids, self.block_scales, D.normalize(x),
                    nprobe=nprobe, k_out=num_neighbors, group_cap=group_cap, num_slots=num_slots,
                    use_pallas_topk=fused_topk, slot_group=slot_group,
                )

            if graph and x.is_cuda and x.shape[0] > 0 and not trace.recording():
                key = (tuple(x.shape), num_neighbors, nprobe, group_cap, fused_topk, slot_group)
                return _replay(self._graphs, key, run, x)
            return run(x)


def _replay(graphs: OrderedDict, key, run, x):
    """``run(x)`` through the CUDA graph that ``graphs`` holds under ``key``,
    captured first where it holds none; the ``GRAPHS_KEPT`` most recently
    used keys keep theirs, and an older graph is dropped with its memory.
    The answers are copies: the next replay overwrites the graph's own."""
    held = graphs.pop(key, None) or _capture(run, x)
    graphs[key] = held
    while len(graphs) > GRAPHS_KEPT:
        graphs.popitem(last=False)
    cuda_graph, x_in, outs = held
    x_in.copy_(x)
    cuda_graph.replay()
    return tuple(o.clone() for o in outs)


def _capture(run, x):
    """(graph, input buffer, outputs) of ``run`` captured on a copy of ``x``,
    after one call op by op that loads the kernels and makes the lazy
    initialisations a capture refuses."""
    x_in = x.clone()
    run(x_in)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        outs = run(x_in)
    return cuda_graph, x_in, outs


def read_metadata(path) -> dict:
    """The metadata block of an ``IvfIndex`` file (``k_phys``, ``cluster_cap``,
    ``dim``, ``dtype``, ``n_total``, ``has_scales``)."""
    return gio._read_metadata(gio._Source(path).head(gio.METADATA_LEN), IVF_MAGIC)


def file_rows(path, rows: tuple[int, int] | None = None):
    """An ``IvfIndex`` file's metadata and its centroids, blocks (bf16 as
    int16 bits), ids and, for int8, scales, as read-only memory maps of
    block rows [lo, hi) (every row by default): (meta, [arrays])."""
    src = gio._Source(path)
    meta = read_metadata(path)
    k, L, d = meta["k_phys"], meta["cluster_cap"], meta["dim"]
    lo, hi = (0, k) if rows is None else rows
    if not 0 <= lo <= hi <= k:
        raise ValueError(f"block rows [{lo}, {hi}) are not within the file's {k}")
    parts = [("<f4", (d,)), (_FILE_DTYPES[meta["dtype"]], (L, d)), ("<i4", (L,))]
    parts += [("<f4", (L,))] if meta["has_scales"] else []
    off, out = gio.METADATA_LEN, []
    for dtype, row in parts:
        row_bytes = np.dtype(dtype).itemsize * int(np.prod(row))
        shape = (hi - lo, *row)
        out.append(src.region(dtype, off + lo * row_bytes, shape) if hi > lo else np.empty(shape, dtype))
        off += k * row_bytes
    return meta, out


def slot_count(k: int, B: int, nprobe: int, group_cap: int) -> int:
    """Slots of a grouped search of ``B`` queries: one a probed block, and
    one more per ``group_cap`` queries that probe it, with room to spare."""
    return min(B * nprobe, k + (B * nprobe) // group_cap + 8)


def slot_groups(q, probes, blocks, *, group_cap, num_slots):
    """The grouped search's slots for unit queries ``q`` [B, d] and their
    probed blocks ``probes`` [B, nprobe] (indices into ``blocks``): (keys
    int32[S] clamped into [0, k), qg bf16[S, group_cap, d] each slot's query
    group, and ``group_pairs``'s slot_pairs, item_slot, item_pos,
    sorted_pairs).  Equal keys come in runs; an unused slot is clamped to
    block 0 and holds query 0."""
    nprobe = probes.shape[1]
    pair_keys = probes.reshape(-1).to(torch.int32)
    pair_idx = torch.arange(pair_keys.shape[0], dtype=torch.int32, device=q.device)
    slot_keys, slot_pairs, item_slot, item_pos, sorted_pairs, _ = group_pairs(
        pair_keys, pair_idx, cap=group_cap, num_slots=num_slots
    )
    safe_keys = torch.clamp(slot_keys, 0, blocks.shape[0] - 1).contiguous()
    slot_queries = torch.where(slot_pairs >= 0, slot_pairs // nprobe, 0)
    qg = q.to(torch.bfloat16)[slot_queries.long()]  # [S, cap, d]
    return safe_keys, qg, slot_pairs, item_slot, item_pos, sorted_pairs


def ranked(scores, k: int):
    """The ``k`` best of each row of ``scores`` (f32 [R, C]), best first, ties
    to the lower column: (values, columns int64).  ``row_top_k`` (one read of
    each row on the card) takes k <= min(C, K_MAX), the whole-row stable sort
    (``ops/topk.py::top_k``) a wider k; the two give the same answers."""
    rows, cols = scores.shape
    if k <= min(cols, K_MAX):
        trace.count("topk/kernel_rows", rows)
        return row_top_k(scores, k)
    trace.count("topk/sort_rows", rows)
    return top_k(scores, k)


def _probe(q, centroids, nprobe, centroid_valid=None):
    """Coarse scores -> [B, nprobe] probed blocks, ties to the lower block.
    ``centroid_valid`` (bool[k]) keeps padding blocks out: their zero
    centroids score 0 and would win probes over real blocks scoring below 0."""
    with trace.span("ivf/probe"):
        cs = q @ centroids.to(torch.float32).T
        if centroid_valid is not None:
            cs = torch.where(centroid_valid[None, :], cs, -torch.inf)
        return ranked(cs, nprobe)[1]


def _ivf_search_grouped(
    centroids, blocks, block_ids, block_scales, q, *, nprobe, k_out, group_cap, num_slots,
    use_pallas_topk=False, slot_group=8, centroid_valid=None,
):
    """The grouped search of ``q`` over the ``nprobe`` blocks nearest each
    query (``search_probed`` after the coarse probe, padding blocks masked
    by ``centroid_valid``).  ``use_pallas_topk`` keeps the JAX package's
    name for the fused route (K5)."""
    return search_probed(
        _probe(q, centroids, nprobe, centroid_valid), blocks, block_ids, block_scales, q, k_out=k_out,
        group_cap=group_cap, num_slots=num_slots, use_pallas_topk=use_pallas_topk, slot_group=slot_group,
    )


def search_probed(
    probes, blocks, block_ids, block_scales, q, *, k_out, group_cap, num_slots, use_pallas_topk=False, slot_group=8,
):
    """Cluster-centric scoring of given probes [B, nprobe] (indices into
    ``blocks``): each probed block is read once and scored against every
    query probing it.  Hot blocks probed by more than ``group_cap`` queries
    spill into further slots (no dropped work).  The final top-k runs over
    each query's [nprobe * L] candidates in probe order, ties to the lower
    column.
    """
    nprobe = probes.shape[1]
    B = q.shape[0]
    L = blocks.shape[1]
    S = num_slots
    P = B * nprobe
    # per-slot block + query group; an unused slot is scored and stores nothing
    with trace.span("ivf/group"):
        safe_keys, qg, slot_pairs, item_slot, item_pos, sorted_pairs = slot_groups(
            q, probes, blocks, group_cap=group_cap, num_slots=S
        )
        if trace.recording():
            trace.count("ivf/slots", S)
            trace.count("ivf/blocks", _blocks_scored(safe_keys, slot_pairs))
            trace.count("ivf/pairs", P)
            trace.count("ivf/slot_rows", S * group_cap)
            trace.count("ivf/dropped_pairs", (item_slot < 0).sum())

    if use_pallas_topk:
        return _merge_slot_topk(
            blocks, block_ids, block_scales, q, safe_keys, qg, slot_pairs, item_slot, item_pos, sorted_pairs,
            B=B, nprobe=nprobe, k_out=k_out, group_cap=group_cap,
        )
    with trace.span("ivf/score"):
        with trace.span("ivf/epilogue"):
            rows = torch.full((P, L), -torch.inf, dtype=torch.float32, device=q.device)
        # each query's score rows, scaled and masked, straight into its pairs' rows
        ivf_score.ivf_score_pairs(blocks, block_ids, block_scales, safe_keys, qg, slot_pairs, rows, group=slot_group)

    with trace.span("ivf/merge"):
        v, pos = ranked(rows.reshape(B, nprobe * L), k_out)
        blk = probes.gather(1, pos // L).long().clamp(0, blocks.shape[0] - 1)
        ids = torch.where(v == -torch.inf, -1, block_ids[blk, pos % L])  # -1 at padding and unheld pairs
        return ids, torch.clamp_min(1.0 - v, 0.0)


def _merge_slot_topk(
    blocks, block_ids, block_scales, q, safe_keys, qg, slot_pairs, item_slot, item_pos, sorted_pairs, *,
    B, nprobe, k_out, group_cap,
):
    """``search_probed``'s fused route: K5's per-(slot, place) top-k_out,
    each place's lists gathered back to its pair and the merge over
    [B, nprobe * k_out].  The [S, cap, L] scores stay on chip; the union of
    the per-slot top-k_out holds the global top-k_out, so it stays exact."""
    S = safe_keys.shape[0]
    P = B * nprobe
    with trace.span("ivf/score"):
        vals, vids = ivf_score.ivf_score_topk(blocks, block_ids, block_scales, safe_keys, qg, k_out=k_out)
        with trace.span("ivf/epilogue"):
            lin = torch.where(item_slot >= 0, item_slot * group_cap + item_pos, 0).long()
            dropped = (item_slot < 0)[:, None]
            occupied = (slot_pairs >= 0)[:, :, None]
            vals = torch.where(occupied, vals, -torch.inf)
            vids = torch.where(occupied, vids, -1)
            Kp = vals.shape[2]
            rows = torch.where(dropped, -torch.inf, vals.reshape(S * group_cap, Kp)[lin])
            id_rows = torch.where(dropped, -1, vids.reshape(S * group_cap, Kp)[lin])

    with trace.span("ivf/merge"):
        order = sorted_pairs.long()
        out_scores = torch.full((P, Kp), -torch.inf, dtype=torch.float32, device=q.device)
        out_ids = torch.full((P, Kp), -1, dtype=torch.int32, device=q.device)
        out_scores[order] = rows  # sorted_pairs is a permutation of the pairs
        out_ids[order] = id_rows
        v, pos = ranked(out_scores.reshape(B, nprobe * Kp), k_out)
        ids = torch.gather(out_ids.reshape(B, nprobe * Kp), 1, pos)
        return ids, torch.clamp_min(1.0 - v, 0.0)


def _blocks_scored(keys, slot_pairs):
    """Distinct blocks among the used slots (0-d tensor, no sync): a used
    slot holds a query in its first place, and equal keys come in runs."""
    prev = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    return ((slot_pairs[:, 0] >= 0) & (keys != prev)).sum()


def _ivf_search(centroids, blocks, block_ids, block_scales, q, *, nprobe, k_out, query_chunk):
    """Per-query block gather + scoring, ``query_chunk`` queries at a time."""
    ids_out, d_out = [], []
    for lo in range(0, q.shape[0], query_chunk):
        qc = q[lo : lo + query_chunk]
        probes = _probe(qc, centroids, nprobe).long()  # [Qc, nprobe]
        pb = blocks[probes].to(torch.bfloat16).to(torch.float32)  # [Qc, nprobe, L, d]
        pids = block_ids[probes]  # [Qc, nprobe, L]
        dots = torch.einsum("qpld,qd->qpl", pb, qc.to(torch.bfloat16).to(torch.float32))
        dots = torch.where(pids >= 0, dots * block_scales[probes], -torch.inf)
        Qc = qc.shape[0]
        v, pos = ranked(dots.reshape(Qc, -1), k_out)
        ids_out.append(torch.gather(pids.reshape(Qc, -1), 1, pos))
        d_out.append(torch.clamp_min(1.0 - v, 0.0))
    return torch.cat(ids_out), torch.cat(d_out)
