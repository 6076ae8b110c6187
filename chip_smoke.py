#!/usr/bin/env python3
"""On-card smoke run of granne_tpu_torch: the quickest proof that the port
starts and is right on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --baseline-nbr-score OLD.cu   # also time an earlier K1/K2
    python3 chip_smoke.py --baseline-ivf-score OLD.cu   # also time an earlier K3/K4/K5

In the order it runs:

1. Builds every CUDA kernel of the main paths from ``granne_tpu_torch/csrc``
   (and the port's adjacency codec, ``csrc/codec.cpp``, with g++), all
   compilers started together, and prints nvcc's ``-Xptxas -v`` report of
   ``nbr_score.cu``, ``ivf_score.cu`` and ``row_topk.cu`` (registers,
   shared memory, spills of each kernel).
2. K1 (``gather_score_flat``) against its plain PyTorch version on the card
   at the serve shape n=200,000, M=20, d=100, B=1024, E in {1, 4}: ids
   exactly equal, dots within 1e-4 (both sum exact bf16 products in f32 and
   differ only in summation order), finite dots on half-unfilled rows.
   Then on an int8-provenance table (``cache_rows`` of int8 codes) with the
   two lane forms of int8 queries: the exact unit query (within 1e-4) and
   the codes as bf16, up to 127 (within 1e-4 times each query's lane norm).
3. K2 (``gather_score``) the same way on the tiled layout of that shape
   (24 vectors of 128 lanes a row): dots within 1e-4.
4. K3/K4/K5 (``ivf_score_slots``, ``ivf_score_slots_grouped``,
   ``ivf_score_topk``) against their plain versions on the card, with bf16,
   f32 and int8 blocks, at the IVF path's shape (1,000 blocks of L=256,
   d=100; 1,520 slots of 32 queries; k_out=10), with a short tail group
   (S % 8 != 0), and with blocks over 227 KB (L=512, d=300): K3/K4 within
   1e-4 on the cosine scale, K5 values within 1e-4 and ids equal except
   at near-ties (values within 1e-4 of a neighbour in the plain ranking,
   the first value past the k_out-th included); exactly tied rows rank the lower column first, within a
   row tile and across the big block's row tiles.  The pair store
   (``ivf_score_pairs``, the search's K4/K3 route) on the same cases, its
   places holding distinct pairs at about the serve cells' 30% fill and the
   last eighth of the slots unused: every row it writes equals K4's scores
   times the row's scale, -inf where the id is negative, bit for bit, and
   is within 1e-4 of its plain version (the same -inf places).  Then the
   pair store at both IVF cells' shapes (glove-100's 6,467 bf16 blocks of
   L 256, nprobe 8; deep-image-96's 23,590 int8 blocks of L 512 with real
   scales, nprobe 32; 10,000 queries over uniformly random distinct probes,
   grouped by ``slot_groups`` at ``slot_count``'s size): checked the same
   way, then timed against its plain version and its bound
   (``cell_shapes`` in its record).  Then ``row_top_k``
   against its plain version ``ops/topk.py::top_k`` at the IVF cell's two
   top-k shapes (the probe's [10,000 x 6,467] at k 8, the merge's
   [10,000 x 2,048] at k 10, random scores): values and columns equal, and
   timed beside its bound, the plain sort and ``torch.topk``
   (``library_ms``, which the port never calls).
5. The HNSW main path through the public API: ``GranneBuilder.append`` ->
   ``build`` -> ``save_index`` (compressed) / ``save_elements`` ->
   ``load_granne`` -> bf16 copy + flat neighbor cache -> ``search_batch``,
   on the synthetic data of ``bench.py`` (1000 Gaussian centres, sigma 0.35,
   seed 42; 200,000 x 100 with 4,096 held-out queries), M=20, build ef=100.
   Recall@10 against exact f32 ground truth must reach 0.95 at some
   ef <= 120, and the search must have launched K1.
6. The cache-fed build on the same data:
   ``GranneBuilder(..., neighbor_cache=True, neighbor_cache_layout="tiled")``
   -> ``build`` (K2 in every wave's beam, merges fed from the cache) ->
   save -> load -> bf16 copy served through the tiled cache (K2).  Recall@10
   must reach 0.95 at some ef <= 120 and stay within 0.02 of step 5's
   recall at that ef.  Then the f32 elements served through a
   ``cache_dtype="f32"`` flat table (ids overlap the uncached f32 search
   >= 0.999 at ef 32), and bf16 flat-cache serving reranked against the
   f32 container (recall >= the same search without rerank).
7. The flat cache-fed build (K1 in the build beam) at n=50,000: recall@10
   >= 0.95 at some ef <= 120 against exact f32 ground truth over those
   50,000, and its self-recall@1 over 1,024 rows (logged).
8. The int8 path on the same data: ``GranneBuilder("angular_int")`` ->
   ``build`` -> ``save_index`` / ``save_elements`` (the ``i1`` file) ->
   ``load_granne`` (codes and norms equal) -> four serving routes, recall@10
   at every ef and QPS at the first ef reaching 0.95 (else the best ef,
   "below bar"): the int8 container's own traversal (expand 4,
   ``descent_ef`` 4), its flat cache (K1, exact-unit lanes), the
   ``dequantized()`` bf16 copy through the flat cache reranked against the
   codes (``descent_ef`` 4, ``max_iters = max(8, ef - 6)``), and that with
   round-to-nearest codes.  Each code set's ceiling is the recall of an
   exact top-10 under its own scoring; the K1 and rerank routes must end
   within 0.02 of theirs at ef 120, and the rerank route may trail the K1
   route by at most 0.005 at any ef.  The tiled layout must refuse int8
   elements with ValueError (serving and build).  Then a flat cache-fed
   int8 build at 50,000 (K1 in every wave) with self-recall@1 >= 0.95.  The
   path must have launched K1 (``int8_path_launches`` in K1's record).
9. The IVF main path through the public API on the same data (bench.py's
   IVF row): ``IvfIndex.build(n_clusters=666, kmeans_iters=10,
   cluster_cap=256)`` in bf16 -> ``save`` -> ``load(device="cuda")`` ->
   ``search_batch`` of all 4,096 queries at nprobe 4..64.  Recall@10 must
   reach 0.95; at the first nprobe that does, the K3 and fused K5 routes
   must agree with the K4 route (id overlap >= 0.999), each timed.  Then
   bf16 brute force, and an int8 index from ``build_ivf_i8_chunked`` (four
   50,000-row chunks) whose recall at nprobe 16 is at most 0.01 below the
   int8 brute-force recall.  The path must have launched the pair store
   (``ivf_score_pairs``: the K4 and K3 routes), K5 and ``row_top_k`` (the
   probe's and the merge's top-k).
   At nprobe 4, one warm ``search_batch`` per route (K4, fused K5) under
   ``torch.profiler``: host wall, device time, busy share, device ops and
   the five largest.  Then K3/K4/K5 and the pair store timed again on the
   path's own slots (``slot_groups`` at nprobe 4: keys in sorted runs,
   1,520 slots, the pair store into the search's [4,096 x 4, 256] rows),
   each with its own bound (``path_keys_*`` in the kernel records).

10. Reorder on the card: step 5's saved 200k f32 pair loaded on the card
    and renumbered by ``Granne.reorder()`` (entrypoint trails through the
    upper layers on the card, seconds to a ``synchronize``); the order must
    be a permutation that keeps every layer's band, and 1,024 sampled rows a
    layer must be isomorphic to the original rows.  The reordered graph is
    served as bf16 through a fresh flat cache (K1) at every ef, ids mapped
    back through ``order``; recall@10 must reach 0.95 at some ef <= 120 and
    the sweep must have launched K1 (``reorder_path_launches``).  The
    reordered pair is saved, and the original graph saved dense.
11. Host serving: ``HostGranne`` (the C++ search of ``csrc/codec.cpp`` over
    memory-mapped files, CPU threads) on the original and the reordered
    pair, bench.py's baseline shape (the first 500 queries, one thread,
    K 10) at every ef with recall and QPS, then every core at step 5's bar
    ef over all 4,096 queries; the dense index once; the int8 path's ``i1``
    pair at ef 120 beside its trunc ceiling over the same 500 queries.
    One-thread recall at ef 120 must reach 0.95 on both pairs.  The QPS of
    the two pairs comes from one call, so their ratio is logged.
12. The read-write builder on the card: ``RwGranneBuilder`` over the first
    20,000 vectors (step 5's build config, its final size declared so the
    layers follow the schedule), two threads inserting 5,120 rows each in
    ``insert_batch`` calls of 512 while a third searches the held-out
    queries; after every call a thread must find >= 0.98 of its rows at
    distance <= 1e-4 (the visibility contract).  Then ``flush``: 30,240
    elements, the schedule's layer counts, self-recall@1 >= 0.98 over all
    of them; ``save`` while searches run, reload, one ``HostGranne`` serve
    of the files.  A failed thread fails the run.
13. Bag-of-embeddings elements: 50,000 words (50 for each of bench.py's
    1,000 centres, its generator, each word scaled to a norm in [0.5, 2])
    and 200,000 bags of 2-8 distinct words of one centre, with 4,096
    held-out bags as queries; ground truth the exact f32 top-10 over the
    summed unit vectors, a returned id counting if its exact distance is
    within 1e-6 of the true 10th (equal bags are equal vectors).
    ``SumEmbeddings.from_parts`` on the card -> ``build_layers`` (step 5's
    config) -> ``save_index`` / ``save_elements`` (csr24, bytes logged) ->
    ``load_granne`` (terms and table equal) -> uncached, flat-cache (K1) and
    tiled-cache (K2) sweeps, the cached routes also with their final beam
    reranked by the exact f32 sums.  The uncached route must reach 0.90 at
    some ef <= 120 (0.95 logged); K1 and K2 must end within 0.02 of their
    bf16 ceiling (an exact top-10 under bf16 rows and query lanes) at ef
    120, and with the rerank stay within 0.02 of the uncached route at every
    ef.  ``reorder_by_keys(reorder_keys(...))`` served through K1 within
    0.005 of the original K1 sweep at every ef; a flat cache-fed build at
    50,000 (self-recall@1 logged); ``compute_embeddings_and_save_to_disk``
    -> the ``i1`` file served on the card through K1 (logged) and K1 with
    the rerank against the codes, and by ``HostGranne`` (one thread, 500
    queries, ef 120), the last two within 0.02 of the codes' ceiling;
    ``WordEmbeddingsGranne`` with words ``w0`` .. ``w49999``: 256 elements'
    own bags as text, each vector within 1e-6 of the numpy f64 normalized
    sum, top-1 an equal bag for >= 0.95.  K1 and K2 must have launched
    (``embeddings_path_launches``).
14. Host-tiered IVF: ``TieredIvf.load`` of step 9's bf16 file (blocks
    memory-mapped on the host, centroids on the card), 4,096 queries in
    batches of 1,024 at nprobe 4, 16 and 64: ids overlap the
    device-resident ``search_batch`` >= 0.999 and ``search_batches`` equals
    ``search_batches_sequential``; the walls of both and of the resident
    search, the blocks fetched a batch and the pinned H2D rate are logged.
    Then step 9's int8 chunked build with ``device_resident=False`` ->
    ``TieredIvf.from_ivf`` at nprobe 16 must equal the device copy of the
    same index, ids and distances.  The pair store must have launched
    (``tiered_path_launches``).
15. Multi-device serving (``granne_tpu_torch.parallel``), ranks spawned by
    ``run_ranks`` after the parent has built the kernels.  (a) A world of
    one through NCCL on cuda:0: ``ShardedIvf.load`` of step 9's bf16 file
    at nprobe 4, 16 and 64 must equal the resident ``search_batch``, ids and
    distances; ``TieredShardedIvf.load`` must give ``TieredIvf``'s ids;
    ``ShardedGranne.load`` of a one-shard directory over step 5's pair must
    overlap the uncached f32 search of that pair >= 0.999 at every ef (its
    recall, and the resident IVF recalls of the bf16 file and of step 9's
    int8 chunked index, saved by step 9, are (b)'s bars).  (b) A world of
    four through gloo, every rank on cuda:0 (four ranks sharing one card:
    no scale-out figure): ``ShardedIvf.load`` of the bf16 file (250 blocks
    a rank) and of the int8 file (1,002 blocks: two padding blocks) must
    reach the one-device recall at each nprobe (the int8 index at nprobe
    16), and the fused route (K5) overlap the K4 route >= 0.999;
    ``TieredShardedIvf.load`` must overlap ``ShardedIvf`` >= 0.999;
    ``ShardedGranne.build`` of the 200,000 vectors in 4 shards of 50,000
    (step 5's config) must reach (a)'s single-device recall at every ef,
    and save -> load in the four ranks give the same ids.  Every rank must
    return the same answers.  Logged: build seconds, QPS (batch 1,024) a
    world and route, the merge's time and, for gloo, the bytes through the
    host a batch, the step's wall.  The pair store and K5 must have launched
    in the ranks (``sharded_path_launches``).
16. The data-parallel build (``build_layers(..., group=...)``,
    ``parallel/dp_build.py``: each wave's search split over the ranks, its
    edges all-gathered, the graph update replicated), ranks spawned by
    ``run_ranks`` after the parent has built the kernels, at step 5's
    config.  (a) A world of one through NCCL on cuda:0 over all 200,000
    vectors; (b) a world of four through gloo, every rank on cuda:0, over
    the same 200,000; (c) a world of four through gloo with the flat
    cache-fed build (K1 in every rank's beam) over step 7's 50,000.  Each
    build must have step 5's (step 7's) layer counts, byte-equal layers on
    every rank, and rank 0's graph served like step 5 (bf16 copy, flat
    cache, K1) must reach recall@10 0.95 at some ef <= 120 and stay within
    0.01 (c: 0.02) of step 5's (step 7's) recall at every ef.  (a) and (b)
    must have edge Jaccard > 0.95 against step 5's graph over all layers
    and on every layer of a wave (1,024) or more.  Logged: every layer's
    Jaccard (the group's warm-up waves are S elements where one device's
    are 8, which moves the layers built in warm-up waves alone most: 0.924
    on the 60-element layer in an H100 run), whether (b)'s layers equal
    (a)'s, each build's seconds and vectors/s beside step 5's, the
    all-gather's share of the build (a rank's waves timed on the host with
    the device synchronised before and after the collective,
    ``trace.summary()``), the step's wall.  Four ranks share one card: no
    figure is a scale-out rate.  K1 must have launched in (c)'s ranks
    (``dp_build_path_launches``).
17. ``hnsw_profile``: under ``torch.profiler``, one warm serve batch of
    1,024 queries at ef 32 through K1 (step 5's index) and one warm segment
    of eight reinsert waves (wave 1,024 at ef 50, the build's second pass)
    over a copy of step 5's bottom layer: host wall, device time, busy
    share, device op count and the five largest ops of each.  No gate.

Numbers of steps 10-17 are logged beside ``nvidia-smi``'s card name and
power limit, host figures also beside the host's CPU model and threads.

Every kernel and its plain version are timed on the same inputs in turns
(plain, kernel, kernel, plain) two ways: ``device_ms`` / ``plain_ms``, CUDA
events around replays of one CUDA graph that holds all the timed calls
(device time alone; K1/K2 take 50 calls with their own random ``sel_ids``
each, rows drawn from the whole 819 MB / 1.2 GB table, so the 50 MB L2
stays cold), and ``eager_ms`` / ``plain_eager_ms``, CUDA events around a
host loop of the same calls (what a caller pays per call, host included).
``ms`` is ``device_ms``.  With ``--baseline-nbr-score``, an earlier
``nbr_score.cu`` with the same C interface is built beside this checkout's
and its K1/K2 timed in the same graph turns (``baseline_device_ms``); with
``--baseline-ivf-score`` the same for an earlier ``ivf_score.cu`` and its
K3/K4/K5 at the serve shape and on the path's slots (an earlier K5 as its
wrapper called it, after two ``torch.full`` fills of its outputs:
``baseline_with_fills``).  A baseline that fails to build fails the run.
Each kernel's record carries the bound for its timed work (the larger of
bytes over 3.35 TB/s and bf16 operations over 989 TFLOP/s, the H100 SXM
peaks) and ``library_ms``: null for K1-K5 (no single PyTorch call gathers
rows by id and contracts them), ``torch.topk``'s time for ``row_top_k``.
Any failed phase exits non-zero.  The last two lines of stdout are the
kernel table and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N, D, N_QUERIES, K = 200_000, 100, 4096, 10
M, BUILD_EF, WAVE, EXPAND = 20, 100, 1024, 4
SERVE_B = 1024
EFS = (32, 40, 60, 80, 120)
TARGET_RECALL = 0.95
K1_ATOL = 1e-4
K2_ATOL = 1e-4
TIMED_LAUNCHES = 50  # calls per timed loop, and per captured graph
GRAPH_REPLAYS = 5
RECALL_SLACK = 0.02  # a cache-fed build may lose this much recall against the main path
F32_OVERLAP = 0.999  # f32-table serving vs the uncached f32 search
FLAT_BUILD_N = 50_000
SELF_RECALL_ROWS = 1024  # rows searched for self-recall@1 after a flat cache-fed build
I8_SELF_RECALL = 0.95  # the int8 cache-fed build's self-recall@1 bar (JAX's test_int8_neighbor_cache_build)
I8_CEILING_SLACK = 0.02  # an int8 route may end this far below its codes' exact ceiling at the last ef
I8_RERANK_SLACK = 0.005  # the reranked dequantized route may trail the K1 route this much at any ef
# H100 SXM peaks (NVIDIA's data sheet) for the bound of each kernel's work
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# IVF: bench.py's IVF row (n_clusters = N // 300, 10 k-means iterations, L = 256)
IVF_CLUSTERS, IVF_ITERS, IVF_CAP = N // 300, 10, 256
NPROBES = (4, 8, 16, 32, 64)
ROUTE_AGREEMENT = 0.999
I8_CHUNK, I8_NPROBE, I8_SLACK = 50_000, 16, 0.01
IVF_ATOL = 1e-4
IVF_TIMED = 20
# K3/K4/K5 shapes: (name, blocks, L, d, slots); cap 32 and k_out 10 throughout
IVF_CASES = (
    ("serve", 1000, 256, 100, 1520),  # the IVF path's shape: 1,000 blocks, nprobe 4 x 4,096 queries
    ("tail", 1000, 256, 100, 1521),  # S % 8 != 0: a shorter last group
    ("big-block", 6, 512, 300, 40),  # 307 KB (bf16) / 614 KB (f32) blocks
)
IVF_SLOT_CAP, IVF_GROUP = 32, 8
PATH_NPROBE = 4  # the IVF path's slots for K3-K5 timed on its own keys (the first nprobe reaching 0.95)
PAIR_FILL = 0.3  # the share of slot places holding a pair in the pair store's cases (the cells' slot_fill)
# the pair store at the IVF cells' shapes: (name, block dtype, blocks, L, d, queries, nprobe)
PAIR_CELL_SHAPES = (("glove100-ivf", "bfloat16", 6467, 256, 100, 10_000, 8),
                    ("deep96-i8-ivf", "int8", 23_590, 512, 96, 10_000, 32))
PAIR_CELL_TIMED = 4  # calls a timed graph at the cells' shapes (the plain version holds ~15 GB a call at deep96's)
# row_top_k: the IVF cell's probe (10,000 queries x 6,467 blocks, nprobe 8) and merge (nprobe 8 x L 256, k 10)
ROW_TOPK_SHAPES = (("probe", 10_000, 6467, 8), ("merge", 10_000, 2048, 10))
ROW_TOPK_INPUTS = 2  # score matrices timed in turn (each past the 50 MB L2)
HOST_QUERIES = 500  # bench.py's single-core baseline queries (bench.py:574-591)
# the read-write phase: base, rows a thread, rows a call.  The base is cut
# from 50,000: every flush re-inserts and re-prunes the whole bottom layer
# (the resumable build's semantics), which took 15-19 s a flush at 50,000
# on an H100 80GB HBM3 (700 W) with the search thread running beside it
RW_BASE, RW_PER_THREAD, RW_CALL = 20_000, 5_120, 512
RW_VISIBLE = 0.98  # the visibility bar: inserted rows found right after insert_batch returns
# step 13, bag-of-embeddings elements: 50 words a centre of bench.py's 1,000, bags of 2-8 words of one centre
EMB_WORDS_PER_CENTRE, EMB_MIN_TERMS, EMB_MAX_TERMS = 50, 2, 8
EMB_BAR = 0.90  # the uncached route's bar at some ef <= 120 (0.95 is logged)
EMB_TIE = 1e-6  # a returned id counts if its exact distance is within this of the true 10th
EMB_REORDER_SLACK = 0.005  # the reordered K1 sweep against the original at every ef
TEXT_QUERIES, TEXT_SELF_TOP1 = 256, 0.95
# step 14, host-tiered IVF: step 9's bf16 file, batches of SERVE_B
TIER_NPROBES = (4, 16, 64)
# step 15, multi-device serving: step 9's files, the nprobes of (a)'s equality and (b)'s recall bars,
# the nprobe of the logged QPS, and the time a world of ranks may take before the run fails
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
IVF_FILE, I8_IVF_FILE = os.path.join(OUT_DIR, "index.ivf"), os.path.join(OUT_DIR, "index_i8.ivf")
SHARD_WORLD, SHARD_NPROBES, SHARD_QPS_NPROBE, SHARD_TIMEOUT = 4, (4, 16, 64), 16, 600
RECALL_EPS = 1e-9  # "sharded recall >= one-device recall" up to the summation order of recall_at_k
VECS_FILE = os.path.join(OUT_DIR, "vecs.npy")  # bench_data()'s vectors for the ranks of steps 15 and 16
# step 16, the data-parallel build: the gloo world, the Jaccard bar against step 5's graph, the recall
# step 5 (a, b) may differ by at any ef (c: RECALL_SLACK against step 7), and the time a world may take
DP_WORLD, DP_JACCARD, DP_SLACK, DP_TIMEOUT = 4, 0.95, 0.01, 600
PROFILE_WAVES = 8  # hnsw_profile's segment of reinsert waves


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, args_list, torch) -> float:
    """Eager milliseconds per call of ``fn`` over ``args_list``: CUDA events
    around a host loop of calls, so the host's cost per call shows whenever
    it exceeds the device's."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)


def capture(torch, fn, args_list):
    """One CUDA graph of ``fn`` over every entry of ``args_list``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    return graph


def replay_ms(torch, graph, calls: int) -> float:
    """Device milliseconds per call of a captured graph of ``calls`` calls:
    CUDA events around GRAPH_REPLAYS replays after one warm replay, so no
    host work sits between the launches."""
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * calls)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for work of ``nbytes`` moved and
    ``flops`` bf16 operations, and which of the two bounds it."""
    t_bytes, t_ops = float(nbytes) / HBM_BYTES_PER_S * 1e3, float(flops) / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gather_bound(torch, sels, row_bytes: int, out_bytes_per_dot: int, M: int) -> dict:
    """Bound of one neighbor-cache scorer call, averaged over the timed
    ``sels``: each distinct selected row read once (its data lanes only),
    the ids and queries read once, the outputs written once."""
    B, E = sels[0].shape
    rows = np.mean([int(torch.unique(s.clamp(0, N - 1)).numel()) for s in sels])
    nbytes = rows * row_bytes + B * E * 4 + B * D * 2 + B * E * M * out_bytes_per_dot
    return bound(nbytes, 2.0 * B * E * M * D)


def timed_pair(torch, kernel, plain, args, baseline=None) -> dict:
    """Per-call times of ``kernel`` and ``plain`` over ``args``, in turns
    plain, kernel, kernel, plain so both see the same drift: ``device_ms``
    / ``plain_ms`` from graph replay (device time alone), ``eager_ms`` /
    ``plain_eager_ms`` from the eager loop (what a caller pays per call).
    ``baseline``, an earlier build of the kernel, adds
    ``baseline_device_ms``, timed in turns with the kernel's graph."""
    cuda_ms(kernel, args[:3], torch)  # warm: builds, allocator, caches
    cuda_ms(plain, args[:3], torch)
    p1, k1, k2, p2 = (cuda_ms(f, args, torch) for f in (plain, kernel, kernel, plain))
    fns = {"plain_ms": plain, "device_ms": kernel}
    if baseline is not None:
        fns["baseline_device_ms"] = baseline
    graphs = {key: capture(torch, fn, args) for key, fn in fns.items()}
    order = list(graphs) + list(graphs)[::-1]
    times = {key: [] for key in graphs}
    for key in order:
        times[key].append(replay_ms(torch, graphs[key], len(args)))
    del graphs
    return {"eager_ms": (k1 + k2) / 2, "plain_eager_ms": (p1 + p2) / 2,
            **{key: sum(t) / len(t) for key, t in times.items()}}


def scorer_cases(torch, gen, tab, check, kernel, plain, baseline, bound_of, what):
    """Check ``kernel`` against ``plain`` and time both, at B = SERVE_B and
    E in (1, 4), TIMED_LAUNCHES random ``sel_ids`` each (rows from the
    whole table, so the 50 MB L2 stays cold across a graph's replays).
    Returns {E: times and bound} and the largest error."""
    from granne_tpu_torch.ops import distance

    out, worst = {}, 0.0
    for E in (1, 4):
        sels = [
            torch.randint(-2, N, (SERVE_B, E), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(TIMED_LAUNCHES)
        ]
        q = distance.normalize(torch.randn((SERVE_B, D), generator=gen, device="cuda")).to(torch.bfloat16)
        worst = max(worst, check(kernel(tab, sels[0], q), plain(tab, sels[0], q), E))
        out[E] = {**timed_pair(torch, kernel, plain, [(tab, s, q) for s in sels], baseline), **bound_of(sels)}
        log(f"{what} B={SERVE_B} E={E}: max_abs_err={worst} {out[E]}")
    return out, worst


def k1_phase(torch, base_lib):
    """K1 vs its plain version at the serve shape.  Returns the kernel record
    (timed at E=1, the serving path's); both E are logged."""
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels import nbr_score as ns
    from granne_tpu_torch.ops.nbr_cache import pack_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    vecs = distance.normalize(torch.randn((N, M, D), generator=gen, device=dev)).to(torch.bfloat16)
    adj = torch.randint(0, N, (N, M), generator=gen, device=dev, dtype=torch.int32)
    adj[::2, M // 2 :] = -1  # every other row half-unfilled: -1 embeds as bf16 NaN lanes
    adj[1, :3] = torch.tensor([0x7F85, 0xFF90, 0x1FF85], dtype=torch.int32)  # NaN-pattern halves
    tab = pack_rows(vecs, "flat", ids=adj)
    del vecs

    def check(got, want, E):
        (ker_d, ker_n), (ref_d, ref_n) = got, want
        torch.cuda.synchronize()
        if not torch.equal(ker_n, ref_n):
            fail(f"K1 ids differ from the plain version at E={E}")
        if not bool(torch.isfinite(ker_d).all()):
            fail(f"K1 gave non-finite dots at E={E} (NaN id lanes leaked)")
        err = float((ker_d - ref_d).abs().max())
        if err > K1_ATOL:
            fail(f"K1 dots differ from the plain version by {err} > {K1_ATOL} at E={E}")
        return err

    baseline = None
    if base_lib is not None:
        baseline = lambda t, s, qq: ns.launch_flat(base_lib, t, s, qq, M, D)  # noqa: E731
    by_e, err = scorer_cases(
        torch, gen, tab, check,
        lambda t, s, qq: ns.gather_score_flat(t, s, qq, M=M, d=D),
        lambda t, s, qq: ns.gather_score_flat_reference(t, s, qq, M=M, d=D),
        baseline, lambda sels: gather_bound(torch, sels, (M * D + 2 * M) * 2, 8, M), "K1",
    )
    del tab
    torch.cuda.empty_cache()
    return {"max_abs_err": err, **by_e[1]}  # the main path serves with expand=1


def k1_int8_phase(torch) -> dict:
    """K1 vs its plain version on an int8-provenance table (``cache_rows``
    of int8 codes, half-unfilled rows) at the serve shape, E in (1, 4), with
    both lane forms of int8 queries: the exact unit query (within K1_ATOL)
    and the int8 codes as bf16 (up to 127: within K1_ATOL times each
    query's lane norm).  Returns the two largest errors."""
    from granne_tpu_torch import AngularIntVectors
    from granne_tpu_torch.elements.angular_int import IntQueries
    from granne_tpu_torch.ops.kernels import nbr_score as ns
    from granne_tpu_torch.ops.nbr_cache import make_neighbor_cache

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    el = AngularIntVectors.from_raw(torch.randn((N, D), generator=gen, device=dev), device=dev)
    adj = torch.randint(0, N, (N, M), generator=gen, device=dev, dtype=torch.int32)
    adj[::2, M // 2 :] = -1
    tab = make_neighbor_cache(adj, el)
    errs = {"int8_unit_lanes_max_abs_err": 0.0, "int8_code_lanes_max_scaled_err": 0.0}
    for E in (1, 4):
        sel = torch.randint(-2, N, (SERVE_B, E), generator=gen, device=dev, dtype=torch.int32)
        q = el.prepare_queries(torch.randn((SERVE_B, D), generator=gen, device=dev))
        for key, queries in (("int8_unit_lanes_max_abs_err", q),
                             ("int8_code_lanes_max_scaled_err", IntQueries(q.vecs, q.inv_norms))):
            lanes = el.query_lanes(queries)
            dots, nbrs = ns.gather_score_flat(tab, sel, lanes, M=M, d=D)
            ref_d, ref_n = ns.gather_score_flat_reference(tab, sel, lanes, M=M, d=D)
            torch.cuda.synchronize()
            if not torch.equal(nbrs, ref_n) or not bool(torch.isfinite(dots).all()):
                fail(f"K1 on the int8 table: ids differ or dots not finite ({key}, E={E})")
            scale = lanes.float().norm(dim=1, keepdim=True) if "code" in key else 1.0
            err = float(((dots - ref_d).abs() / scale).max())
            if err > K1_ATOL:
                fail(f"K1 on the int8 table differs from the plain version: {key} {err} > {K1_ATOL} at E={E}")
            errs[key] = max(errs[key], err)
        log(f"K1 int8 table B={SERVE_B} E={E}: {errs} (code lanes up to {float(lanes.abs().max())})")
    del tab, el, adj
    torch.cuda.empty_cache()
    return errs


def k2_phase(torch, base_lib):
    """K2 vs its plain version at the tiled layout's shape.  Returns the
    kernel record (timed at E=4, the build beam's, where the path launches
    it most); both E are logged."""
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels import nbr_score as ns
    from granne_tpu_torch.ops.nbr_cache import pack_rows, tiled_height

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    tab = pack_rows(distance.normalize(torch.randn((N, M, D), generator=gen, device=dev)).to(torch.bfloat16), "tiled")
    if tab.shape != (N, tiled_height(M), 128):
        fail(f"tiled table has shape {tuple(tab.shape)}")

    def check(got, want, E):
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail(f"K2 gave non-finite dots at E={E}")
        err = float((got - want).abs().max())
        if err > K2_ATOL:
            fail(f"K2 dots differ from the plain version by {err} > {K2_ATOL} at E={E}")
        return err

    baseline = None
    if base_lib is not None:
        baseline = lambda t, s, qq: ns.launch_tiled(base_lib, t, s, qq, M)  # noqa: E731
    by_e, err = scorer_cases(
        torch, gen, tab, check,
        lambda t, s, qq: ns.gather_score(t, s, qq, M=M),
        lambda t, s, qq: ns.gather_score_reference(t, s, qq, M=M),
        baseline, lambda sels: gather_bound(torch, sels, M * D * 2, 4, M), "K2",
    )
    del tab
    torch.cuda.empty_cache()
    return {"max_abs_err": err, **by_e[4]}


def bench_data():
    """bench.py's synthetic generator, verbatim (seed 42)."""
    rng = np.random.default_rng(42)
    n_clusters = 1000
    centers = rng.standard_normal((n_clusters, D)).astype(np.float32)
    assign = rng.integers(0, n_clusters, N)
    vecs = (centers[assign] + 0.35 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (
        centers[rng.integers(0, n_clusters, N_QUERIES)]
        + 0.35 * rng.standard_normal((N_QUERIES, D))
    ).astype(np.float32)
    return vecs, queries


def exact_topk(torch, vecs, queries):
    """Exact f32 top-K ids by cosine: a check, computed on the card."""
    from granne_tpu_torch.ops import distance

    xn = distance.normalize(torch.as_tensor(vecs, device="cuda"))
    qn = distance.normalize(torch.as_tensor(queries, device="cuda"))
    out = []
    for lo in range(0, qn.shape[0], SERVE_B):
        dots = qn[lo : lo + SERVE_B] @ xn.T
        out.append(dots.topk(K, dim=1).indices)
    return torch.cat(out).cpu().numpy()


def recall_at_k(ids, gt) -> float:
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)]))


def overlap(a, b) -> float:
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def check_result(torch, ids, dists, n, what):
    """Shape, id range and finite distances of one search result; numpy ids."""
    if not bool(torch.isfinite(dists[ids >= 0]).all()):
        fail(f"non-finite distances in {what}")
    ids = ids.cpu().numpy()
    if ids.shape != (N_QUERIES, K) or ids.min() < -1 or ids.max() >= n:
        fail(f"malformed search result in {what}: shape {ids.shape}")
    return ids


def ivf_case(torch, dtype, k, L, d, S, seed):
    """Unit-norm blocks (int8: their codes and inverse norms), a padded
    tail of -1 ids in every block, random slot keys, bf16 query groups."""
    from granne_tpu_torch.ops import distance

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = distance.normalize(torch.randn((k, L, d), generator=gen, device=dev))
    scales = torch.ones((k, L), dtype=torch.float32, device=dev)
    if dtype == torch.int8:
        blocks = distance.quantize_i8(rows)
        scales = distance.inv_norms_i8(blocks)
    else:
        blocks = rows.to(dtype)
    ids = torch.arange(k * L, dtype=torch.int32, device=dev).reshape(k, L)
    ids[:, L - L // 5 :] = -1
    keys = torch.randint(0, k, (S,), generator=gen, device=dev, dtype=torch.int32)
    qg = distance.normalize(torch.randn((S, IVF_SLOT_CAP, d), generator=gen, device=dev)).to(torch.bfloat16)
    return blocks, ids, scales, keys, qg


def pair_store_bound(torch, blocks, keys, qg, slot_pairs) -> dict:
    """Bound of one pair-store call: each distinct block read once with its
    ids and scales, the query groups, keys and places read once, the held
    places' rows written once, the held places' dots."""
    L, d = blocks.shape[1:]
    S, cap = slot_pairs.shape
    held = int((slot_pairs >= 0).sum())
    nbytes = (int(torch.unique(keys).numel()) * L * (d * blocks.element_size() + 8) + S * cap * (d * 2 + 4) + S * 4
              + held * L * 4)
    return bound(nbytes, 2.0 * held * L * d)


def pair_store_timed(torch, inputs, calls) -> dict:
    """The pair store and its plain version timed in turns on ``inputs``
    (blocks, ids, scales, keys, qg, slot_pairs, out), ``calls`` a graph,
    with its bound."""
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    blocks, _, _, keys, qg, slot_pairs, _ = inputs
    return {**timed_pair(torch, lambda *a: KS.ivf_score_pairs(*a, group=IVF_GROUP), KS.ivf_score_pairs_reference,
                         [inputs] * calls),
            **pair_store_bound(torch, blocks, keys, qg, slot_pairs)}


def ivf_times(torch, inputs, base_lib) -> dict:
    """K3/K4/K5, the pair store and their plain versions timed in turns on
    ``inputs`` (blocks, ids, scales, keys, qg, slot_pairs, out), each with
    its bound; with ``base_lib`` an earlier build's K3/K4/K5 too (its K5 as
    its wrapper called it, after two ``torch.full`` fills of the outputs).
    Returns {kernel: record}."""
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    blocks, _, _, keys, qg, _, _ = inputs
    L, d = blocks.shape[1:]
    S = keys.shape[0]
    args = [inputs[:5]] * IVF_TIMED
    pairs = {
        "ivf_score_slots": (lambda b, _i, _s, kk, q: KS.ivf_score_slots(b, kk, q),
                            lambda b, _i, _s, kk, q: KS.ivf_score_slots_reference(b, kk, q)),
        "ivf_score_slots_grouped": (
            lambda b, _i, _s, kk, q: KS.ivf_score_slots_grouped(b, kk, q, group=IVF_GROUP),
            lambda b, _i, _s, kk, q: KS.ivf_score_slots_reference(b, kk, q)),
        "ivf_score_topk": (lambda *a: KS.ivf_score_topk(*a, k_out=K),
                           lambda *a: KS.ivf_score_topk_reference(*a, k_out=K)),
    }
    # each distinct block read once (K5 also its ids and scales), the query
    # groups and keys read once, the outputs written once
    blocks_read = int(torch.unique(keys).numel()) * L
    q_bytes = S * qg.shape[1] * d * 2 + S * 4
    flops = 2.0 * S * qg.shape[1] * L * d
    slot_bound = bound(blocks_read * d * blocks.element_size() + q_bytes + S * qg.shape[1] * L * 4, flops)
    topk_bound = bound(blocks_read * (d * blocks.element_size() + 8) + q_bytes + S * qg.shape[1] * K * 8, flops)
    base = {}
    if base_lib is not None:
        base = {"ivf_score_slots": lambda b, _i, _s, kk, q: KS.launch_scores(base_lib, b, kk, q, 1),
                "ivf_score_slots_grouped": lambda b, _i, _s, kk, q: KS.launch_scores(base_lib, b, kk, q, IVF_GROUP),
                "ivf_score_topk": lambda b, i, s, kk, q: KS.launch_topk(base_lib, b, i, s, kk, q, K, prefill=True)}
    out = {}
    for kname, (kernel, plain) in pairs.items():
        out[kname] = {**timed_pair(torch, kernel, plain, args, base.get(kname)),
                      **(topk_bound if kname == "ivf_score_topk" else slot_bound),
                      "distinct_blocks": blocks_read // L}
    out["ivf_score_pairs"] = {**pair_store_timed(torch, inputs, IVF_TIMED), "distinct_blocks": blocks_read // L}
    return out


def place_pairs(torch, S, seed):
    """Slot places as a search's grouping leaves them: about PAIR_FILL of
    the places of the first seven eighths of the ``S`` slots hold distinct
    pairs, every other place -1.  Returns (slot_pairs int32 [S, cap], the
    number of pairs)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    held = torch.rand((S, IVF_SLOT_CAP), generator=gen, device="cuda") < PAIR_FILL
    held[S - S // 8 :] = False
    P = int(held.sum())
    slot_pairs = torch.full((S, IVF_SLOT_CAP), -1, dtype=torch.int32, device="cuda")
    slot_pairs[held] = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    return slot_pairs, P


def check_pair_store(torch, inputs, k4, what) -> float:
    """The pair store on ``inputs`` (blocks, ids, scales, keys, qg,
    slot_pairs, out) against K4's scores ``k4`` times the row's scale, -inf
    where the id is negative (bit for bit, every row it writes), and
    against its plain version (the same -inf places, values within
    IVF_ATOL).  Returns the largest difference from the plain version."""
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    blocks, ids, scales, keys, qg, slot_pairs, out = inputs
    got = KS.ivf_score_pairs(blocks, ids, scales, keys, qg, slot_pairs, out.fill_(-torch.inf), group=IVF_GROUP)
    plain = KS.ivf_score_pairs_reference(blocks, ids, scales, keys, qg, slot_pairs, torch.full_like(out, -torch.inf))
    held = slot_pairs >= 0
    k = keys.long()
    want = torch.where((ids[k] >= 0)[:, None, :], k4 * scales[k][:, None, :], -torch.inf)[held]
    if not torch.equal(got[slot_pairs[held].long()].view(torch.int32), want.view(torch.int32)):
        fail(f"ivf_score_pairs differs from K4's scores times the row scales ({what})")
    fin = torch.isfinite(plain)
    if not torch.equal(torch.isfinite(got), fin):
        fail(f"ivf_score_pairs -inf places differ from the plain version ({what})")
    err = float((got[fin] - plain[fin]).abs().max())
    if err > IVF_ATOL:
        fail(f"ivf_score_pairs differs from the plain version by {err} > {IVF_ATOL} ({what})")
    del got, plain, want
    return err


def pair_store_cells(torch) -> dict:
    """The pair store at PAIR_CELL_SHAPES (see the module docstring, step
    4): checked, then timed beside its plain version and bound.  Returns
    {shape name: record}."""
    from granne_tpu_torch.index import ivf
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    out = {}
    for seed, (what, dtype, k, L, d, B, nprobe) in enumerate(PAIR_CELL_SHAPES):
        dtype = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(100 + seed)
        blocks = torch.empty((k, L, d), dtype=dtype, device="cuda")
        scales = torch.ones((k, L), dtype=torch.float32, device="cuda")
        for lo in range(0, k, 2048):  # unit rows, drawn in chunks to bound the f32 draw
            rows = distance.normalize(torch.randn((min(2048, k - lo), L, d), generator=gen, device="cuda"))
            if dtype == torch.int8:
                blocks[lo : lo + 2048] = distance.quantize_i8(rows)
                scales[lo : lo + 2048] = distance.inv_norms_i8(blocks[lo : lo + 2048])
            else:
                blocks[lo : lo + 2048] = rows.to(dtype)
            del rows
        ids = torch.arange(k * L, dtype=torch.int32, device="cuda").reshape(k, L)
        ids[:, L - L // 5 :] = -1
        q = distance.normalize(torch.randn((B, d), generator=gen, device="cuda"))
        probes = torch.rand((B, k), generator=gen, device="cuda").argsort(dim=1)[:, :nprobe]
        keys, qg, slot_pairs = ivf.slot_groups(q, probes, blocks, group_cap=IVF_SLOT_CAP,
                                               num_slots=ivf.slot_count(k, B, nprobe, IVF_SLOT_CAP))[:3]
        inputs = (blocks, ids, scales, keys, qg, slot_pairs,
                  torch.empty((B * nprobe, L), dtype=torch.float32, device="cuda"))
        k4 = KS.ivf_score_slots_grouped(blocks, keys, qg, group=IVF_GROUP)
        err = check_pair_store(torch, inputs, k4, f"{what} shape")
        del k4, probes, q
        rec = {**pair_store_timed(torch, inputs, PAIR_CELL_TIMED), "max_abs_err": err, "slots": keys.shape[0],
               "pairs": B * nprobe, "held_places": int((slot_pairs >= 0).sum()),
               "distinct_blocks": int(torch.unique(keys).numel())}
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        log(f"ivf_score_pairs at {what}'s shape ({str(dtype)[6:]} blocks {k} x L {L} x d {d}, {B} queries, "
            f"nprobe {nprobe}): {rec}")
        out[what] = rec
        del blocks, scales, ids, keys, qg, slot_pairs, inputs
        torch.cuda.empty_cache()
    return out


def ivf_kernel_phase(torch, base_lib):
    """K3/K4/K5 vs their plain versions (and, with ``base_lib``, an earlier
    build's K3/K4/K5 timed in the same turns).  Returns {kernel: record}."""
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    recs = {n: {"max_abs_err": 0.0}
            for n in ("ivf_score_slots", "ivf_score_slots_grouped", "ivf_score_topk", "ivf_score_pairs")}
    for seed, (name, k, L, d, S) in enumerate(IVF_CASES):
        slot_pairs, P = place_pairs(torch, S, seed)
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            blocks, ids, scales, keys, qg = ivf_case(torch, dtype, k, L, d, S, seed)
            ref = KS.ivf_score_slots_reference(blocks, keys, qg)
            k3 = KS.ivf_score_slots(blocks, keys, qg)
            k4 = KS.ivf_score_slots_grouped(blocks, keys, qg, group=IVF_GROUP)
            v, i = KS.ivf_score_topk(blocks, ids, scales, keys, qg, k_out=K)
            rv, ri = KS.ivf_score_topk_reference(blocks, ids, scales, keys, qg, k_out=K)
            torch.cuda.synchronize()
            what = f"{name} {str(dtype).replace('torch.', '')}"
            row_scale = scales[keys.long()][:, None, :]  # int8 raw dots run to ~400: compare cosines
            for kname, got in (("ivf_score_slots", k3), ("ivf_score_slots_grouped", k4)):
                if not bool(torch.isfinite(got).all()):
                    fail(f"{kname} gave non-finite scores ({what})")
                err = float(((got - ref) * row_scale).abs().max())
                if err > IVF_ATOL:
                    fail(f"{kname} differs from the plain version by {err} > {IVF_ATOL} ({what})")
                recs[kname]["max_abs_err"] = max(recs[kname]["max_abs_err"], err)
            fin = torch.isfinite(rv)
            if not torch.equal(torch.isfinite(v), fin) or not bool((i[~fin] == -1).all()):
                fail(f"ivf_score_topk -inf/-1 padding differs from the plain version ({what})")
            err = float((v[fin] - rv[fin]).abs().max())
            # neighbours in plain's ranking, the first value past the last column included
            rv1 = KS.ivf_score_topk_reference(blocks, ids, scales, keys, qg, k_out=K + 1)[0]
            gaps = (rv1[..., 1:] - rv1[..., :-1]).abs() <= IVF_ATOL
            near = torch.zeros_like(rv1, dtype=torch.bool)
            near[..., 1:] |= gaps
            near[..., :-1] |= gaps
            near = near[..., :K]
            if err > IVF_ATOL or not torch.equal(i[~near], ri[~near]):
                fail(f"ivf_score_topk differs from the plain version ({what}): value err {err}")
            recs["ivf_score_topk"]["max_abs_err"] = max(recs["ivf_score_topk"]["max_abs_err"], err)
            inputs = (blocks, ids, scales, keys, qg, slot_pairs, torch.empty((P, L), device="cuda"))
            err = check_pair_store(torch, inputs, k4, what)
            recs["ivf_score_pairs"]["max_abs_err"] = max(recs["ivf_score_pairs"]["max_abs_err"], err)
            times = {}
            if name == "serve":
                times = ivf_times(torch, inputs, base_lib)
                if dtype == torch.bfloat16:  # the main path's block type
                    for kname, t in times.items():
                        recs[kname].update(**t)
            log(f"K3/K4/K5/pair store {what} S={S}: errs k3/k4/k5/pairs = {[recs[n]['max_abs_err'] for n in recs]} "
                f"times = {times}")
            del blocks, ids, scales, keys, qg, ref, k3, k4, v, i, rv, ri, rv1, inputs
    # exactly duplicated block rows tie in any summation order: the lower
    # column first, within a row tile and across the big block's row tiles
    for k, L, d, S, cols, k_out in ((4, 64, 40, 6, [3, 10, 30], 5), (6, 512, 300, 9, [5, 95, 96, 300, 401], 10)):
        blocks, ids, scales, keys, qg = ivf_case(torch, torch.bfloat16, k, L, d, S, 7)
        for c in cols[1:]:
            blocks[2, c] = blocks[2, cols[0]]
        keys[:] = 2
        qg[:, 0] = blocks[2, cols[0]]
        _, i = KS.ivf_score_topk(blocks, ids, scales, keys, qg, k_out=k_out)
        torch.cuda.synchronize()
        if not torch.equal(i[:, 0, : len(cols)], ids[2, cols].expand(S, len(cols))):
            fail(f"ivf_score_topk broke an exact tie away from the lower column (L={L}): {i[0, 0].tolist()}")
    torch.cuda.empty_cache()
    recs["ivf_score_pairs"]["cell_shapes"] = pair_store_cells(torch)
    return recs


def row_topk_phase(torch) -> dict:
    """``row_top_k`` vs its plain version (``ops/topk.py::top_k``) at
    ROW_TOPK_SHAPES: values and columns equal, then the kernel and the plain
    sort timed in turns (``timed_pair``) and ``torch.topk`` (the library
    yardstick, which the port never calls) timed the same two ways, each
    beside the bound (each score read once, k values and columns written).
    Returns {shape name: record}."""
    from granne_tpu_torch.ops.kernels.row_topk import row_top_k
    from granne_tpu_torch.ops.topk import top_k

    def library(x, k):
        return torch.topk(x, k, dim=1)

    out = {}
    for what, R, C, k in ROW_TOPK_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(C)
        xs = [torch.randn((R, C), generator=gen, device="cuda") for _ in range(ROW_TOPK_INPUTS)]
        for x in xs:
            (v, i), (pv, pi) = row_top_k(x, k), top_k(x, k)
            if not (torch.equal(i, pi) and torch.equal(v, pv)):
                rows = int((i != pi).any(1).sum())
                fail(f"row_top_k differs from the plain sort at the {what} shape [{R} x {C}] k {k}: {rows} rows")
        args = [(xs[n % ROW_TOPK_INPUTS], k) for n in range(IVF_TIMED)]
        rec = timed_pair(torch, row_top_k, top_k, args)
        cuda_ms(library, args[:3], torch)
        graph = capture(torch, library, args)
        rec.update(library_ms=replay_ms(torch, graph, len(args)), library_eager_ms=cuda_ms(library, args, torch),
                   **bound(R * C * 4 + R * k * 12, 0), shape=[R, C, k])
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        del graph, xs
        log(f"row_top_k {what} [{R} x {C}] k={k}: {rec}")
        out[what] = rec
    torch.cuda.empty_cache()
    return out


def batched(index, queries):
    """``search(lo, ef)``: ``index.search_batch`` on ``queries[lo : lo + SERVE_B]``."""
    return lambda lo, ef: index.search_batch(queries[lo : lo + SERVE_B], max_search=ef, num_neighbors=K)


def search_all(torch, search, ef):
    """``search(lo, ef)`` over every query in batches of SERVE_B; (ids, dists)
    on the card."""
    out = [search(lo, ef) for lo in range(0, N_QUERIES, SERVE_B)]
    ids, dists = torch.cat([i for i, _ in out]), torch.cat([d for _, d in out])
    torch.cuda.synchronize()
    return ids, dists


def reset_launch_counts():
    from granne_tpu_torch.ops.kernels import ivf_score as KS
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score, gather_score_flat
    from granne_tpu_torch.ops.kernels.row_topk import row_top_k

    for fn in (gather_score_flat, gather_score, KS.ivf_score_slots, KS.ivf_score_slots_grouped, KS.ivf_score_topk,
               KS.ivf_score_pairs, row_top_k):
        fn.launches = 0


def main_path(torch, g, vecs, queries, gt):
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat

    reset_launch_counts()  # count the main path's launches only
    builder, build_s = build_index(torch, g, vecs, "main path")

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ipath, epath = os.path.join(out_dir, "index.gtz"), os.path.join(out_dir, "elements.gt")
    builder.save_index(ipath, compressed=True)
    builder.save_elements(epath)
    loaded = g.load_granne(ipath, epath, device="cuda")
    built = builder.get_index()
    for a, b in zip(built.layers.as_numpy(), loaded.layers.as_numpy()):
        if not np.array_equal(np.sort(a, axis=1), np.sort(b, axis=1)):  # the codec sorts rows
            fail("the loaded index differs from the built one")
    if not torch.equal(built.elements.vectors, loaded.elements.vectors):
        fail("the loaded elements differ from the built ones")
    log(f"save/load: index {os.path.getsize(ipath)} bytes (compressed), "
        f"elements {os.path.getsize(epath)} bytes; round trip equal")

    serve = Granne(layers=loaded.layers, elements=loaded.elements.as_bf16()).with_neighbor_cache("flat")
    del built, builder
    recalls = serve_sweep(torch, batched(serve, queries), gt, N, "bf16+flat cache")
    launches = gather_score_flat.launches
    if launches <= 0:
        fail("the main path never launched gather_score_flat")
    log(f"gather_score_flat launches in the main path: {launches}")
    return launches, recalls, build_s


def serve_sweep(torch, search, gt, n, what, need_bar=True, recall_of=None):
    """Recall@K of ``search(lo, ef)`` (see ``search_all``) at every ef in EFS,
    and the QPS at the first ef that reaches TARGET_RECALL.  If none does,
    fail, or with ``need_bar=False`` (the int8 ceiling may sit under the bar)
    log the QPS at the best ef as "below bar".  ``recall_of(ids)`` replaces
    ``recall_at_k(ids, gt)`` where given.  Returns {ef: recall}."""
    recall_of = recall_of or (lambda ids: recall_at_k(ids, gt))
    recalls, chosen = {}, None
    for ef in EFS:
        ids, dists = search_all(torch, search, ef)
        recalls[ef] = recall_of(check_result(torch, ids, dists, n, f"the {what} search at ef={ef}"))
        log(f"{what} search ef={ef}: recall@{K}={recalls[ef]}")
        if chosen is None and recalls[ef] >= TARGET_RECALL:
            chosen = ef
            log_qps(torch, search, recalls, ef, what, "")
    if chosen is None:
        if need_bar:
            fail(f"{what}: recall@{K} stayed below {TARGET_RECALL} for every ef in {EFS}")
        log_qps(torch, search, recalls, max(EFS, key=lambda e: recalls[e]), what, f" below bar {TARGET_RECALL}")
    return recalls


def log_qps(torch, search, recalls, ef, what, note):
    """Log the QPS of one warm repeat of ``search`` over every query at ``ef``."""
    _, qps = timed_search(torch, lambda: search_all(torch, search, ef))
    log(f"serve {what}: ef={ef} recall@{K}={recalls[ef]} qps={qps} (batch {SERVE_B}){note}")


def build_index(torch, g, vecs, what, element_type="angular", **cfg):
    """GranneBuilder(element_type) over ``vecs`` in 50,000-row appends ->
    build; returns (builder, build seconds)."""
    builder = g.GranneBuilder(
        element_type, num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND,
        show_progress=True, device="cuda", **cfg,
    )
    for lo in range(0, len(vecs), 50_000):
        builder.append(vecs[lo : lo + 50_000])
    t = time.perf_counter()
    builder.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    counts = [builder.layer_len(i) for i in range(builder.num_layers)]
    log(f"{what} build: {element_type} n={len(vecs)} d={D} M={M} ef={BUILD_EF} wave={WAVE} expand={EXPAND} {cfg} "
        f"seconds={build_s} vectors_per_s={len(vecs) / build_s} layer_counts={counts}")
    if counts[-1] != len(vecs):
        fail(f"{what}: the bottom layer holds {counts[-1]} of {len(vecs)} elements")
    return builder, build_s


def tiled_cache_path(torch, g, vecs, queries, gt, main_recalls):
    """The cache-fed tiled build and its serving, then f32-table and
    reranked serving on the same graph.  Returns K2's launches in the
    build and tiled serving."""
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops import frontier
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score
    from granne_tpu_torch.ops.nbr_cache import make_neighbor_cache

    reset_launch_counts()  # count this path's launches only
    builder, _ = build_index(torch, g, vecs, "tiled cache-fed", neighbor_cache=True, neighbor_cache_layout="tiled")
    build_launches = gather_score.launches
    if build_launches <= 0:
        fail("the tiled cache-fed build never launched gather_score")
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    ipath, epath = os.path.join(out_dir, "index_tiled.gtz"), os.path.join(out_dir, "elements_tiled.gt")
    builder.save_index(ipath, compressed=True)
    builder.save_elements(epath)
    del builder
    loaded = g.load_granne(ipath, epath, device="cuda")
    serve = Granne(layers=loaded.layers, elements=loaded.elements.as_bf16()).with_neighbor_cache("tiled")
    recalls = serve_sweep(torch, batched(serve, queries), gt, N, "bf16+tiled cache")
    ef = next(e for e in EFS if recalls[e] >= TARGET_RECALL)
    if recalls[ef] < main_recalls[ef] - RECALL_SLACK:
        fail(f"the tiled cache-fed build's recall {recalls[ef]} at ef={ef} is more than {RECALL_SLACK} "
             f"below the main path's {main_recalls[ef]}")
    launches = gather_score.launches
    log(f"gather_score launches: {build_launches} in the build, {launches} with tiled serving")
    del serve

    ef = EFS[0]
    f32 = Granne(layers=loaded.layers, elements=loaded.elements)
    f32_tab = Granne(layers=loaded.layers, elements=loaded.elements, nbr_vecs=make_neighbor_cache(
        loaded.layers.layers[-1], loaded.elements, rows=N, cache_dtype="f32"))
    (p_ids, p_d), qps_plain = timed_search(torch, lambda: search_all(torch, batched(f32, queries), ef))
    (c_ids, c_d), qps_tab = timed_search(torch, lambda: search_all(torch, batched(f32_tab, queries), ef))
    p_ids = check_result(torch, p_ids, p_d, N, "the uncached f32 search")
    c_ids = check_result(torch, c_ids, c_d, N, "the f32-table search")
    agree = overlap(c_ids, p_ids)
    log(f"serve f32 + f32 flat table: ef={ef} recall@{K}={recall_at_k(c_ids, gt)} qps={qps_tab} "
        f"overlap_with_uncached={agree}; uncached f32: recall@{K}={recall_at_k(p_ids, gt)} qps={qps_plain}")
    if agree < F32_OVERLAP:
        fail(f"f32-table serving overlaps the uncached f32 search {agree} < {F32_OVERLAP}")
    del f32_tab

    bf16 = Granne(layers=loaded.layers, elements=loaded.elements.as_bf16()).with_neighbor_cache("flat")
    unit_q = loaded.elements.prepare_queries(queries)

    def reranked(lo, ef):
        return frontier.search_layers(
            bf16.layers.layers, bf16.elements, bf16.elements.prepare_queries(queries[lo : lo + SERVE_B]),
            ef=ef, num_neighbors=K, nbr_vecs=bf16.nbr_vecs, rerank=True, rerank_with=loaded.elements,
            rerank_queries=unit_q[lo : lo + SERVE_B],
        )

    (n_ids, n_d), qps_plain = timed_search(torch, lambda: search_all(torch, batched(bf16, queries), ef))
    (r_ids, r_d), qps_rr = timed_search(torch, lambda: search_all(torch, reranked, ef))
    r_plain = recall_at_k(check_result(torch, n_ids, n_d, N, "the bf16 flat-cache search"), gt)
    r_rr = recall_at_k(check_result(torch, r_ids, r_d, N, "the reranked bf16 flat-cache search"), gt)
    log(f"serve bf16+flat cache, rerank against f32: ef={ef} recall@{K}={r_rr} qps={qps_rr}; "
        f"without rerank recall@{K}={r_plain} qps={qps_plain}")
    if r_rr < r_plain:
        fail(f"rerank against the f32 container lowered recall@{K}: {r_rr} < {r_plain}")
    return launches


def flat_cache_path(torch, g, vecs, queries):
    """The flat cache-fed build (K1 in the build beam) at FLAT_BUILD_N and
    its bf16 flat-cache serving.  Returns K1's launches in the build and
    the serving recalls by ef."""
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat

    sub = vecs[:FLAT_BUILD_N]
    gt = exact_topk(torch, sub, queries)
    reset_launch_counts()
    builder, _ = build_index(torch, g, sub, "flat cache-fed", neighbor_cache=True, neighbor_cache_layout="flat")
    launches = gather_score_flat.launches
    if launches <= 0:
        fail("the flat cache-fed build never launched gather_score_flat")
    log(f"gather_score_flat launches in the flat cache-fed build: {launches}")
    idx = builder.get_index()
    serve = Granne(layers=idx.layers, elements=idx.elements.as_bf16()).with_neighbor_cache("flat")
    recalls = serve_sweep(torch, batched(serve, queries), gt, FLAT_BUILD_N,
                          f"flat cache-fed build n={FLAT_BUILD_N}, bf16+flat cache")
    log(f"flat cache-fed build n={FLAT_BUILD_N}: self-recall@1={self_recall(torch, serve, sub)} "
        f"over {SELF_RECALL_ROWS} rows (bf16+flat cache, ef={EFS[0]})")
    return launches, recalls


def self_recall(torch, index, rows) -> float:
    """Self-recall@1 of the first SELF_RECALL_ROWS ``rows`` searched at EFS[0]."""
    ids, _ = index.search_batch(rows[:SELF_RECALL_ROWS], max_search=EFS[0], num_neighbors=1)
    torch.cuda.synchronize()
    return float(np.mean(ids[:, 0].cpu().numpy() == np.arange(SELF_RECALL_ROWS)))


def int8_ceiling(torch, el, queries, gt) -> float:
    """Recall@K of an exact top-K under the codes' own scoring (exact
    dequantized unit rows x f32 unit queries) against the f32 ground truth:
    the most a search over these codes can reach."""
    from granne_tpu_torch.ops import distance

    rows = el.cache_rows_exact(torch.arange(len(el), device="cuda"))
    qn = distance.normalize(torch.as_tensor(queries, device="cuda"))
    ids = torch.cat([(qn[lo : lo + SERVE_B] @ rows.T).topk(K, dim=1).indices for lo in range(0, len(qn), SERVE_B)])
    return recall_at_k(ids.cpu().numpy(), gt)


def int8_path(torch, g, vecs, queries, gt):
    """int8 elements end to end: GranneBuilder("angular_int") -> build ->
    save/load (the i1 element file) -> four serving routes, the int8
    ceilings, the tiled refusal, and the flat cache-fed int8 build.  Returns
    K1's launches on this path."""
    from granne_tpu_torch import AngularIntVectors, BuildConfig, build_layers
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops import distance, frontier
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat
    from granne_tpu_torch.ops.nbr_cache import make_neighbor_cache

    reset_launch_counts()  # count this path's launches only
    builder, _ = build_index(torch, g, vecs, "int8", element_type="angular_int")
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ipath, epath = os.path.join(out_dir, "index_i8.gtz"), os.path.join(out_dir, "elements_i8.gt")
    builder.save_index(ipath, compressed=True)
    builder.save_elements(epath)
    loaded = g.load_granne(ipath, epath, device="cuda")
    built = builder.get_index()
    for a, b in zip(built.layers.as_numpy(), loaded.layers.as_numpy()):
        if not np.array_equal(np.sort(a, axis=1), np.sort(b, axis=1)):
            fail("the loaded int8 index differs from the built one")
    el8 = loaded.elements
    if not isinstance(el8, AngularIntVectors) or not torch.equal(el8.vectors, built.elements.vectors) \
            or not torch.equal(el8.inv_norms, built.elements.inv_norms):
        fail("the loaded int8 elements differ from the built ones")
    log(f"int8 save/load: index {os.path.getsize(ipath)} bytes (compressed), "
        f"elements {os.path.getsize(epath)} bytes (i1); codes and inv_norms equal")
    del built, builder
    layers = loaded.layers.layers
    unit_q = distance.normalize(torch.as_tensor(queries, device="cuda"))

    def dequantized_route(el, capped=True, rerank=True, descent_ef=4):
        """bench.py's hnsw-i8-cache shape by default: the bf16 copy through the
        flat cache, max_iters capped, the exact rerank against ``el``."""
        dq = el.dequantized()
        tab = make_neighbor_cache(layers[-1], dq, rows=N)

        def search(lo, ef):
            return frontier.search_layers(
                layers, dq, dq.prepare_queries(queries[lo : lo + SERVE_B]), ef=ef, num_neighbors=K, expand=1,
                descent_ef=descent_ef, max_iters=max(8, ef - 6) if capped else None, nbr_vecs=tab, rerank=rerank,
                rerank_with=el, rerank_queries=unit_q[lo : lo + SERVE_B],
            )
        return search

    ceiling = int8_ceiling(torch, el8, queries, gt)
    el8r = AngularIntVectors.from_raw(vecs, rounding="nearest", device="cuda")
    ceiling_rtn = int8_ceiling(torch, el8r, queries, gt)
    log(f"int8 ceilings (exact top-{K} under the codes' own scoring): trunc recall@{K}={ceiling}, "
        f"nearest recall@{K}={ceiling_rtn}")

    r1 = serve_sweep(torch, lambda lo, ef: frontier.search_layers(
        layers, el8, el8.prepare_queries(queries[lo : lo + SERVE_B]), ef=ef, num_neighbors=K, expand=4,
        descent_ef=4), gt, N, "int8 uncached (expand 4, descent_ef 4)", need_bar=False)
    serve = Granne(layers=loaded.layers, elements=el8).with_neighbor_cache("flat")
    before = gather_score_flat.launches
    r2 = serve_sweep(torch, batched(serve, queries), gt, N, "int8 + flat cache (K1, unit lanes)", need_bar=False)
    if gather_score_flat.launches <= before:
        fail("int8 flat-cache serving never launched gather_score_flat")
    del serve
    r3 = serve_sweep(torch, dequantized_route(el8), gt, N, "int8 dequantized bf16 + flat cache + rerank",
                     need_bar=False)
    for what, kw in (("default max_iters", {"capped": False}), ("no rerank", {"rerank": False}),
                     ("descent_ef 1", {"descent_ef": 1})):  # what each part of that route's shape costs or buys
        serve_sweep(torch, dequantized_route(el8, **kw), gt, N, f"int8 dequantized variant ({what})", need_bar=False)
    r4 = serve_sweep(torch, dequantized_route(el8r), gt, N, "int8 nearest dequantized bf16 + flat cache + rerank",
                     need_bar=False)
    last = EFS[-1]
    for what, r, ceil in (("K1", r2, ceiling), ("rerank", r3, ceiling), ("nearest rerank", r4, ceiling_rtn)):
        if r[last] < ceil - I8_CEILING_SLACK:
            fail(f"int8 {what} route: recall {r[last]} at ef={last} is more than {I8_CEILING_SLACK} "
                 f"below its ceiling {ceil}")
    for ef in EFS:
        if r3[ef] < r2[ef] - I8_RERANK_SLACK:
            fail(f"int8 rerank route recall {r3[ef]} trails the K1 route's {r2[ef]} by more than "
                 f"{I8_RERANK_SLACK} at ef={ef}")
    log(f"int8 routes at ef={last}: uncached {r1[last]}, K1 {r2[last]}, rerank {r3[last]}, "
        f"nearest rerank {r4[last]}; ceilings trunc {ceiling}, nearest {ceiling_rtn}")
    serve_launches = gather_score_flat.launches
    del el8r

    for what, refuse in (
        ("serving", lambda: Granne(layers=loaded.layers, elements=el8).with_neighbor_cache("tiled")),
        ("build", lambda: build_layers(el8, BuildConfig(num_neighbors=M, max_search=BUILD_EF, neighbor_cache=True,
                                                        neighbor_cache_layout="tiled"))),
    ):
        try:
            refuse()
        except ValueError as e:
            log(f"int8 + tiled {what} refused: {e}")
        else:
            fail(f"int8 + tiled {what} did not raise")
    del loaded

    sub = vecs[:FLAT_BUILD_N]
    before = gather_score_flat.launches
    builder, _ = build_index(torch, g, sub, "int8 flat cache-fed", element_type="angular_int",
                             neighbor_cache=True, neighbor_cache_layout="flat")
    build_launches = gather_score_flat.launches - before
    if build_launches <= 0:
        fail("the int8 flat cache-fed build never launched gather_score_flat")
    idx = builder.get_index()
    rec = self_recall(torch, Granne(layers=idx.layers, elements=idx.elements).with_neighbor_cache("flat"), sub)
    log(f"int8 flat cache-fed build n={FLAT_BUILD_N}: self-recall@1={rec} over {SELF_RECALL_ROWS} rows "
        f"(int8 + flat cache, ef={EFS[0]}); K1 launches {build_launches} in the build")
    if rec < I8_SELF_RECALL:
        fail(f"the int8 flat cache-fed build's self-recall@1 {rec} < {I8_SELF_RECALL}")
    launches = gather_score_flat.launches
    log(f"gather_score_flat launches in the int8 path: {launches} ({serve_launches} serving, "
        f"{build_launches} in the cache-fed build)")
    return launches


def timed_search(torch, fn):
    """(result, QPS) of one warm repeat of ``fn()``, host clock around a
    synchronize; the first call warms."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, N_QUERIES / (time.perf_counter() - t)


def ivf_path(torch, g, vecs, queries, gt):
    """The IVF and brute-force engines through the public API.  Returns the
    launch counts of K3-K5, the pair store and ``row_top_k`` in this path
    (the search's K4 and K3 routes run the pair store)."""
    from granne_tpu_torch.index.ivf import _probe, slot_count, slot_groups
    from granne_tpu_torch.index.ivf_big import build_ivf_i8_chunked
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels import ivf_score as KS
    from granne_tpu_torch.ops.kernels.row_topk import row_top_k

    reset_launch_counts()  # count this path's launches only
    t = time.perf_counter()
    built = g.IvfIndex.build(vecs, n_clusters=IVF_CLUSTERS, kmeans_iters=IVF_ITERS, cluster_cap=IVF_CAP,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"ivf build: n={N} clusters={IVF_CLUSTERS} blocks={built.k} L={built.cluster_cap} "
        f"seconds={time.perf_counter() - t}")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = IVF_FILE
    built.save(path)
    ivf = g.IvfIndex.load(path, device="cuda")
    for name in ("centroids", "block_ids", "block_scales"):
        if not torch.equal(getattr(ivf, name), getattr(built, name)):
            fail(f"the loaded IVF index's {name} differ from the built ones")
    if not torch.equal(ivf.blocks.view(torch.int16), built.blocks.view(torch.int16)) or ivf.n_total != N:
        fail("the loaded IVF blocks differ from the built ones")
    log(f"ivf save/load: {os.path.getsize(path)} bytes; round trip equal")
    del built

    chosen = None
    for nprobe in NPROBES:
        ids, dists = ivf.search_batch(queries, K, nprobe=nprobe)
        ids = check_result(torch, ids, dists, N, f"the IVF search at nprobe={nprobe}")
        recall = recall_at_k(ids, gt)
        log(f"ivf bf16 nprobe={nprobe}: recall@{K}={recall}")
        if chosen is None and recall >= TARGET_RECALL:
            chosen = dict(nprobe=nprobe, recall=recall)
            for route, kw in (("k4", {}), ("k3", {"slot_group": 1}), ("k5_fused", {"fused_topk": True})):
                (r_ids, r_d), qps = timed_search(torch, lambda: ivf.search_batch(queries, K, nprobe=nprobe, **kw))
                r_ids = check_result(torch, r_ids, r_d, N, f"the IVF {route} route")
                agree = overlap(r_ids, ids)
                log(f"ivf route {route}: nprobe={nprobe} qps={qps} recall@{K}={recall_at_k(r_ids, gt)} "
                    f"overlap_with_k4={agree} (batch {N_QUERIES})")
                if agree < ROUTE_AGREEMENT:
                    fail(f"the IVF {route} route agrees {agree} < {ROUTE_AGREEMENT} with the K4 route")
    if chosen is None:
        fail(f"IVF recall@{K} stayed below {TARGET_RECALL} for every nprobe in {NPROBES}")
    ivf_profile(torch, ivf, queries, PATH_NPROBE)
    q = distance.normalize(torch.as_tensor(queries, device="cuda"))
    S = slot_count(ivf.k, len(queries), PATH_NPROBE, IVF_SLOT_CAP)
    keys, qg, slot_pairs = slot_groups(q, _probe(q, ivf.centroids, PATH_NPROBE), ivf.blocks,
                                       group_cap=IVF_SLOT_CAP, num_slots=S)[:3]
    path_inputs = (ivf.blocks, ivf.block_ids, ivf.block_scales, keys, qg, slot_pairs,
                   torch.full((len(queries) * PATH_NPROBE, ivf.cluster_cap), -torch.inf, device="cuda"))
    del ivf

    brute = g.BruteForceIndex.build(vecs, device="cuda")
    (b_ids, b_d), qps = timed_search(torch, lambda: brute.search_batch(queries, K))
    log(f"brute bf16: recall@{K}={recall_at_k(check_result(torch, b_ids, b_d, N, 'brute bf16'), gt)} "
        f"qps={qps} (batch {N_QUERIES})")
    del brute

    codes = distance.quantize_i8(distance.normalize(torch.as_tensor(vecs, device="cuda"))).cpu().numpy()
    brute8 = g.BruteForceIndex.build(vecs, storage="int8", device="cuda")
    (b_ids, b_d), qps = timed_search(torch, lambda: brute8.search_batch(queries, K))
    r_b8 = recall_at_k(check_result(torch, b_ids, b_d, N, "brute int8"), gt)
    log(f"brute int8: recall@{K}={r_b8} qps={qps} (batch {N_QUERIES})")
    del brute8
    t = time.perf_counter()
    ivf8 = build_ivf_i8_chunked(codes, n_clusters=IVF_CLUSTERS, cluster_cap=IVF_CAP, kmeans_iters=IVF_ITERS,
                                chunk=I8_CHUNK, device="cuda", log=log)
    torch.cuda.synchronize()
    log(f"ivf int8 build (chunked, {-(-N // I8_CHUNK)} chunks): blocks={ivf8.k} seconds={time.perf_counter() - t}")
    ivf8.save(I8_IVF_FILE)  # served again by step 15's ranks
    for route, kw in (("k4", {}), ("k5_fused", {"fused_topk": True})):
        (i_ids, i_d), qps = timed_search(torch, lambda: ivf8.search_batch(queries, K, nprobe=I8_NPROBE, **kw))
        r_i8 = recall_at_k(check_result(torch, i_ids, i_d, N, f"the int8 IVF {route} route"), gt)
        log(f"ivf int8 {route}: nprobe={I8_NPROBE} recall@{K}={r_i8} qps={qps} (int8 brute {r_b8})")
        if r_i8 < r_b8 - I8_SLACK:
            fail(f"int8 IVF recall {r_i8} is more than {I8_SLACK} below int8 brute force {r_b8}")

    launches = {f.__name__: f.launches for f in (KS.ivf_score_slots, KS.ivf_score_slots_grouped, KS.ivf_score_topk,
                                                   KS.ivf_score_pairs, row_top_k)}
    log(f"IVF kernel launches in the IVF path: {launches}")
    for name in ("ivf_score_pairs", "ivf_score_topk", "row_top_k"):
        if launches[name] <= 0:
            fail(f"the IVF path never launched {name}")
    return launches, path_inputs


def host_tag(card, threads) -> str:
    """The card's name and power limit, and for a host figure the CPU (as
    ``lscpu`` names it: vendor, model name, family and model numbers) and
    the thread count, to stand beside each number."""
    cpu = platform.machine()
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        f = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
        f = {k.strip(): v.strip() for k, v in f.items()}
        cpu = (f"{f.get('Vendor ID', '?')} {f.get('Model name', '?')} "
               f"(family {f.get('CPU family', '?')}, model {f.get('Model', '?')})")
    except (OSError, subprocess.SubprocessError):
        pass
    return f"[{card}; host {cpu}, {os.cpu_count()} cores, {threads} threads]"


def reorder_phase(torch, g, queries, gt, main_recalls, card):
    """Phase a: the main path's saved 200k f32 graph, loaded on the card,
    reordered by ``Granne.reorder()`` (trails on the card); the order, the
    bands and a sample of rows checked; the reordered graph served as bf16
    through a fresh flat cache (K1), ids mapped back through ``order``; the
    reordered pair saved.  Returns (K1 launches, (index, elements) paths,
    order)."""
    from granne_tpu_torch.index import io
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    loaded = g.load_granne(os.path.join(out_dir, "index.gtz"), os.path.join(out_dir, "elements.gt"), device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    reordered, order = loaded.reorder()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    if not np.array_equal(np.sort(order), np.arange(N)):
        fail("the reorder's order is not a permutation")
    counts = loaded.layers.counts
    if reordered.layers.counts != counts or reordered.nbr_vecs is not None:
        fail(f"the reordered layer counts {reordered.layers.counts} differ from {counts} (or it kept a cache)")
    prev = 0
    for count in counts:
        if not np.array_equal(np.sort(order[prev:count]), np.arange(prev, count)):
            fail(f"the reorder moved ids across the band [{prev}, {count})")
        prev = count
    order_t = torch.as_tensor(order, device="cuda")
    rng = np.random.default_rng(0)
    for li, (old, new, count) in enumerate(zip(loaded.layers.layers, reordered.layers.layers, counts)):
        rows = torch.as_tensor(rng.choice(count, min(count, 1024), replace=False), device="cuda")
        mapped = new[rows].long()
        mapped = torch.where(mapped >= 0, order_t[mapped.clamp_min(0)], -1)
        want = old[order_t[rows]].long()
        if not torch.equal(mapped.sort(dim=1).values, want.sort(dim=1).values):
            fail(f"reordered layer {li} is not isomorphic to the original on a sample of rows")
    log(f"reorder on the card: n={N} layer_counts={list(counts)} seconds={secs} "
        f"(trails through {min(8, len(counts) - 1)} upper layers); order a permutation, bands kept, "
        f"1,024 sampled rows a layer isomorphic [{card}]")
    if not torch.equal(reordered.elements.vectors, loaded.elements.vectors[order_t]):
        fail("the reordered elements are not the original rows in the new order")

    reset_launch_counts()  # count the reordered sweep's launches only
    serve = Granne(layers=reordered.layers, elements=reordered.elements.as_bf16()).with_neighbor_cache("flat")

    def search(lo, ef):  # ids in the original numbering
        ids, d = serve.search_batch(queries[lo : lo + SERVE_B], max_search=ef, num_neighbors=K)
        return torch.where(ids >= 0, order_t[ids.clamp_min(0).long()].to(torch.int32), ids), d

    recalls = serve_sweep(torch, search, gt, N, "reordered bf16+flat cache")
    log("reordered vs original recall@10 by ef: "
        + ", ".join(f"ef={ef} {recalls[ef]} vs {main_recalls[ef]}" for ef in EFS) + f" [{card}]")
    launches = gather_score_flat.launches
    if launches <= 0:
        fail("the reordered graph's sweep never launched gather_score_flat")
    log(f"gather_score_flat launches in the reordered sweep: {launches}")
    paths = (os.path.join(out_dir, "index_reordered.gtz"), os.path.join(out_dir, "elements_reordered.gt"))
    reordered.save_index(paths[0], compressed=True)
    reordered.save_elements(paths[1])
    io.save_index(loaded.layers, os.path.join(out_dir, "index_dense.gt"), compressed=False)
    log(f"reordered pair saved: index {os.path.getsize(paths[0])} bytes (compressed), "
        f"elements {os.path.getsize(paths[1])} bytes; the original graph saved dense for phase b")
    return launches, paths, order


def host_phase(torch, g, queries, gt, main_recalls, reordered_paths, order, card):
    """Phase b: ``HostGranne`` (the C++ search over memory-mapped files, CPU
    threads) on the main path's pair and the reordered pair: bench.py's
    baseline shape (the first HOST_QUERIES queries, one thread, K 10) at
    every ef, then every core at the main path's bar ef over all queries,
    the dense index once, and the int8 path's pair at ef 120 against its
    trunc ceiling over the same queries."""
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    q, q_gt = queries[:HOST_QUERIES], gt[:HOST_QUERIES]
    bar_ef = next(ef for ef in EFS if main_recalls[ef] >= TARGET_RECALL)
    pairs = (("original", (os.path.join(out_dir, "index.gtz"), os.path.join(out_dir, "elements.gt")), None),
             ("reordered", reordered_paths, order))

    def run(host, qs, ef, threads, back):
        t = time.perf_counter()
        ids, d = host.search_batch(qs, max_search=ef, num_neighbors=K, num_threads=threads)
        secs = time.perf_counter() - t
        if ids.shape != (len(qs), K) or ids.min() < -1 or ids.max() >= N or not np.isfinite(d[ids >= 0]).all():
            fail(f"malformed HostGranne result (shape {ids.shape})")
        return (ids if back is None else np.where(ids >= 0, back[np.maximum(ids, 0)], -1)), len(qs) / secs

    qps_by = {}
    for what, (ipath, epath), back in pairs:
        host = g.HostGranne(ipath, epath)
        for ef in EFS:
            ids, qps = run(host, q, ef, 1, back)
            r = recall_at_k(ids, q_gt)
            qps_by[what, ef] = qps
            log(f"host {what} (compressed, mmap): ef={ef} recall@{K}={r} qps={qps} "
                f"({HOST_QUERIES} queries) {host_tag(card, 1)}")
            if ef == 120 and r < TARGET_RECALL:
                fail(f"HostGranne on the {what} files: recall@{K} {r} < {TARGET_RECALL} at ef 120, one thread")
        threads = os.cpu_count()
        ids, qps = run(host, queries, bar_ef, threads, back)
        log(f"host {what} (compressed, mmap): ef={bar_ef} recall@{K}={recall_at_k(ids, gt)} qps={qps} "
            f"({N_QUERIES} queries) {host_tag(card, threads)}")
    log("host reordered/original one-thread qps by ef (one call): "
        + ", ".join(f"ef={ef} {qps_by['reordered', ef] / qps_by['original', ef]}" for ef in EFS))
    host = g.HostGranne(os.path.join(out_dir, "index_dense.gt"), os.path.join(out_dir, "elements.gt"))
    ids, qps = run(host, q, bar_ef, 1, None)
    log(f"host original (dense, mmap): ef={bar_ef} recall@{K}={recall_at_k(ids, q_gt)} qps={qps} "
        f"({HOST_QUERIES} queries) {host_tag(card, 1)}")

    ipath, epath = os.path.join(out_dir, "index_i8.gtz"), os.path.join(out_dir, "elements_i8.gt")
    host = g.HostGranne(ipath, epath)
    ids, qps = run(host, q, 120, 1, None)
    ceiling = int8_ceiling(torch, g.load_granne(ipath, epath, device="cuda").elements, q, q_gt)
    log(f"host int8 (i1, compressed, mmap): ef=120 recall@{K}={recall_at_k(ids, q_gt)} qps={qps} "
        f"trunc ceiling {ceiling} ({HOST_QUERIES} queries) {host_tag(card, 1)}")


def rw_phase(torch, g, vecs, queries, card):
    """Phase c: ``RwGranneBuilder`` on the card over the first RW_BASE
    vectors (the main path's build config, its final size declared); two
    threads insert RW_PER_THREAD rows each in calls of RW_CALL and check
    after every call that they find the rows just inserted (self top-1),
    while a third searches held-out queries the whole time; then a flush,
    the count, the schedule and self-recall@1 over every element, a save
    while searches run, a reload, and one HostGranne serve of the files."""
    import threading

    from granne_tpu_torch.index import schedule

    total = RW_BASE + 2 * RW_PER_THREAD
    cfg = g.BuildConfig(num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND,
                        expected_num_elements=total)
    t = time.perf_counter()
    rw = g.RwGranneBuilder(g.AngularVectors.from_raw(vecs[:RW_BASE], device="cuda"), cfg)
    torch.cuda.synchronize()
    log(f"rw base build: n={RW_BASE} seconds={time.perf_counter() - t} [{card}]")

    flush_s, hits, errors, searched = [], [], [], [0]
    stop = threading.Event()
    flush = rw.flush

    def timed_flush():  # every flush, also those insert_batch starts
        t = time.perf_counter()
        flush()
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t)

    rw.flush = timed_flush

    def guarded(fn):
        def body():
            try:
                fn()
            except BaseException as e:  # re-raised by the main thread
                errors.append(e)
                stop.set()
        return threading.Thread(target=body)

    def inserter(lo):
        for a in range(lo, lo + RW_PER_THREAD, RW_CALL):
            if stop.is_set():
                return
            rows = vecs[a : a + RW_CALL]
            rw.insert_batch(rows)
            _, d = rw.search_batch(rows, max_search=EFS[0], num_neighbors=1)
            hits.append(float((d[:, 0] <= 1e-4).float().mean()))

    def searcher():
        while not stop.is_set():
            lo = searched[0] % N_QUERIES
            ids, d = rw.search_batch(queries[lo : lo + SERVE_B], max_search=EFS[0], num_neighbors=K)
            if tuple(ids.shape) != (SERVE_B, K) or not bool(torch.isfinite(d[ids >= 0]).all()):
                raise RuntimeError(f"malformed search result during inserts: {tuple(ids.shape)}")
            searched[0] += SERVE_B

    reader = guarded(searcher)
    writers = [guarded(lambda lo=lo: inserter(lo)) for lo in (RW_BASE, RW_BASE + RW_PER_THREAD)]
    t = time.perf_counter()
    reader.start()
    for w in writers:
        w.start()
    for w in writers:
        w.join()
    insert_s = time.perf_counter() - t
    stop.set()
    reader.join()
    if errors:
        fail(f"a read-write builder thread failed: {errors[0]!r}")
    visible = min(hits)
    log(f"rw inserts: 2 threads x {RW_PER_THREAD} rows in calls of {RW_CALL}, seconds={insert_s}, "
        f"flushes={len(flush_s)} flush_seconds={flush_s} (sum {sum(flush_s)}), visible self-top-1 "
        f"min {visible} mean {float(np.mean(hits))} over {len(hits)} calls, {searched[0]} queries searched "
        f"meanwhile (ef {EFS[0]}, batch {SERVE_B}) [{card}]")
    if visible < RW_VISIBLE:
        fail(f"an insert_batch's rows were found at {visible} < {RW_VISIBLE} right after it returned")
    rw.flush()
    index = rw.get_index()
    counts = [index.layer_len(i) for i in range(index.num_layers)]
    if rw.indexed_elements != total or counts != schedule.layer_counts(total, cfg.layer_multiplier):
        fail(f"rw: {rw.indexed_elements} indexed, layer counts {counts}; want {total} and the schedule")
    hit = 0
    for lo in range(0, total, SERVE_B):
        ids, _ = index.search_batch(index.elements.vectors[lo : lo + SERVE_B], max_search=EFS[0], num_neighbors=1)
        hit += int((ids[:, 0] == torch.arange(lo, lo + len(ids), device="cuda")).sum())
    rec = hit / total
    log(f"rw after flush: indexed {total}, layer_counts={counts}, self-recall@1={rec} over all {total} "
        f"(ef {EFS[0]}) [{card}]")
    if rec < RW_VISIBLE:
        fail(f"rw self-recall@1 {rec} < {RW_VISIBLE}")

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    ipath, epath = os.path.join(out_dir, "index_rw.gtz"), os.path.join(out_dir, "elements_rw.gt")
    stop.clear()
    searched[0] = 0
    reader = guarded(searcher)
    reader.start()
    t = time.perf_counter()
    rw.save(ipath, epath)
    save_s = time.perf_counter() - t
    stop.set()
    reader.join()
    if errors:
        fail(f"the search thread failed during save: {errors[0]!r}")
    loaded = g.load_granne(ipath, epath, device="cuda")
    if len(loaded) != total or not torch.equal(loaded.elements.vectors, index.elements.vectors):
        fail("the saved read-write index does not load back as it was")
    host = g.HostGranne(ipath, epath)
    ids, _ = host.search_batch(vecs[:HOST_QUERIES], max_search=EFS[0], num_neighbors=1)
    host_rec = float(np.mean(ids[:, 0] == np.arange(HOST_QUERIES)))
    log(f"rw save under searches: seconds={save_s} ({searched[0]} queries searched meanwhile); reloaded "
        f"{len(loaded)} elements; HostGranne self-recall@1={host_rec} over {HOST_QUERIES} base rows "
        f"(ef {EFS[0]}) {host_tag(card, 1)}")
    if host_rec < RW_VISIBLE:
        fail(f"HostGranne on the saved read-write index: self-recall@1 {host_rec} < {RW_VISIBLE}")


def embeddings_data():
    """Step 13's data: 50 words for each of bench.py's 1,000 Gaussian centres
    (its generator: sigma 0.35, seed 42), each word scaled to a norm drawn
    from [0.5, 2]; N bags and N_QUERIES held-out query bags, each of 2-8
    distinct words of one centre.  Returns (words f32[50,000, D], terms and
    query terms int32[., 8] with -1 padding)."""
    rng = np.random.default_rng(42)
    n_centres = 1000
    centers = rng.standard_normal((n_centres, D)).astype(np.float32)
    centre_of = np.repeat(np.arange(n_centres), EMB_WORDS_PER_CENTRE)
    words = (centers[centre_of] + 0.35 * rng.standard_normal((len(centre_of), D))).astype(np.float32)
    words *= (rng.uniform(0.5, 2.0, len(words)) / np.linalg.norm(words, axis=1)).astype(np.float32)[:, None]

    def bags(count):
        centre = rng.integers(0, n_centres, count)
        size = rng.integers(EMB_MIN_TERMS, EMB_MAX_TERMS + 1, count)
        pick = np.argsort(rng.random((count, EMB_WORDS_PER_CENTRE)), axis=1)[:, :EMB_MAX_TERMS]
        terms = centre[:, None] * EMB_WORDS_PER_CENTRE + pick
        return np.where(np.arange(EMB_MAX_TERMS)[None, :] < size[:, None], terms, -1).astype(np.int32)

    return words, bags(N), bags(N_QUERIES)


def unit_rows(torch, container, chunk=65536):
    """Every element of a container as f32 unit rows on the card."""
    return torch.cat([container.get(torch.arange(lo, min(len(container), lo + chunk), device="cuda"))
                      for lo in range(0, len(container), chunk)])


def tie_aware(torch, rows, qn):
    """A recall@K function for unit queries over unit rows: a returned id
    counts if its exact f32 distance is within EMB_TIE of the query's true
    K-th (equal bags are equal vectors)."""
    kth = torch.cat([1.0 - (qn[lo : lo + SERVE_B] @ rows.T).topk(K, dim=1).values[:, -1]
                     for lo in range(0, len(qn), SERVE_B)])

    def recall_of(ids):
        t = torch.as_tensor(ids, device="cuda").long()
        ok = t >= 0
        dist = 1.0 - torch.einsum("bkd,bd->bk", rows[t.clamp_min(0)], qn[: len(t)])
        hit = ok & (dist <= kth[: len(t), None] + EMB_TIE)
        return float(hit.float().sum(1).clamp_max(K).mean()) / K

    return recall_of


def embeddings_path(torch, g, card):
    """Step 13: SumEmbeddings at N elements on the card: build, files,
    uncached / K1 / K2 serving, reorder_by_keys, a flat cache-fed build,
    precomputed int8 elements (card and HostGranne), WordEmbeddingsGranne.
    Returns K1's and K2's launches on this path."""
    from granne_tpu_torch.api import WordEmbeddingsGranne
    from granne_tpu_torch.elements.embeddings_etl import WordDict
    from granne_tpu_torch.index import io
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops import distance, frontier
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score, gather_score_flat

    reset_launch_counts()  # count this path's launches only
    words, terms, q_terms = embeddings_data()
    se = g.SumEmbeddings.from_parts(words, terms, device="cuda")
    qs = g.SumEmbeddings.from_parts(words, q_terms, device="cuda")
    queries = qs._sums(qs.terms).cpu().numpy()  # raw (unnormalized) query sums; search_batch normalizes
    rows = unit_rows(torch, se)
    qn = distance.normalize(torch.as_tensor(queries, device="cuda"))
    recall_of = tie_aware(torch, rows, qn)
    log(f"embeddings data: {len(words)} words x {D}, {N} bags and {N_QUERIES} query bags of "
        f"{EMB_MIN_TERMS}-{EMB_MAX_TERMS} words (T={se.terms.shape[1]}); table {se.embeddings.numel() * 4} bytes, "
        f"terms {se.terms.numel() * 4} bytes on the card [{card}]")

    cfg = g.BuildConfig(num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND, show_progress=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    layers = g.build_layers(se, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    log(f"embeddings build: SumEmbeddings n={N} d={D} T={se.terms.shape[1]} M={M} ef={BUILD_EF} wave={WAVE} "
        f"expand={EXPAND} seconds={build_s} vectors_per_s={N / build_s} layer_counts={list(layers.counts)} [{card}]")
    if layers.counts[-1] != N:
        fail(f"the embeddings build's bottom layer holds {layers.counts[-1]} of {N}")
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ipath, epath = os.path.join(out_dir, "index_emb.gtz"), os.path.join(out_dir, "elements_emb.gt")
    io.save_index(layers, ipath, compressed=True)
    io.save_elements(se, epath)
    loaded = g.load_granne(ipath, epath, device="cuda")
    if not (torch.equal(loaded.elements.terms, se.terms) and torch.equal(loaded.elements.embeddings, se.embeddings)):
        fail("the loaded SumEmbeddings elements differ from the built ones")
    log(f"embeddings save/load: index {os.path.getsize(ipath)} bytes (compressed), elements "
        f"{os.path.getsize(epath)} bytes (csr24, {io.read_elements_metadata(epath)['offsets_format']} offsets); "
        f"terms and table equal [{card}]")

    base = Granne(layers=loaded.layers, elements=loaded.elements)
    flat, tiled = base.with_neighbor_cache("flat"), base.with_neighbor_cache("tiled")

    def reranked(index):  # the final beam re-scored by the exact f32 sums
        return lambda lo, ef: frontier.search_layers(
            index.layers.layers, index.elements, index.elements.prepare_queries(queries[lo : lo + SERVE_B]), ef=ef,
            num_neighbors=K, nbr_vecs=index.nbr_vecs, rerank=True)

    sweep = {}
    for what, search in (("uncached", batched(base, queries)), ("flat cache (K1)", batched(flat, queries)),
                         ("tiled cache (K2)", batched(tiled, queries)),
                         ("flat cache (K1) + rerank", reranked(flat)), ("tiled cache (K2) + rerank", reranked(tiled))):
        sweep[what] = serve_sweep(torch, search, None, N, f"embeddings {what}", need_bar=False, recall_of=recall_of)
    uncached = sweep["uncached"]
    bar_ef = next((ef for ef in EFS if uncached[ef] >= EMB_BAR), None)
    top_ef = next((ef for ef in EFS if uncached[ef] >= TARGET_RECALL), None)
    bf16_rows = rows.to(torch.bfloat16).to(torch.float32)
    b_ids = torch.cat([(qn[lo : lo + SERVE_B].to(torch.bfloat16).to(torch.float32) @ bf16_rows.T).topk(K, dim=1).indices
                       for lo in range(0, N_QUERIES, SERVE_B)])
    bf16_ceiling = recall_of(b_ids)
    del bf16_rows
    log(f"embeddings uncached: reaches {EMB_BAR} at ef={bar_ef}, {TARGET_RECALL} at ef={top_ef}; bf16 ceiling "
        f"(an exact top-{K} under bf16 rows and bf16 query lanes, the cached routes' scoring) {bf16_ceiling} [{card}]")
    if bar_ef is None:
        fail(f"embeddings uncached recall@{K} stayed below {EMB_BAR} for every ef in {EFS}")
    for what in ("flat cache (K1)", "tiled cache (K2)"):
        if sweep[what][EFS[-1]] < bf16_ceiling - RECALL_SLACK:
            fail(f"embeddings {what} recall {sweep[what][EFS[-1]]} at ef={EFS[-1]} is more than {RECALL_SLACK} "
                 f"below its bf16 ceiling {bf16_ceiling}")
        for ef in EFS:
            if abs(sweep[what + " + rerank"][ef] - uncached[ef]) > RECALL_SLACK:
                fail(f"embeddings {what} + rerank recall {sweep[what + ' + rerank'][ef]} at ef={ef} is more than "
                     f"{RECALL_SLACK} from the uncached {uncached[ef]}")
    del tiled

    t = time.perf_counter()
    reordered, order = base.reorder_by_keys(g.reorder_keys(loaded.elements))
    torch.cuda.synchronize()
    reorder_s = time.perf_counter() - t
    order_t = torch.as_tensor(order, device="cuda")
    if not torch.equal(reordered.elements.terms, se.terms[order_t]):
        fail("the reordered SumEmbeddings terms are not the original rows in the new order")
    serve = reordered.with_neighbor_cache("flat")

    def search_back(lo, ef):  # ids in the original numbering
        ids, d = serve.search_batch(queries[lo : lo + SERVE_B], max_search=ef, num_neighbors=K)
        return torch.where(ids >= 0, order_t[ids.clamp_min(0).long()].to(torch.int32), ids), d

    r_re = serve_sweep(torch, search_back, None, N, "embeddings reordered by keys + flat cache (K1)", need_bar=False,
                       recall_of=recall_of)
    log(f"embeddings reorder_by_keys(reorder_keys): seconds={reorder_s}; reordered vs original recall@{K} by ef: "
        + ", ".join(f"ef={ef} {r_re[ef]} vs {sweep['flat cache (K1)'][ef]}" for ef in EFS) + f" [{card}]")
    for ef in EFS:
        if abs(r_re[ef] - sweep["flat cache (K1)"][ef]) > EMB_REORDER_SLACK:
            fail(f"the reordered embeddings sweep {r_re[ef]} at ef={ef} is more than {EMB_REORDER_SLACK} from "
                 f"the original's {sweep['flat cache (K1)'][ef]}")
    del serve, reordered

    sub = g.SumEmbeddings.from_parts(se.embeddings, se.terms[:FLAT_BUILD_N], device="cuda")
    before = gather_score_flat.launches
    t = time.perf_counter()
    sub_layers = g.build_layers(sub, g.BuildConfig(num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE,
                                                   expand=EXPAND, neighbor_cache=True, neighbor_cache_layout="flat"))
    torch.cuda.synchronize()
    sub_s = time.perf_counter() - t
    own = rows[:SELF_RECALL_ROWS]
    ids, _ = Granne(layers=sub_layers, elements=sub).search_batch(own, max_search=EFS[0], num_neighbors=1)
    self_rec = float(((rows[ids[:, 0].long()] * own).sum(1) >= 1.0 - EMB_TIE).float().mean())
    log(f"embeddings flat cache-fed build n={FLAT_BUILD_N}: seconds={sub_s}, K1 launches "
        f"{gather_score_flat.launches - before}; self-recall@1 (an equal vector) {self_rec} over "
        f"{SELF_RECALL_ROWS} rows (uncached, ef={EFS[0]}) [{card}]")
    del sub, sub_layers

    npz, i1 = os.path.join(out_dir, "elements_emb.npz"), os.path.join(out_dir, "elements_emb_i1.gt")
    np.savez(npz, terms=terms)
    t = time.perf_counter()
    g.compute_embeddings_and_save_to_disk(npz, words, i1, device="cuda")
    log(f"compute_embeddings_and_save_to_disk: {N} elements -> {os.path.getsize(i1)} bytes (i1) "
        f"seconds={time.perf_counter() - t} [{card}]")
    el8 = io.load_elements(i1, device="cuda")
    codes_rows = el8.cache_rows_exact(torch.arange(N, device="cuda"))
    c_ids = torch.cat([(qn[lo : lo + SERVE_B] @ codes_rows.T).topk(K, dim=1).indices
                       for lo in range(0, N_QUERIES, SERVE_B)])
    ceiling = recall_of(c_ids)
    served8 = Granne(layers=loaded.layers, elements=el8).with_neighbor_cache("flat")
    r8 = serve_sweep(torch, batched(served8, queries), None, N, "embeddings int8 (precomputed i1) + flat cache (K1)",
                     need_bar=False, recall_of=recall_of)
    r8r = serve_sweep(torch, reranked(served8), None, N, "embeddings int8 (precomputed i1) + flat cache (K1) + rerank",
                      need_bar=False, recall_of=recall_of)
    del served8
    host = g.HostGranne(ipath, i1)
    t = time.perf_counter()
    h_ids, _ = host.search_batch(queries[:HOST_QUERIES], max_search=EFS[-1], num_neighbors=K, num_threads=1)
    h_qps = HOST_QUERIES / (time.perf_counter() - t)
    recall_head = tie_aware(torch, rows, qn[:HOST_QUERIES])
    h_rec, h_ceiling = recall_head(h_ids), recall_head(c_ids[:HOST_QUERIES])
    log(f"embeddings int8: codes' ceiling recall@{K}={ceiling}; K1 route at ef={EFS[-1]} {r8[EFS[-1]]}, "
        f"reranked against the codes {r8r[EFS[-1]]}; "
        f"HostGranne (i1, compressed, mmap) ef={EFS[-1]} recall@{K}={h_rec} qps={h_qps} against ceiling "
        f"{h_ceiling} over {HOST_QUERIES} queries {host_tag(card, 1)}")
    if r8r[EFS[-1]] < ceiling - I8_CEILING_SLACK or h_rec < h_ceiling - I8_CEILING_SLACK:
        fail(f"an embeddings int8 route ends more than {I8_CEILING_SLACK} below its codes' ceiling")
    del el8, codes_rows

    wd = WordDict([f"w{i}" for i in range(len(words))])
    weg = WordEmbeddingsGranne(base, words, wd)
    picks = np.random.default_rng(7).choice(N, TEXT_QUERIES, replace=False)
    worst, found = 0.0, 0
    for i in picks:
        bag = [int(x) for x in terms[i] if x >= 0]
        v = weg.get_internal_vector(" ".join(f"w{x}" for x in bag))
        want = words[bag].astype(np.float64).sum(0)
        worst = max(worst, float(np.abs(v - want / np.linalg.norm(want)).max()))
        hit = weg.search(" ".join(f"w{x}" for x in bag), EFS[0], 1)
        found += bool(hit) and sorted(loaded.get_internal_element(hit[0][0])) == sorted(bag)
    log(f"WordEmbeddingsGranne: {TEXT_QUERIES} text queries (elements' own bags): vectors within {worst} of the "
        f"numpy f64 normalized sums; top-1 an equal bag {found / TEXT_QUERIES} (uncached, ef={EFS[0]}) [{card}]")
    if worst > 1e-6 or found / TEXT_QUERIES < TEXT_SELF_TOP1:
        fail(f"WordEmbeddingsGranne: text vectors off by {worst} or self top-1 {found / TEXT_QUERIES} "
             f"< {TEXT_SELF_TOP1}")

    launches = {"gather_score_flat": gather_score_flat.launches, "gather_score": gather_score.launches}
    log(f"K1/K2 launches in the embeddings path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the embeddings path never launched {name}")
    return launches


def tiered_path(torch, g, vecs, queries, gt, card):
    """Step 14: TieredIvf over step 9's saved bf16 file (blocks memory-mapped
    on the host), against the device-resident search at nprobe 4, 16, 64;
    pipelined and sequential walls; bytes fetched a batch and the pinned
    H2D rate; then step 9's int8 chunked build kept on the host.  Returns
    K4's launches in the tiered searches."""
    from granne_tpu_torch.index.ivf import _probe
    from granne_tpu_torch.index.ivf_big import build_ivf_i8_chunked
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    path = IVF_FILE
    t = time.perf_counter()
    tiered = g.TieredIvf.load(path, device="cuda")
    log(f"tiered load: {path} ({os.path.getsize(path)} bytes), blocks {type(tiered.host_blocks).__name__} "
        f"{tiered.host_blocks.shape} {tiered.block_dtype} on the host, seconds={time.perf_counter() - t}")
    resident = g.IvfIndex.load(path, device="cuda")
    k, L, d = resident.blocks.shape
    batches = [queries[lo : lo + SERVE_B] for lo in range(0, N_QUERIES, SERVE_B)]
    launches = 0

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def tiered_ids(run, nprobe):
        nonlocal launches
        before = KS.ivf_score_pairs.launches
        out = [i for i, _ in run(batches, K, nprobe=nprobe)]
        launches += KS.ivf_score_pairs.launches - before
        return np.concatenate(out)

    qn = distance.normalize(torch.as_tensor(queries, device="cuda"))
    pinned = torch.empty((k, L, d), dtype=torch.int16, pin_memory=True)
    for nprobe in TIER_NPROBES:
        (r_ids, r_d), r_s = timed(lambda: resident.search_batch(queries, K, nprobe=nprobe))
        r_ids = check_result(torch, r_ids, r_d, N, f"the resident IVF search at nprobe={nprobe}")
        p_ids, p_s = timed(lambda: tiered_ids(tiered.search_batches, nprobe))
        s_ids, s_s = timed(lambda: tiered_ids(tiered.search_batches_sequential, nprobe))
        agree, same = overlap(p_ids, r_ids), np.array_equal(p_ids, s_ids)
        uniq = [len(torch.unique(_probe(qn[lo : lo + SERVE_B], resident.centroids, nprobe)))
                for lo in range(0, N_QUERIES, SERVE_B)]
        nbytes = float(np.mean(uniq)) * L * d * 2
        u = max(uniq)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            pinned[:u].to("cuda", non_blocking=True)
        ev[1].record()
        torch.cuda.synchronize()
        rate = 10 * u * L * d * 2 / (ev[0].elapsed_time(ev[1]) / 1e3)
        log(f"tiered nprobe={nprobe}: recall@{K}={recall_at_k(p_ids, gt)} overlap_with_resident={agree} "
            f"pipelined==sequential {same}; wall pipelined {p_s} s, sequential {s_s} s (ratio {p_s / s_s}), "
            f"resident {r_s} s (tiered/resident {p_s / r_s}); blocks fetched a batch {float(np.mean(uniq))} of {k} "
            f"= {nbytes} bytes (bf16 rows), pinned H2D {rate / 1e9} GB/s at {u} blocks [{card}]")
        if agree < F32_OVERLAP or not same:
            fail(f"tiered nprobe={nprobe}: overlap {agree} with the resident search (< {F32_OVERLAP}) "
                 f"or pipelined != sequential")
    del pinned, resident, tiered

    codes = distance.quantize_i8(distance.normalize(torch.as_tensor(vecs, device="cuda"))).cpu().numpy()
    host8 = build_ivf_i8_chunked(codes, n_clusters=IVF_CLUSTERS, cluster_cap=IVF_CAP, kmeans_iters=IVF_ITERS,
                                 chunk=I8_CHUNK, device_resident=False, device="cuda", log=log)
    if host8.blocks.device.type != "cpu":
        fail("build_ivf_i8_chunked(device_resident=False) left its blocks on the card")
    dev8 = g.IvfIndex(centroids=host8.centroids.cuda(), blocks=host8.blocks.cuda(), block_ids=host8.block_ids.cuda(),
                      block_scales=host8.block_scales.cuda(), n_total=host8.n_total)
    w_ids, w_d = dev8.search_batch(queries, K, nprobe=I8_NPROBE)
    t8 = g.TieredIvf.from_ivf(host8, device="cuda")
    before = KS.ivf_score_pairs.launches
    got = list(t8.search_batches(batches, K, nprobe=I8_NPROBE))
    launches += KS.ivf_score_pairs.launches - before
    g_ids, g_d = np.concatenate([i for i, _ in got]), np.concatenate([x for _, x in got])
    equal = np.array_equal(g_ids, w_ids.cpu().numpy()) and np.array_equal(g_d, w_d.cpu().numpy())
    log(f"tiered int8 (build_ivf_i8_chunked device_resident=False, {host8.k} blocks on the host): nprobe={I8_NPROBE} "
        f"recall@{K}={recall_at_k(g_ids, gt)}; ids and distances equal to the device copy of the same index: {equal} "
        f"[{card}]")
    if not equal:
        fail("the tiered int8 search differs from the device-resident int8 index")
    log(f"ivf_score_pairs launches in the tiered path: {launches}")
    if launches <= 0:
        fail("the tiered path never launched ivf_score_pairs")
    return launches


# -- step 15: multi-device serving --------------------------------------------


def ivf_search(index, queries, **kw):
    """``search(lo, nprobe)`` of an IVF engine on ``queries[lo : lo + SERVE_B]``."""
    return lambda lo, nprobe: index.search_batch(queries[lo : lo + SERVE_B], K, nprobe=nprobe, **kw)


def tiered_ids(index, queries, nprobe):
    """A tiered engine's ids of every query, batches of SERVE_B through its pipeline."""
    batches = [queries[lo : lo + SERVE_B] for lo in range(0, N_QUERIES, SERVE_B)]
    return np.concatenate([i for i, _ in index.search_batches(batches, K, nprobe=nprobe)])


def rank_measures(torch, group, queries, sharded, sharded8, tiered_s, sg):
    """A rank's QPS of each sharded route (a warm repeat over every query),
    the merge's milliseconds for one batch of candidates, and the launches
    of K3-K5 and the pair store in this rank."""
    from granne_tpu_torch import all_gather_topk
    from granne_tpu_torch.ops.kernels import ivf_score as KS

    p = SHARD_QPS_NPROBE
    routes = {
        f"ShardedIvf k4 nprobe={p}": lambda: search_all(torch, ivf_search(sharded, queries), p),
        f"ShardedIvf k5_fused nprobe={p}": lambda: search_all(torch, ivf_search(sharded, queries, fused_topk=True), p),
        f"ShardedIvf int8 k4 nprobe={I8_NPROBE}": lambda: search_all(torch, ivf_search(sharded8, queries), I8_NPROBE),
        f"TieredShardedIvf nprobe={p}": lambda: tiered_ids(tiered_s, queries, p),
        f"ShardedGranne ef={EFS[0]}": lambda: search_all(torch, batched(sg, queries), EFS[0]),
    }
    qps = {name: timed_search(torch, fn)[1] for name, fn in routes.items()}
    ids = torch.arange(SERVE_B * K, dtype=torch.int32, device=group.device).reshape(SERVE_B, K)
    d = torch.rand((SERVE_B, K), device=group.device).sort(dim=1).values
    all_gather_topk(ids, d, K, group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        all_gather_topk(ids, d, K, group)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t) / 10 * 1e3
    launches = {f.__name__: f.launches
                for f in (KS.ivf_score_slots, KS.ivf_score_slots_grouped, KS.ivf_score_topk, KS.ivf_score_pairs)}
    return {"qps": qps, "merge_ms": merge_ms, "launches": launches}


def world_of_one(group, hnsw_dir, pair, queries):
    """Step 15(a), a rank of a world of one (NCCL): the sharded engines
    against the one-device searches of the same files.  The one-device
    searches run first; the launch counts are zeroed after them, so the
    rank's counts are the sharded engines' alone."""
    import torch

    import granne_tpu_torch as g
    from granne_tpu_torch.ops import distance

    distance.full_f32()
    out = {"group": group.describe(), "equal": {}, "ids": {}}
    resident, tiered = g.IvfIndex.load(IVF_FILE, device=group.device), g.TieredIvf.load(IVF_FILE, device=group.device)
    want = {nprobe: search_all(torch, ivf_search(resident, queries), nprobe) for nprobe in SHARD_NPROBES}
    want_tiered = {nprobe: tiered_ids(tiered, queries, nprobe) for nprobe in SHARD_NPROBES}
    resident8 = g.IvfIndex.load(I8_IVF_FILE, device=group.device)
    out["ids"][("ivf_i8", I8_NPROBE)] = search_all(torch, ivf_search(resident8, queries), I8_NPROBE)[0].cpu().numpy()
    single = g.load_granne(*pair, device=group.device)
    for ef in EFS:
        out["ids"][("single", ef)] = search_all(torch, batched(single, queries), ef)[0].cpu().numpy()
    del resident, tiered, resident8, single

    reset_launch_counts()
    sharded, sharded8 = g.ShardedIvf.load(IVF_FILE, group), g.ShardedIvf.load(I8_IVF_FILE, group)
    for nprobe, (r_ids, r_d) in want.items():
        s_ids, s_d = search_all(torch, ivf_search(sharded, queries), nprobe)
        out["equal"][f"ShardedIvf == IvfIndex nprobe={nprobe}"] = torch.equal(s_ids, r_ids) and torch.equal(s_d, r_d)
        out["ids"][("ivf", nprobe)] = r_ids.cpu().numpy()
    tiered_s = g.TieredShardedIvf.load(IVF_FILE, group)
    for nprobe, ids in want_tiered.items():
        out["equal"][f"TieredShardedIvf == TieredIvf nprobe={nprobe}"] = np.array_equal(
            tiered_ids(tiered_s, queries, nprobe), ids)
    sg = g.ShardedGranne.load(hnsw_dir, group)
    for ef in EFS:
        out["ids"][("granne", ef)] = search_all(torch, batched(sg, queries), ef)[0].cpu().numpy()
    out.update(rank_measures(torch, group, queries, sharded, sharded8, tiered_s, sg))
    return out


def world_of_four(group, vecs_file, out_dir, queries):
    """Step 15(b), a rank of a world of four (gloo, every rank on cuda:0)."""
    import torch

    import granne_tpu_torch as g
    from granne_tpu_torch.ops import distance

    distance.full_f32()
    reset_launch_counts()
    out = {"group": group.describe(), "ids": {}}
    sharded = g.ShardedIvf.load(IVF_FILE, group)
    for nprobe in SHARD_NPROBES:
        out["ids"][("ivf", nprobe)] = search_all(torch, ivf_search(sharded, queries), nprobe)[0].cpu().numpy()
        out["ids"][("ivf_k5", nprobe)] = search_all(
            torch, ivf_search(sharded, queries, fused_topk=True), nprobe)[0].cpu().numpy()
    sharded8 = g.ShardedIvf.load(I8_IVF_FILE, group)
    out["padding_blocks"] = int((~sharded8.centroid_valid).sum())
    out["ids"][("ivf_i8", I8_NPROBE)] = search_all(torch, ivf_search(sharded8, queries), I8_NPROBE)[0].cpu().numpy()
    tiered_s = g.TieredShardedIvf.load(IVF_FILE, group)
    for nprobe in SHARD_NPROBES:
        out["ids"][("tiered", nprobe)] = tiered_ids(tiered_s, queries, nprobe)

    vecs = np.load(vecs_file, mmap_mode="r")
    cfg = g.BuildConfig(num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND)
    group.barrier()
    t = time.perf_counter()
    sg = g.ShardedGranne.build(g.AngularVectors, vecs, cfg, group)
    torch.cuda.synchronize()
    own = time.perf_counter() - t
    group.barrier()
    out["build_s"], out["layer_counts"] = (own, time.perf_counter() - t), sg.index.layers.counts
    for ef in EFS:
        out["ids"][("granne", ef)] = search_all(torch, batched(sg, queries), ef)[0].cpu().numpy()
    sg.save(out_dir)
    loaded = g.ShardedGranne.load(out_dir, group)
    out["reloaded_equal"] = np.array_equal(search_all(torch, batched(loaded, queries), EFS[0])[0].cpu().numpy(),
                                           out["ids"][("granne", EFS[0])])
    out.update(rank_measures(torch, group, queries, sharded, sharded8, tiered_s, sg))
    return out


def sharded_path(torch, g, vecs, queries, gt, card):
    """Step 15: a world of one through NCCL, then a world of four through
    gloo on the one card (see the module docstring).  Returns the launches
    of the pair store and K5 in the ranks."""
    from granne_tpu_torch.index.ivf import read_metadata

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    hnsw_dir = os.path.join(OUT_DIR, "one_shard")
    os.makedirs(hnsw_dir, exist_ok=True)
    pair = (os.path.join(OUT_DIR, "index.gtz"), os.path.join(OUT_DIR, "elements.gt"))
    for name, target in zip(("shard0.index", "shard0.elements"), pair):
        link = os.path.join(hnsw_dir, name)
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(target, link)
    with open(os.path.join(hnsw_dir, "manifest.json"), "w") as f:
        json.dump({"num_shards": 1, "n_total": N, "shard_offsets": [0]}, f)
    vecs_file = VECS_FILE
    np.save(vecs_file, vecs)

    t = time.perf_counter()
    one = g.run_ranks(world_of_one, 1, hnsw_dir, pair, queries, backend="nccl", device="cuda",
                      timeout=SHARD_TIMEOUT)[0]
    log(f"sharded world of 1: {one['group']}, wall {time.perf_counter() - t} s (spawn included) [{card}]")
    for what, equal in one["equal"].items():
        log(f"sharded world of 1: {what}: {equal}")
        if not equal:
            fail(f"world of one: {what} is false")
    bar = {key: recall_at_k(ids, gt) for key, ids in one["ids"].items()}
    for ef in EFS:
        agree = overlap(one["ids"][("granne", ef)], one["ids"][("single", ef)])
        log(f"sharded world of 1: ShardedGranne (one shard over step 5's pair) ef={ef}: recall@{K}="
            f"{bar[('granne', ef)]} overlap_with_uncached_f32={agree} (uncached f32 recall {bar[('single', ef)]})")
        if agree < F32_OVERLAP:
            fail(f"world of one: ShardedGranne overlaps the single-device search {agree} < {F32_OVERLAP} at ef={ef}")
    log(f"sharded world of 1 (nccl): qps (batch {SERVE_B}) {one['qps']}; merge {one['merge_ms']} ms a batch; "
        f"launches {one['launches']} [{card}]")

    t = time.perf_counter()
    four = g.run_ranks(world_of_four, SHARD_WORLD, vecs_file, os.path.join(OUT_DIR, "sharded_granne"), queries,
                       backend="gloo", device="cuda", timeout=SHARD_TIMEOUT)
    log(f"sharded world of {SHARD_WORLD}: {four[0]['group']}, wall {time.perf_counter() - t} s (spawn included); "
        f"{SHARD_WORLD} ranks share one card: no scale-out figure [{card}]")
    for r, out in enumerate(four):
        same = all(np.array_equal(ids, four[0]["ids"][key]) for key, ids in out["ids"].items())
        if not same or not out["reloaded_equal"]:
            fail(f"world of {SHARD_WORLD}: rank {r} returned other ids than rank 0 ({same}) "
                 f"or its reloaded ShardedGranne other ids ({out['reloaded_equal']})")
    ids = four[0]["ids"]
    for key, a in [*one["ids"].items(), *ids.items()]:
        if a.shape != (N_QUERIES, K) or a.min() < -1 or a.max() >= N:
            fail(f"malformed sharded search result {key}: shape {a.shape}")
    padding = sum(out["padding_blocks"] for out in four)
    k8 = read_metadata(I8_IVF_FILE)["k_phys"]
    checks = []
    for nprobe in SHARD_NPROBES:
        r = recall_at_k(ids[("ivf", nprobe)], gt)
        k5 = overlap(ids[("ivf_k5", nprobe)], ids[("ivf", nprobe)])
        tier = overlap(ids[("tiered", nprobe)], ids[("ivf", nprobe)])
        log(f"sharded world of {SHARD_WORLD}: ShardedIvf bf16 nprobe={nprobe} (per rank): recall@{K}={r} "
            f"(one device {bar[('ivf', nprobe)]}); k5_fused overlap_with_k4={k5}; TieredShardedIvf overlap={tier}")
        checks += [(r >= bar[("ivf", nprobe)] - RECALL_EPS,
                    f"ShardedIvf recall {r} < one device {bar[('ivf', nprobe)]} at nprobe {nprobe}"),
                   (k5 >= ROUTE_AGREEMENT, f"the K5 route overlaps the K4 route {k5} at nprobe {nprobe}"),
                   (tier >= F32_OVERLAP, f"TieredShardedIvf overlaps ShardedIvf {tier} at nprobe {nprobe}")]
    r8 = recall_at_k(ids[("ivf_i8", I8_NPROBE)], gt)
    log(f"sharded world of {SHARD_WORLD}: ShardedIvf int8 (chunked build, {k8} blocks, {padding} padding blocks) "
        f"nprobe={I8_NPROBE}: recall@{K}={r8} (one device {bar[('ivf_i8', I8_NPROBE)]})")
    checks += [(r8 >= bar[("ivf_i8", I8_NPROBE)] - RECALL_EPS, f"int8 ShardedIvf recall {r8} < one device"),
               (padding == (-k8) % SHARD_WORLD, f"{padding} padding blocks for {k8} blocks over {SHARD_WORLD} ranks")]
    builds = [out["build_s"] for out in four]
    log(f"sharded world of {SHARD_WORLD}: ShardedGranne.build n={N} in {SHARD_WORLD} shards of {N // SHARD_WORLD} "
        f"(M={M} ef={BUILD_EF} wave={WAVE} expand={EXPAND}): seconds a rank {[b[0] for b in builds]}, to the last rank "
        f"{max(b[1] for b in builds)}; layer_counts {[out['layer_counts'] for out in four]} [{card}]")
    for ef in EFS:
        r = recall_at_k(ids[("granne", ef)], gt)
        log(f"sharded world of {SHARD_WORLD}: ShardedGranne ef={ef} expand=1: recall@{K}={r} "
            f"(one device, uncached f32: {bar[('single', ef)]})")
        checks.append((r >= bar[("single", ef)] - RECALL_EPS,
                       f"ShardedGranne recall {r} < one device {bar[('single', ef)]} at ef {ef}"))
    host_bytes = SERVE_B * K * 8
    log(f"sharded world of {SHARD_WORLD} (gloo): qps (batch {SERVE_B}) {four[0]['qps']}; merge "
        f"{[out['merge_ms'] for out in four]} ms a batch by rank; through the host a batch: {host_bytes} B a rank "
        f"down (ids int32 + dists f32), {SHARD_WORLD * host_bytes} B gathered on each host, {host_bytes} B back; "
        f"save -> load in {SHARD_WORLD} ranks gave equal ids [{card}]")
    for ok, msg in checks:
        if not ok:
            fail(f"world of {SHARD_WORLD}: {msg}")

    launches = {name: one["launches"][name] + sum(out["launches"][name] for out in four)
                for name in ("ivf_score_pairs", "ivf_score_topk")}
    log(f"pair store/K5 launches in the sharded path's ranks: {launches}; step 15 wall {time.perf_counter() - t0} s "
        f"[{card}]")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the sharded path never launched {name}")
    return launches


def device_profile(torch, run):
    """Host wall (ms) of one warm, unprofiled ``run()`` after a first call,
    then one more ``run()`` under ``torch.profiler``: the device time of its
    kernels and copies summed (ms), their count and the five largest by
    name (spans' annotations on the device track left out).  The device
    figures are None where the profiler saw no device op."""
    from torch.profiler import ProfilerActivity, profile

    run()
    t = time.perf_counter()
    run()
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not ops:
        return wall, None, None, None
    by_name = {}
    for e in ops:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
    return wall, sum(by_name.values()), len(ops), sorted(by_name.items(), key=lambda kv: -kv[1])[:5]


def log_profile(what, wall, device, n_ops, top, card):
    if device is None:
        log(f"{what}: the profiler saw no device ops (device time not measured); host_wall_ms={wall} [{card}]")
    else:
        log(f"{what}: host_wall_ms={wall} device_ms={device} busy={device / wall} device_ops={n_ops} top5={top} "
            f"[{card}]")


def ivf_profile(torch, ivf, queries, nprobe):
    """One warm ``search_batch`` of every query per route (K4, fused K5)
    under ``torch.profiler`` (``device_profile``)."""
    for route, kw in (("k4", {}), ("k5_fused", {"fused_topk": True})):
        def run():
            ivf.search_batch(queries, K, nprobe=nprobe, **kw)
            torch.cuda.synchronize()

        log_profile(f"ivf profile {route}: nprobe={nprobe} batch={len(queries)}",
                    *device_profile(torch, run), torch.cuda.get_device_name(0))


def hnsw_profile(torch, g, queries, card):
    """Step 17: one serve batch of SERVE_B at EFS[0] through K1 on step 5's
    index, and one segment of PROFILE_WAVES reinsert waves (the build's
    second pass, at BUILD_EF // 2) over a copy of step 5's bottom layer,
    each under ``device_profile``; each of the three calls of the build
    segment re-inserts its own waves, from the top of the id range down."""
    from granne_tpu_torch.index.builder import _run_waves
    from granne_tpu_torch.index.granne import Granne

    loaded = g.load_granne(os.path.join(OUT_DIR, "index.gtz"), os.path.join(OUT_DIR, "elements.gt"), device="cuda")
    serve = Granne(layers=loaded.layers, elements=loaded.elements.as_bf16()).with_neighbor_cache("flat")

    def serve_batch():
        serve.search_batch(queries[:SERVE_B], max_search=EFS[0], num_neighbors=K)
        torch.cuda.synchronize()

    log_profile(f"hnsw profile serve: K1 bf16+flat cache ef={EFS[0]} batch={SERVE_B}",
                *device_profile(torch, serve_batch), card)
    cfg = g.BuildConfig(num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND)
    prev, adj = loaded.layers.layers[:-1], loaded.layers.layers[-1].clone()
    seg, hi = PROFILE_WAVES * WAVE, [N]

    def build_segment():
        _run_waves(prev, adj, loaded.elements, hi[0] - seg, hi[0], cfg, M, BUILD_EF // 2, True)
        torch.cuda.synchronize()
        hi[0] -= seg

    log_profile(f"hnsw profile build: {PROFILE_WAVES} reinsert waves of {WAVE} at ef={BUILD_EF // 2} over step 5's "
                f"bottom layer", *device_profile(torch, build_segment), card)


# -- step 16: the data-parallel build -----------------------------------------


def dp_build_rank(group, n, cache_layout):
    """Step 16, a rank: ``build_layers(group=group)`` of the first ``n`` of
    VECS_FILE's vectors at step 5's config (a cache-fed build with
    ``cache_layout``).  The all-gather is timed in a ``trace.span`` with the
    device synchronised before the clock starts and after the collective
    (gloo's host copy synchronises there anyway).  Returns the build's
    seconds, its counts, each layer's SHA-256, rank 0's layers, K1's
    launches and the collective's seconds and count."""
    import hashlib

    import torch

    import granne_tpu_torch as g
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat
    from granne_tpu_torch.parallel import dp_build
    from granne_tpu_torch.utils import trace

    distance.full_f32()
    gather = dp_build._gather_wave

    def timed_gather(*args):
        torch.cuda.synchronize()
        with trace.span("dp_build/all_gather", block=True):
            return gather(*args)

    dp_build._gather_wave = timed_gather
    cache = {"neighbor_cache": True, "neighbor_cache_layout": cache_layout} if cache_layout else {}
    cfg = g.BuildConfig(num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND, **cache)
    elements = g.AngularVectors.from_raw(np.load(VECS_FILE, mmap_mode="r")[:n], device=group.device)
    reset_launch_counts()
    trace.reset()
    group.barrier()
    t = time.perf_counter()
    stack = g.build_layers(elements, cfg, group=group)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    layers = stack.as_numpy()
    spans = trace.summary()["dp_build/all_gather"]
    return {"group": group.describe(), "seconds": seconds, "counts": stack.counts,
            "digests": [hashlib.sha256(a.tobytes()).hexdigest() for a in layers],
            "layers": layers if group.rank == 0 else None, "k1": gather_score_flat.launches,
            "gather_s": spans["total_s"], "waves": spans["count"]}


def dp_world(torch, g, world, backend, n, cache_layout, what, card):
    """One world of step 16: spawn, check the ranks agree, log times.
    Returns rank 0's result and the launches of K1 in all ranks."""
    t = time.perf_counter()
    ranks = g.run_ranks(dp_build_rank, world, n, cache_layout, backend=backend, device="cuda", timeout=DP_TIMEOUT)
    wall = time.perf_counter() - t
    out = ranks[0]
    for r, other in enumerate(ranks):
        if other["digests"] != out["digests"] or other["counts"] != out["counts"]:
            fail(f"{what}: rank {r}'s layers differ from rank 0's")
    share = [o["gather_s"] / o["seconds"] for o in ranks]
    log(f"{what}: {out['group']}; build n={n} M={M} ef={BUILD_EF} wave={WAVE} expand={EXPAND} "
        f"cache={cache_layout}: seconds a rank {[o['seconds'] for o in ranks]}, vectors_per_s "
        f"{n / max(o['seconds'] for o in ranks)}; layer_counts={out['counts']}; the ranks' layers byte-equal "
        f"(SHA-256 of {len(out['digests'])} layers); all-gather {ranks[0]['waves']} waves, "
        f"{[o['gather_s'] for o in ranks]} s a rank, share of the build {share}; wall {wall} s (spawn included) "
        f"[{card}]")
    return out, sum(o["k1"] for o in ranks)


def dp_serve(torch, g, vecs, queries, gt, out, ref_recalls, slack, what):
    """Serve rank 0's graph like step 5 (bf16 copy, flat cache, K1) and hold
    it within ``slack`` of ``ref_recalls`` at every ef."""
    from granne_tpu_torch.index.granne import Granne

    elements = g.AngularVectors.from_raw(vecs, device="cuda")
    layers = g.LayerStack.from_numpy(out["layers"], device="cuda")
    serve = Granne(layers=layers, elements=elements.as_bf16()).with_neighbor_cache("flat")
    recalls = serve_sweep(torch, batched(serve, queries), gt, len(vecs), f"{what}, bf16+flat cache")
    gaps = {ef: recalls[ef] - ref_recalls[ef] for ef in EFS}
    log(f"{what}: recall@{K} minus the one-device build's by ef {gaps}")
    if max(abs(x) for x in gaps.values()) > slack:
        fail(f"{what}: recall differs from the one-device build's by more than {slack}: {gaps}")


def dp_build_path(torch, g, vecs, queries, gt, main_recalls, main_build_s, flat_recalls, card):
    """Step 16 (see the module docstring).  Returns K1's launches in (c)'s ranks."""
    from granne_tpu_torch.parallel.dryrun import layer_jaccard

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ref = g.load_granne(os.path.join(OUT_DIR, "index.gtz"), os.path.join(OUT_DIR, "elements.gt"), device="cpu")
    ref_layers = ref.layers.as_numpy()
    log(f"dp build: step 5's one-device build of n={N}: seconds={main_build_s} vectors_per_s={N / main_build_s} "
        f"[{card}]")
    digests = None
    for world, backend, what in ((1, "nccl", "dp build (a) world of 1"),
                                 (DP_WORLD, "gloo", f"dp build (b) world of {DP_WORLD}")):
        out, _ = dp_world(torch, g, world, backend, N, None, what, card)
        if out["counts"] != ref.layers.counts:
            fail(f"{what}: layer counts {out['counts']} differ from step 5's {ref.layers.counts}")
        per = [layer_jaccard(a, b) for a, b in zip(out["layers"], ref_layers)]
        by_layer = [a / u for a, u in per]
        pooled = sum(a for a, _ in per) / sum(u for _, u in per)
        log(f"{what}: edge Jaccard against step 5's graph by layer {by_layer}, pooled {pooled}")
        held = [j for j, c in zip(by_layer, out["counts"]) if c >= WAVE]
        if pooled <= DP_JACCARD or min(held) <= DP_JACCARD:
            fail(f"{what}: edge Jaccard against step 5's graph {pooled} pooled, {held} on the layers of a wave "
                 f"or more, not above {DP_JACCARD}")
        if digests is not None:
            log(f"{what}: layers byte-equal to (a)'s: {out['digests'] == digests}")
        digests = out["digests"]
        dp_serve(torch, g, vecs, queries, gt, out, main_recalls, DP_SLACK, what)
        del out
    what = f"dp build (c) world of {DP_WORLD}, flat cache-fed"
    sub = vecs[:FLAT_BUILD_N]
    out, launches = dp_world(torch, g, DP_WORLD, "gloo", FLAT_BUILD_N, "flat", what, card)
    dp_serve(torch, g, sub, queries, exact_topk(torch, sub, queries), out, flat_recalls, RECALL_SLACK, what)
    log(f"gather_score_flat launches in (c)'s ranks: {launches}; step 16 wall {time.perf_counter() - t0} s; "
        f"{DP_WORLD} ranks share one card: no scale-out figure [{card}]")
    if launches <= 0:
        fail("the flat cache-fed data-parallel build never launched gather_score_flat in its ranks")
    return launches


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-nbr-score", metavar="FILE.cu",
                    help="an earlier nbr_score.cu with the same C interface: built beside this checkout's "
                         "and its K1/K2 timed the same way (baseline_device_ms)")
    ap.add_argument("--baseline-ivf-score", metavar="FILE.cu",
                    help="an earlier ivf_score.cu with the same C interface: built beside this checkout's "
                         "and its K3/K4/K5 timed the same way (baseline_device_ms; K5 with its two fills)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    try:
        import granne_tpu_torch as g
    except ImportError as e:
        fail(f"granne_tpu_torch not importable next to this script: {e}")
    if not os.path.abspath(g.__file__).startswith(REPO + os.sep):
        fail(f"granne_tpu_torch comes from {g.__file__}, not from this checkout")
    from pathlib import Path

    from granne_tpu_torch.native import codec_source
    from granne_tpu_torch.native import get_lib as load_codec
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels import build, ivf_score, nbr_score, row_topk

    distance.full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    def timed_build(load):
        t = time.perf_counter()
        lib = load()
        return time.perf_counter() - t, lib

    builds = {"nbr_score.cu (nvcc)": nbr_score.load_kernel, "ivf_score.cu (nvcc)": ivf_score.load_kernel,
              "row_topk.cu (nvcc)": row_topk.load_kernel,
              f"{os.path.relpath(codec_source(), REPO)} (g++)": load_codec}
    base_keys = {}
    # an earlier ivf_score.cu may predate the pair store: its baseline is not timed
    ivf_base_sigs = {fn: sig for fn, sig in ivf_score.SIGNATURES.items() if fn != "gt_ivf_score_pairs"}
    for kind, path, signatures in (("nbr_score", opts.baseline_nbr_score, nbr_score.SIGNATURES),
                                   ("ivf_score", opts.baseline_ivf_score, ivf_base_sigs)):
        if path:
            src = Path(path).resolve()
            base_keys[kind] = f"baseline {src} (nvcc)"
            builds[base_keys[kind]] = lambda src=src, kind=kind, signatures=signatures: build.load_library(
                src, build.BUILD_DIR / f"lib{kind}_baseline.so", lambda: [build.find_nvcc(), *build.NVCC_FLAGS],
                signatures)
    with ThreadPoolExecutor(len(builds)) as pool:  # every compiler at once
        futures = {name: pool.submit(timed_build, load) for name, load in builds.items()}
        log("build (in parallel): " + ", ".join(f"{name} {f.result()[0]} s" for name, f in futures.items()))
    base_lib = futures[base_keys["nbr_score"]].result()[1] if "nbr_score" in base_keys else None
    ivf_base_lib = futures[base_keys["ivf_score"]].result()[1] if "ivf_score" in base_keys else None
    for name in ("libnbr_score.so", "libnbr_score_baseline.so", "libivf_score.so", "libivf_score_baseline.so",
                 "librow_topk.so"):
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                log(f"{name} {line.strip()}")

    def no_jax(after):
        if "jax" in sys.modules or "granne_tpu" in sys.modules:
            fail(f"the port pulled in jax or the JAX package ({after})")

    rec = k1_phase(torch, base_lib)
    rec.update(k1_int8_phase(torch))
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["int8_unit_lanes_max_abs_err"])
    no_jax("K1 phase")
    k2_rec = k2_phase(torch, base_lib)
    no_jax("K2 phase")
    ivf_recs = ivf_kernel_phase(torch, ivf_base_lib)
    no_jax("K3/K4/K5 phase")
    topk_recs = row_topk_phase(torch)
    no_jax("row top-k phase")
    vecs, queries = bench_data()
    gt = exact_topk(torch, vecs, queries)
    launches, main_recalls, main_build_s = main_path(torch, g, vecs, queries, gt)
    no_jax("HNSW path")
    k2_launches = tiled_cache_path(torch, g, vecs, queries, gt, main_recalls)
    no_jax("tiled cache-fed path")
    _, flat_recalls = flat_cache_path(torch, g, vecs, queries)
    no_jax("flat cache-fed path")
    int8_launches = int8_path(torch, g, vecs, queries, gt)
    no_jax("int8 path")
    ivf_launches, path_inputs = ivf_path(torch, g, vecs, queries, gt)
    no_jax("IVF path")
    path_times = ivf_times(torch, path_inputs, ivf_base_lib)
    log(f"K3/K4/K5 and the pair store on the IVF path's own slots (nprobe {PATH_NPROBE}, "
        f"S={path_inputs[3].shape[0]}): {path_times}")
    del path_inputs
    reorder_launches, reordered_paths, order = reorder_phase(torch, g, queries, gt, main_recalls, smi)
    no_jax("reorder phase")
    host_phase(torch, g, queries, gt, main_recalls, reordered_paths, order, smi)
    no_jax("host serving phase")
    rw_phase(torch, g, vecs, queries, smi)
    no_jax("read-write builder phase")
    emb_launches = embeddings_path(torch, g, smi)
    no_jax("embeddings path")
    tiered_launches = tiered_path(torch, g, vecs, queries, gt, smi)
    no_jax("tiered IVF path")
    sharded_launches = sharded_path(torch, g, vecs, queries, gt, smi)
    no_jax("sharded path")
    dp_launches = dp_build_path(torch, g, vecs, queries, gt, main_recalls, main_build_s, flat_recalls, smi)
    no_jax("data-parallel build")
    hnsw_profile(torch, g, queries, smi)
    no_jax("HNSW profile")

    def record(name, source, replaces, n_launches, r):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n_launches,
            "max_abs_err": r["max_abs_err"], "ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r["device_ms"], "eager_ms": r["eager_ms"], "plain_eager_ms": r["plain_eager_ms"],
            **({"baseline_device_ms": r["baseline_device_ms"]} if "baseline_device_ms" in r else {}),
            **({"baseline_with_fills": True} if name == "ivf_score_topk" and "baseline_device_ms" in r else {}),
            **({f"path_keys_{key}": path_times[name][key] for key in ("device_ms", "baseline_device_ms", "bound_ms",
                                                                    "distinct_blocks") if key in path_times[name]}
               if name in path_times else {}),
        }

    nbr_src = "granne_tpu_torch/csrc/nbr_score.cu"
    kernels = [
        {**record("gather_score_flat", nbr_src, "granne_tpu/ops/pallas/nbr_score.py:342", launches, rec),
         "int8_path_launches": int8_launches, "reorder_path_launches": reorder_launches,
         "embeddings_path_launches": emb_launches["gather_score_flat"], "dp_build_path_launches": dp_launches,
         **{key: rec[key] for key in ("int8_unit_lanes_max_abs_err", "int8_code_lanes_max_scaled_err")}},
        {**record("gather_score", nbr_src, "granne_tpu/ops/pallas/nbr_score.py:130", k2_launches, k2_rec),
         "embeddings_path_launches": emb_launches["gather_score"]},
    ]
    for name, line in (("ivf_score_slots", 59), ("ivf_score_slots_grouped", 136), ("ivf_score_topk", 227)):
        kernels.append({
            **record(name, "granne_tpu_torch/csrc/ivf_score.cu", f"granne_tpu/ops/pallas/ivf_score.py:{line}",
                     ivf_launches[name], ivf_recs[name]),
            **({"sharded_path_launches": sharded_launches[name]} if name in sharded_launches else {}),
        })
    kernels.append({
        **record("ivf_score_pairs", "granne_tpu_torch/csrc/ivf_score.cu", None, ivf_launches["ivf_score_pairs"],
                 ivf_recs["ivf_score_pairs"]),
        "tiered_path_launches": tiered_launches, "sharded_path_launches": sharded_launches["ivf_score_pairs"],
        "cell_shapes": ivf_recs["ivf_score_pairs"]["cell_shapes"],
    })
    probe = topk_recs["probe"]
    kernels.append({
        "name": "row_top_k", "route": "cuda", "source": "granne_tpu_torch/csrc/row_topk.cu",
        "replaces": None, "launches": ivf_launches["row_top_k"], "max_abs_err": 0.0,
        **{key: probe[key] for key in ("device_ms", "eager_ms", "plain_ms", "plain_eager_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape")},
        "ms": probe["device_ms"], "merge_shape": topk_recs["merge"],
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
