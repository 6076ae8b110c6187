"""The port's multi-device dry run: the steps of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py``) over a group of spawned ranks.

1. The data-parallel build (``build_layers(..., group=...)``, with the
   reinsert pass): a stack of two layers or more with a non-empty bottom
   layer, the single-device build's layer counts, and edge Jaccard > 0.95
   against it over all layers (``dp_build_jaccard``).

Then each engine serves one small index over ``world`` ranks and must
reach the recall of the single-device HNSW search on the same data
(self-recall@1 of the first 32 elements), as the JAX dry run holds it; the
data-parallel build's index (``dp_build``) is held to the same bar:

2. ``ShardedGranne.build`` (an HNSW sub-index a rank), search, merge;
3. ``ShardedIvf.build`` (IVF blocks split over the ranks), search, merge;
4. ``TieredShardedIvf.build`` (those blocks kept on each rank's host).

    python -c "from granne_tpu_torch.parallel.dryrun import dryrun_multichip; print(dryrun_multichip(4, 'gloo', 'cpu'))"
    python -c "from granne_tpu_torch.parallel.dryrun import dryrun_multichip; print(dryrun_multichip(4))"  # 4 GPUs, NCCL
"""

from __future__ import annotations

import numpy as np

from .mesh import Group, run_ranks

QUERIES, K, EF, NPROBE = 32, 5, 16, 2
JACCARD_BAR = 0.95


def _make_data(n: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _self_recall(ids) -> float:
    ids = ids.cpu().numpy() if hasattr(ids, "cpu") else np.asarray(ids)
    if ids.shape != (QUERIES, K):
        raise RuntimeError(f"a search returned shape {ids.shape}, not {(QUERIES, K)}")
    return float(np.mean(ids[:, 0] == np.arange(QUERIES)))


def layer_jaccard(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """(edges in both, edges in either) of two layers' rows (int32 [n, M],
    -1 padded, distinct ids a row); a row empty in both counts as (1, 1)."""
    va, vb = a >= 0, b >= 0
    inter = ((a[:, :, None] == b[:, None, :]) & va[:, :, None] & vb[:, None, :]).sum(axis=(1, 2))
    union = va.sum(axis=1) + vb.sum(axis=1) - inter
    empty = union == 0
    return int(np.where(empty, 1, inter).sum()), int(np.where(empty, 1, union).sum())


def edge_jaccard(a, b) -> float:
    """Edge-set Jaccard of two layer lists (numpy, trimmed to their counts),
    rows pooled over the layers."""
    per = [layer_jaccard(x, y) for x, y in zip(a, b)]
    return sum(p for p, _ in per) / sum(u for _, u in per)


def _dryrun_rank(group: Group) -> dict:
    """One rank of the dry run: step 1, the single-device bar, then steps 2-4."""
    from ..elements.angular import AngularVectors
    from ..index.builder import BuildConfig, build_layers
    from ..index.granne import Granne
    from .sharded import ShardedGranne
    from .sharded_ivf import ShardedIvf
    from .tiering import TieredShardedIvf

    S = group.world
    vecs = _make_data(64 * S, 16)
    cfg = BuildConfig(num_neighbors=8, max_search=16, wave_size=8 * S)
    q = vecs[:QUERIES]
    elements = AngularVectors.from_raw(vecs, device=group.device)
    stack = build_layers(elements, cfg, group=group)
    single = Granne(layers=build_layers(elements, cfg), elements=elements)
    if len(stack) < 2 or not bool((stack.layers[-1][: len(vecs)] >= 0).any()):
        raise RuntimeError(f"the data-parallel build gave {len(stack)} layers or an empty bottom layer")
    if stack.counts != single.layers.counts:
        raise RuntimeError(f"the data-parallel layer schedule {stack.counts} differs from {single.layers.counts}")
    jaccard = edge_jaccard(stack.as_numpy(), single.layers.as_numpy())
    if jaccard <= JACCARD_BAR:
        raise RuntimeError(f"the data-parallel build's edge Jaccard {jaccard} against one device <= {JACCARD_BAR}")
    recalls = {"single_device": _self_recall(single.search_batch(q, max_search=EF, num_neighbors=K)[0])}
    dp = Granne(layers=stack, elements=elements)
    recalls["dp_build"] = _self_recall(dp.search_batch(q, max_search=EF, num_neighbors=K)[0])

    sharded = ShardedGranne.build(AngularVectors, vecs, cfg, group)
    recalls["sharded_granne"] = _self_recall(sharded.search_batch(q, max_search=EF, num_neighbors=K)[0])
    ivf_kw = dict(n_clusters=max(8, S), kmeans_iters=4)
    ivf = ShardedIvf.build(vecs, group, **ivf_kw)
    recalls["sharded_ivf"] = _self_recall(ivf.search_batch(q, K, nprobe=NPROBE)[0])
    tiered = TieredShardedIvf.build(vecs, group, **ivf_kw)
    recalls["tiered_sharded_ivf"] = _self_recall(tiered.search_batch(q, K, nprobe=NPROBE)[0])

    for engine, recall in recalls.items():
        if recall < recalls["single_device"]:
            raise RuntimeError(f"{engine} recall {recall} below the single-device {recalls['single_device']}")
    return {**recalls, "dp_build_jaccard": jaccard}


def dryrun_multichip(world: int = 4, backend: str | None = None, device="cuda", timeout: float = 600.0) -> dict:
    """Run steps 1-4 over ``world`` spawned ranks on ``device``.  ``backend``
    is NCCL or gloo, by default NCCL on the card and gloo on the CPU.  NCCL
    puts rank r on ``cuda:r`` and needs ``world`` GPUs (else ``ValueError``);
    gloo runs every rank on one card (``"cuda"``: ``cuda:0``), as
    ``dryrun_multichip(4, "gloo")`` does on a host with one.  Raises if step
    1 misses its bars, any engine's self-recall@1 falls below the
    single-device search's, or a rank fails; returns rank 0's recalls
    (``single_device``, ``dp_build``, ``sharded_granne``, ``sharded_ivf``,
    ``tiered_sharded_ivf``) and ``dp_build_jaccard``, which every rank
    shares."""
    return run_ranks(_dryrun_rank, world, backend=backend, device=device, timeout=timeout)[0]
