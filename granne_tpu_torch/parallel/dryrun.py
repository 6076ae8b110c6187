"""The port's multi-device dry run: the serving steps (2-4) of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``) over a group of
spawned ranks.

Each engine serves one small index over ``world`` ranks and must reach the
recall of the single-device HNSW search on the same data (self-recall@1 of
the first 32 elements), as the JAX dry run holds it:

2. ``ShardedGranne.build`` (an HNSW sub-index a rank), search, merge;
3. ``ShardedIvf.build`` (IVF blocks split over the ranks), search, merge;
4. ``TieredShardedIvf.build`` (those blocks kept on each rank's host).

Step 1 of the JAX dry run, the data-parallel build (``parallel/dp_build.py``),
has no port yet and is not run here.

    python -c "from granne_tpu_torch.parallel.dryrun import dryrun_multichip; print(dryrun_multichip(4, 'gloo', 'cpu'))"
    python -c "from granne_tpu_torch.parallel.dryrun import dryrun_multichip; print(dryrun_multichip(4))"  # 4 GPUs, NCCL
"""

from __future__ import annotations

import numpy as np

from .mesh import Group, run_ranks

QUERIES, K, EF, NPROBE = 32, 5, 16, 2


def _make_data(n: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _self_recall(ids) -> float:
    ids = ids.cpu().numpy() if hasattr(ids, "cpu") else np.asarray(ids)
    if ids.shape != (QUERIES, K):
        raise RuntimeError(f"a search returned shape {ids.shape}, not {(QUERIES, K)}")
    return float(np.mean(ids[:, 0] == np.arange(QUERIES)))


def _dryrun_rank(group: Group) -> dict:
    """One rank of the dry run: the single-device bar, then steps 2-4."""
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
    single = Granne(layers=build_layers(elements, cfg), elements=elements)
    recalls = {"single_device": _self_recall(single.search_batch(q, max_search=EF, num_neighbors=K)[0])}

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
    return recalls


def dryrun_multichip(world: int = 4, backend: str | None = None, device="cuda", timeout: float = 600.0) -> dict:
    """Run steps 2-4 over ``world`` spawned ranks on ``device``.  ``backend``
    is NCCL or gloo, by default NCCL on the card and gloo on the CPU.  NCCL
    puts rank r on ``cuda:r`` and needs ``world`` GPUs (else ``ValueError``);
    gloo runs every rank on one card (``"cuda"``: ``cuda:0``), as
    ``dryrun_multichip(4, "gloo")`` does on a host with one.  Raises if any
    engine's self-recall@1 falls below the single-device search's, or a rank
    fails; returns rank 0's recalls, which every rank shares."""
    return run_ranks(_dryrun_rank, world, backend=backend, device=device, timeout=timeout)[0]
