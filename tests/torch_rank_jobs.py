"""Rank bodies that the port's multi-device tests spawn with
``granne_tpu_torch.parallel.mesh.run_ranks``.

A spawned rank imports the module its function lives in, so these live
here, in a module that imports no jax: the test modules that spawn them do
import jax, and a rank that imported them would carry jax (and its memory
maps) too.  Each body takes its inputs as numpy arrays and file paths and
returns numpy results; every rank returns its own, so the tests also check
that the ranks agree.
"""

import os
import pickle
import sys

import numpy as np
import torch

from granne_tpu_torch import AngularVectors, BuildConfig, IvfIndex, ShardedGranne, ShardedIvf, TieredShardedIvf
from granne_tpu_torch import convert


def once_per_run(tmp_path_factory, name: str, compute):
    """``compute()``'s result, computed by one test process of the run and
    read back by the others.  Under pytest-xdist's ``--dist load`` a
    module's tests land on several workers, and each would run the module's
    fixture (JAX's builds and a spawn of 4 ranks) again; the first pickles
    the result in the run's shared temporary directory under a file lock."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    path = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / f"{name}.pkl"
    with FileLock(f"{path}.lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        with open(path, "wb") as f:
            pickle.dump(value, f)
        return value


def foreign_modules() -> list[str]:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "granne_tpu"))


def _np(out):
    return tuple(t.cpu().numpy() for t in out)


def modules_job(group):
    return foreign_modules()


def sharded_ivf_job(group, cases):
    """``cases``: {name: (path, nprobes, queries)}.  Per case: ``ShardedIvf.load``
    searched at every nprobe (K4's route), the fused route (K5's) at the
    first, ``sharded_ivf_from_numpy`` over the whole file at the first,
    and the rank's own rows (ids, validity)."""
    out = {"modules": foreign_modules()}
    for name, (path, nprobes, queries) in cases.items():
        index = ShardedIvf.load(path, group)
        res = {"k_local": index.k_local, "block_ids": index.block_ids.numpy(),
               "valid": index.centroid_valid.numpy()}
        for nprobe in nprobes:
            res[nprobe] = _np(index.search_batch(queries, 10, nprobe=nprobe))
        res["fused"] = _np(index.search_batch(queries, 10, nprobe=nprobes[0], fused_topk=True))
        full = IvfIndex.load(path, device="cpu")
        blocks = full.blocks
        blocks = blocks.view(torch.int16).numpy().view(np.uint16) if blocks.dtype == torch.bfloat16 else blocks.numpy()
        arrays = [full.centroids.numpy(), blocks, full.block_ids.numpy(), full.block_scales.numpy()]
        carried = convert.sharded_ivf_from_numpy(*arrays, full.n_total, group)
        res["from_numpy"] = _np(carried.search_batch(queries, 10, nprobe=nprobes[0]))
        out[name] = res
    return out


def sharded_granne_job(group, cases, queries, directory):
    """``cases``: {name: (vecs, cfg, jax_dir, jax_layers, jax_elements)},
    the last two per shard.  Per case: the port's own build (its layers,
    a search, saved to ``{directory}/{name}-own`` and reloaded), the JAX
    shards carried across (a search, saved to ``{name}-same``), and JAX's
    saved directory loaded (a search)."""
    out = {"modules": foreign_modules()}
    kw = dict(max_search=20, num_neighbors=5)
    for name, (vecs, cfg, jax_dir, jax_layers, jax_elements) in cases.items():
        own = ShardedGranne.build(AngularVectors, vecs, BuildConfig(**cfg), group)
        res = {"layers": own.index.layers.as_numpy(), "own": _np(own.search_batch(queries[name], **kw))}
        own.save(f"{directory}/{name}-own")
        res["reloaded"] = _np(ShardedGranne.load(f"{directory}/{name}-own", group).search_batch(queries[name], **kw))
        r = group.rank
        same = convert.sharded_granne_from_numpy(jax_layers[r], jax_elements[r], own.offset, len(vecs), group)
        res["same"] = _np(same.search_batch(queries[name], **kw))
        same.save(f"{directory}/{name}-same")
        res["jax_dir"] = _np(ShardedGranne.load(jax_dir, group).search_batch(queries[name], **kw))
        out[name] = res
    return out


def tiered_sharded_job(group, cases, queries):
    """``cases``: {name: (path, nprobe)}.  Per case: ``TieredShardedIvf.load``
    searched one batch, and two batches through ``search_batches``; the
    same index carried across whole and sharded by ``from_ivf``; the rank's
    host blocks' type and rows."""
    out = {"modules": foreign_modules()}
    for name, (path, nprobe) in cases.items():
        q = queries[name]
        t = TieredShardedIvf.load(path, group)
        half = len(q) // 2
        res = {
            "one": t.search_batch(q, 5, nprobe=nprobe),
            "batches": list(t.search_batches([q[:half], q[half:]], 5, nprobe=nprobe)),
            "host_type": type(t.local.host_blocks).__name__,
            "rows": t.local.host_block_ids.shape[0],
            "from_ivf": TieredShardedIvf.from_ivf(IvfIndex.load(path, device="cpu"), group).search_batch(
                q, 5, nprobe=nprobe),
        }
        out[name] = res
    return out


def world_of_one_job(group, path, queries, nprobes):
    """A world of one on the card: ``ShardedIvf.load`` against the resident
    ``IvfIndex.search_batch`` of the same file, ids and distances."""
    sharded = ShardedIvf.load(path, group)
    resident = IvfIndex.load(path, device=group.device)
    return {nprobe: (_np(sharded.search_batch(queries, 10, nprobe=nprobe)),
                     _np(resident.search_batch(queries, 10, nprobe=nprobe))) for nprobe in nprobes}
