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


def dp_build_job(group, vecs, cases, resume_at, recall_rows):
    """The data-parallel build (``build_layers(..., group=group)``) of ``vecs``
    at each config of ``cases`` ({name: BuildConfig keywords}), in one rank
    process one after the other.  Also: the first case resumed from a build
    of ``resume_at`` elements ("resumed", with the partial build's counts),
    the first case's self-recall@1 over ``recall_rows`` rows, the refusal of
    elements of another length on every rank but rank 0, and, on rank 0
    after every collective, the one-device builds of the first case, whole
    and resumed."""
    from granne_tpu_torch import Granne, LayerStack, build_layers

    elements = AngularVectors.from_raw(vecs, device=group.device)
    out = {"modules": foreign_modules(), "layers": {}}
    for name, cfg in cases.items():
        out["layers"][name] = build_layers(elements, BuildConfig(**cfg), group=group).as_numpy()
    first = BuildConfig(**next(iter(cases.values())))
    partial = build_layers(elements, first, num_elements=resume_at, group=group)
    out["partial_counts"] = partial.counts
    out["layers"]["resumed"] = build_layers(elements, first, state=partial, group=group).as_numpy()
    built = LayerStack.from_numpy(next(iter(out["layers"].values())), device=group.device)
    ids, _ = Granne(layers=built, elements=elements).search_batch(
        vecs[:recall_rows], max_search=first.max_search, num_neighbors=1)
    out["self_recall"] = float(np.mean(ids[:, 0].cpu().numpy() == np.arange(recall_rows)))
    other = AngularVectors.from_raw(vecs[: len(vecs) - min(group.rank, 1)], device=group.device)
    try:
        build_layers(other, first, group=group)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    if group.rank == 0:
        out["single"] = build_layers(elements, first).as_numpy()
        partial = build_layers(elements, first, num_elements=resume_at)
        out["single_resumed"] = build_layers(elements, first, state=partial).as_numpy()
    return out


def dp_card_build_job(group, vecs, cfg):
    """A data-parallel build of ``vecs`` at ``cfg`` (BuildConfig keywords)
    on the rank's device: its layers and this rank's launches of K1 and K2."""
    from granne_tpu_torch import build_layers
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score, gather_score_flat

    gather_score.launches = gather_score_flat.launches = 0
    elements = AngularVectors.from_raw(vecs, device=group.device)
    layers = build_layers(elements, BuildConfig(**cfg), group=group).as_numpy()
    return {"layers": layers, "k1": gather_score_flat.launches, "k2": gather_score.launches}
