"""Multi-device HNSW serving: element-sharded sub-indexes (port of
``granne_tpu/parallel/sharded.py``).

Elements are split into S contiguous shards (bounds
``np.linspace(0, n, S + 1)``); rank ``s`` holds shard ``s``'s elements,
padded to the largest shard's size by repeating its last row (the padding
rows are not indexed), and the HNSW graph of that shard alone, which it
builds itself: the S ranks build at once, where the JAX package builds the
shards one after another.  A query batch is replicated; each rank searches
its own sub-index, turns local ids into global ones (``local + offset``)
and ``mesh.all_gather_topk`` merges the per-rank top-k.

A rank keeps its own layer stack at its own depth.  (The JAX package
stacks a shallower shard up to the deepest shard's depth by repeating its
bottom layer, which ``shard_map``'s equal shapes need; the repeated layers
make its descent also walk the bottom layer greedily, so the two packages'
searches over shards of different depth differ slightly.)

Files: a directory of ``manifest.json`` (``num_shards``, ``n_total``,
``shard_offsets``) and, per shard, ``shard{s}.index`` and
``shard{s}.elements`` (the padding rows included): the JAX package's
layout, read and written by either package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..index import io as gio
from ..index.builder import BuildConfig, build_layers
from ..index.granne import Granne
from .mesh import Group, all_gather_topk


def shard_bounds(n: int, world: int) -> np.ndarray:
    """int64[world + 1] contiguous shard bounds over ``n`` elements."""
    return np.linspace(0, n, world + 1).astype(np.int64)


@dataclass(frozen=True)
class ShardedGranne:
    """This rank's sub-index of an element-sharded HNSW index."""

    group: Group
    index: Granne  # this shard's graph and elements (padded to the shard size)
    shard_offsets: tuple[int, ...]  # each shard's first global id
    n_total: int

    @property
    def offset(self) -> int:
        return self.shard_offsets[self.group.rank]

    @classmethod
    def build(cls, element_cls, raw_vectors, config: BuildConfig, group: Group) -> "ShardedGranne":
        """Build this rank's shard of ``raw_vectors`` [n, d] (every rank
        passes the whole array, or a memory map of it) with
        ``element_cls.from_raw`` on the rank's device."""
        n = len(raw_vectors)
        if n < group.world:
            raise ValueError(f"{n} elements cannot fill {group.world} shards")
        bounds = shard_bounds(n, group.world)
        lo, hi = int(bounds[group.rank]), int(bounds[group.rank + 1])
        chunk = np.asarray(raw_vectors[lo:hi], np.float32)
        shard_n = int(np.max(np.diff(bounds)))
        if len(chunk) < shard_n:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], shard_n - len(chunk), axis=0)])
        elements = element_cls.from_raw(chunk, device=group.device)
        layers = build_layers(elements, config, num_elements=hi - lo)
        return cls(group, Granne(layers=layers, elements=elements), tuple(int(b) for b in bounds[:-1]), n)

    def save(self, directory: str, compressed: bool = True) -> None:
        """Write this rank's ``shard{rank}.index`` / ``.elements``; rank 0
        writes ``manifest.json`` once every rank has written its pair."""
        os.makedirs(directory, exist_ok=True)
        rank = self.group.rank
        gio.save_index(self.index.layers, os.path.join(directory, f"shard{rank}.index"), compressed=compressed)
        gio.save_elements(self.index.elements, os.path.join(directory, f"shard{rank}.elements"))
        self.group.barrier()
        if rank == 0:
            manifest = {"num_shards": self.group.world, "n_total": self.n_total,
                        "shard_offsets": list(self.shard_offsets)}
            with open(os.path.join(directory, "manifest.json"), "w") as f:
                json.dump(manifest, f)
        self.group.barrier()

    @classmethod
    def load(cls, directory: str, group: Group) -> "ShardedGranne":
        """Load this rank's shard of a saved directory (either package's);
        the manifest's shard count must equal the world size."""
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["num_shards"] != group.world:
            raise ValueError(f"manifest has {manifest['num_shards']} shards, the group {group.world} ranks")
        rank, dev = group.rank, group.device
        index = Granne(
            layers=gio.load_index(os.path.join(directory, f"shard{rank}.index"), device=dev),
            elements=gio.load_elements(os.path.join(directory, f"shard{rank}.elements"), device=dev),
        )
        return cls(group, index, tuple(int(o) for o in manifest["shard_offsets"]), int(manifest["n_total"]))

    def search_batch(self, queries, max_search: int = 200, num_neighbors: int = 20, expand: int = 1):
        """Replicated queries -> this rank's beam search (no neighbor cache,
        as in the JAX package) -> global ids -> ``all_gather_topk``.  Returns
        (ids int32[B, k], dists f32[B, k]) on the rank's device, the same
        on every rank."""
        ids, d = self.index.search_batch(queries, max_search, num_neighbors, expand=expand)
        gids = torch.where(ids >= 0, ids + self.offset, -1)
        return all_gather_topk(gids, d, num_neighbors, self.group)
