"""Multi-device IVF serving: the block axis split over ranks (port of
``granne_tpu/parallel/sharded_ivf.py``).

An ``IvfIndex``'s physical blocks are padded to a multiple of the world
size with empty blocks (ids -1, zero centroids, scales 1, masked from the
probe by ``centroid_valid``), and rank ``r`` keeps rows
``[r·k_local, (r+1)·k_local)`` on its device: only those, whether it
shards a built index, loads a file (a row range of the memory map) or
builds one (rank 0 builds and broadcasts).  Queries are replicated; each
rank runs the grouped search of ``index/ivf.py`` over its own blocks (K4 on
the card, K5 with ``fused_topk=True``), and ``mesh.all_gather_topk`` merges
the per-rank top-k.  Block ids are global element ids, so no offset is
added.

``nprobe`` counts per rank, as in the JAX package: a globally top block is
top within its own rank, so the union probed at equal ``nprobe`` holds the
single-device probe set, and recall at equal ``nprobe`` is at least the
single-device search's, at up to S times the scoring work.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..index.ivf import IvfIndex, _ivf_search_grouped, read_metadata, slot_count
from ..ops import distance as D
from .mesh import Group, all_gather_topk, broadcast_tensors


def shard_rows(k_phys: int, group: Group) -> tuple[int, int, int]:
    """(k_local, lo, hi): each rank's row count after padding ``k_phys`` to
    a multiple of the world size, and this rank's real rows [lo, hi)."""
    k_local = -(-k_phys // group.world)
    lo = min(group.rank * k_local, k_phys)
    return k_local, lo, min(lo + k_local, k_phys)


def built_on_rank0(raw_vectors, group: Group, **kw) -> IvfIndex:
    """``IvfIndex.build`` on rank 0's device, then the same index on every
    rank (k-means on the card is not bit-reproducible, so the ranks do not
    each build one)."""
    names = ("centroids", "blocks", "block_ids", "block_scales")
    parts = None
    if group.rank == 0:
        index = IvfIndex.build(raw_vectors, device=group.device, **kw)
        parts = [getattr(index, name) for name in names]
    return IvfIndex(**dict(zip(names, broadcast_tensors(group, parts))), n_total=len(raw_vectors))


@dataclass(frozen=True)
class ShardedIvf:
    """This rank's rows of an IVF index whose block axis is split over a group."""

    group: Group
    centroids: torch.Tensor  # f32[k_local, d] on group.device
    blocks: torch.Tensor  # bf16|f32|i8[k_local, L, d]
    block_ids: torch.Tensor  # int32[k_local, L], global element ids, -1 padding
    block_scales: torch.Tensor  # f32[k_local, L]
    centroid_valid: torch.Tensor  # bool[k_local]: False on padding blocks
    n_total: int

    @property
    def k_local(self) -> int:
        return int(self.blocks.shape[0])

    @classmethod
    def _from_rows(cls, part: IvfIndex, k_local: int, group: Group) -> "ShardedIvf":
        """This rank's real rows ``part`` on its device, padded to ``k_local``."""
        dev, real = group.device, part.k

        def padded(t, fill):
            t = t.to(dev)
            return torch.cat([t, t.new_full((k_local - real, *t.shape[1:]), fill)])

        return cls(
            group=group,
            centroids=padded(part.centroids.to(torch.float32), 0.0),
            blocks=padded(part.blocks, 0),
            block_ids=padded(part.block_ids, -1),
            block_scales=padded(part.block_scales, 1.0),
            centroid_valid=torch.arange(k_local, device=dev) < real,
            n_total=part.n_total,
        )

    @classmethod
    def from_ivf(cls, index: IvfIndex, group: Group) -> "ShardedIvf":
        """This rank's rows of a built index (on any device)."""
        k_local, lo, hi = shard_rows(index.k, group)
        return cls._from_rows(index.rows(lo, hi), k_local, group)

    @classmethod
    def build(cls, raw_vectors, group: Group, **kw) -> "ShardedIvf":
        """``IvfIndex.build(raw_vectors, **kw)`` once (rank 0), sharded."""
        return cls.from_ivf(built_on_rank0(raw_vectors, group, **kw), group)

    @classmethod
    def load(cls, path: str, group: Group) -> "ShardedIvf":
        """An ``IvfIndex.save`` file (either package's): each rank reads only
        its own block rows."""
        k_local, lo, hi = shard_rows(read_metadata(path)["k_phys"], group)
        return cls._from_rows(IvfIndex.load(path, device=group.device, rows=(lo, hi)), k_local, group)

    def search_batch(self, queries, num_neighbors: int = 10, *, nprobe: int = 16, group_cap: int = 32,
                     fused_topk: bool = False, slot_group: int = 8):
        """Replicated queries -> this rank's grouped IVF search (K4, or K5
        with ``fused_topk``) -> ``all_gather_topk``.  Returns (ids
        int32[B, k] global, dists f32[B, k]) on the rank's device, the same
        on every rank."""
        q = D.normalize(D.as_f32(queries, self.group.device))
        nprobe = min(nprobe, self.k_local)
        ids, d = _ivf_search_grouped(
            self.centroids, self.blocks, self.block_ids, self.block_scales, q, nprobe=nprobe,
            k_out=num_neighbors, group_cap=group_cap, num_slots=slot_count(self.k_local, q.shape[0], nprobe, group_cap),
            use_pallas_topk=fused_topk, slot_group=slot_group, centroid_valid=self.centroid_valid,
        )
        return all_gather_topk(ids, d, num_neighbors, self.group)
