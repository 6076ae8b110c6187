"""Host-memory tiering of IVF blocks (port of ``granne_tpu/parallel/tiering.py``:
``TieredIvf`` on one device, ``TieredShardedIvf`` over a group).

The centroids live on the device; the cluster blocks, their ids and their
scales stay in host memory (a memory map of the index file after
``load``).  For each query batch the probe runs on the device, the host
gathers the probed blocks once each (``np.unique``), and the copy to the
device goes from pinned staging memory.  The fetched ``[U, L, d]`` blocks
are scored by the grouped slot route of ``index.ivf`` (K4 on the card, its
plain version on the CPU) with each query's probes renumbered into the
fetched axis; the final top-k runs over each query's ``nprobe * L``
candidates in probe order, ties to the lower column, as the JAX package's
``lax.top_k``.  (The JAX package gathers ``[B, nprobe, L, d]`` per query
inside one fusion; materialised in torch that gather is ~0.84 GB a batch
of 1,024 at nprobe 16, L 256, d 100 in bf16.)

``search_batches`` runs a two-deep pipeline: a worker thread probes,
gathers and copies batch k+1 on its own CUDA stream while the caller's
stream scores batch k.  The scoring stream waits on an event recorded
after the copies, the fetched tensors are ``record_stream``-ed onto it,
and each of the two pinned staging slots is refilled only after its last
copy has completed.  ``search_batches_sequential`` does the same work
without the overlap; both give the same results.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..index.ivf import _DTYPES, IvfIndex, _probe, file_rows, read_metadata, search_probed, slot_count
from ..ops import distance as D
from .mesh import Group, all_gather_topk
from .sharded_ivf import built_on_rank0, shard_rows

GROUP_CAP, SLOT_GROUP = 32, 8  # IvfIndex.search_batch's slot shape: 32 queries a slot, 8 slots a K4 block


def _numpy(tensors) -> tuple:
    return tuple(t.cpu().numpy() for t in tensors)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as its int16 bit patterns."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()


class _Staging:
    """Pinned host buffers for one batch's fetch: blocks, ids, scales, and
    the event recorded after their copies to the device."""

    def __init__(self):
        self.bufs = None
        self.event = None

    def take(self, shapes_dtypes, rows: int) -> list[torch.Tensor]:
        """The buffers with room for ``rows`` blocks, once no copy from them
        is in flight (grown to the next power of two of blocks if short)."""
        if self.event is not None:
            self.event.synchronize()
        if self.bufs is None or self.bufs[0].shape[0] < rows:
            cap = 1 << max(0, rows - 1).bit_length()
            self.bufs = [torch.empty((cap, *shape), dtype=dt, pin_memory=True) for shape, dt in shapes_dtypes]
        return [b[:rows] for b in self.bufs]


@dataclass(frozen=True)
class TieredIvf:
    """An IVF index whose blocks stay in host memory; the centroids live on
    the device that searches."""

    centroids: torch.Tensor  # f32[k, d] on the search device
    host_blocks: np.ndarray  # [k, L, d]: bf16 as int16 bits, f32 or int8; host memory or a memory map
    host_block_ids: np.ndarray  # int32[k, L], -1 padding
    host_block_scales: np.ndarray  # f32[k, L]
    n_total: int
    block_dtype: torch.dtype = torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    @classmethod
    def from_ivf(cls, index: IvfIndex, device="cuda") -> "TieredIvf":
        """Host copies of ``index``'s blocks (wherever it lives), its
        centroids on ``device``."""
        return cls(
            centroids=index.centroids.to(device=device, dtype=torch.float32),
            host_blocks=_host(index.blocks),
            host_block_ids=_host(index.block_ids),
            host_block_scales=_host(index.block_scales),
            n_total=index.n_total,
            block_dtype=index.blocks.dtype,
        )

    @classmethod
    def build(cls, raw_vectors, device="cuda", **kw) -> "TieredIvf":
        """``IvfIndex.build`` on ``device``, then its blocks moved to host memory."""
        return cls.from_ivf(IvfIndex.build(raw_vectors, device=device, **kw), device=device)

    @classmethod
    def load(cls, path: str, device="cuda", rows: tuple[int, int] | None = None) -> "TieredIvf":
        """Serve an ``IvfIndex.save`` file (either package's): the blocks,
        ids and scales stay memory-mapped, only the centroids are read and
        moved to ``device``.  ``rows=(lo, hi)`` serves block rows [lo, hi)."""
        meta, (cent, blocks, ids, *scales) = file_rows(path, rows)
        return cls(
            centroids=torch.as_tensor(np.array(cent), device=device), host_blocks=blocks, host_block_ids=ids,
            host_block_scales=scales[0] if scales else np.ones(ids.shape, np.float32), n_total=meta["n_total"],
            block_dtype=_DTYPES[meta["dtype"]],
        )

    # -- one batch's fetch ---------------------------------------------------

    def _fetch(self, probes: np.ndarray, staging: _Staging | None):
        """The unique probed blocks (with ids and scales) on the device, and
        ``probes`` renumbered into them.  On the card the host gathers into
        ``staging`` and the copies run on the current stream."""
        uniq, inv = np.unique(probes, return_inverse=True)
        parts = (self.host_blocks, self.host_block_ids, self.host_block_scales)
        if staging is None:
            out = [torch.from_numpy(np.take(a, uniq, axis=0)) for a in parts]
        else:
            dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in parts]
            bufs = staging.take([(a.shape[1:], dt) for a, dt in zip(parts, dtypes)], len(uniq))
            for a, b in zip(parts, bufs):
                np.take(a, uniq, axis=0, out=b.numpy(), mode="clip")
            out = [b.to(self.device, non_blocking=True) for b in bufs]
        if self.block_dtype == torch.bfloat16:
            out[0] = out[0].view(torch.bfloat16)
        inv = torch.as_tensor(inv.reshape(probes.shape).astype(np.int64), device=self.device)
        return (*out, inv)

    def _prepare(self, batch, nprobe, staging: _Staging | None = None, stream=None):
        """Probe on the device, gather on the host, copy to the device: one
        batch's inputs (q, blocks, ids, scales, probes into blocks), and
        the event the scorer waits on (None on the CPU).  On the card all
        of it runs on ``stream``."""
        with torch.cuda.stream(stream):  # a no-op for None
            q = D.normalize(D.as_f32(batch, self.device))
            probes = _probe(q, self.centroids, nprobe).cpu().numpy()
            fetched = self._fetch(probes, staging)
            done = None
            if stream is not None:
                done = staging.event = torch.cuda.Event()
                done.record(stream)
        return (q, *fetched), done

    def _score(self, prepared, num_neighbors):
        """One prepared batch scored on the device: (ids, dists) tensors."""
        (q, blocks, ids, scales, inv), done = prepared
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in (q, blocks, ids, scales, inv):
                t.record_stream(current)
        B, nprobe = inv.shape
        return search_probed(
            inv, blocks, ids, scales, q, k_out=num_neighbors, group_cap=GROUP_CAP,
            num_slots=slot_count(blocks.shape[0], B, nprobe, GROUP_CAP), slot_group=SLOT_GROUP,
        )

    def _streams(self):
        """The prefetch stream (after the caller's pending work) and two
        staging slots on the card; Nones on the CPU."""
        if self.device.type != "cuda":
            return None, [None, None]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        return stream, [_Staging(), _Staging()]

    # -- search ----------------------------------------------------------------

    def prepared_batches(self, query_batches, nprobe: int):
        """Yield each batch prepared for ``_score``, batch k+1's probe,
        gather and copy running on a worker thread while the caller scores
        batch k."""
        stream, slots = self._streams()
        it = iter(query_batches)
        first = next(it, None)
        if first is None:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._prepare, first, nprobe, slots[0], stream)
            i = 0
            while fut is not None:
                prepared = fut.result()
                nxt = next(it, None)
                i += 1
                fut = None if nxt is None else ex.submit(self._prepare, nxt, nprobe, slots[i % 2], stream)
                yield prepared

    def search_batches(self, query_batches, num_neighbors: int = 10, *, nprobe: int = 16):
        """Yield (ids int32[B, k], dists f32[B, k]) numpy results batch by
        batch, through the two-deep pipeline of ``prepared_batches``."""
        for prepared in self.prepared_batches(query_batches, nprobe):
            yield _numpy(self._score(prepared, num_neighbors))

    def search_batches_sequential(self, query_batches, num_neighbors: int = 10, *, nprobe: int = 16):
        """``search_batches`` without the overlap: each batch prepared, then scored."""
        stream, slots = self._streams()
        for batch in query_batches:
            yield _numpy(self._score(self._prepare(batch, nprobe, slots[0], stream), num_neighbors))

    def search_batch(self, queries, num_neighbors: int = 10, *, nprobe: int = 16):
        """One batch: (ids int32[B, k], dists f32[B, k]) numpy arrays."""
        return next(iter(self.search_batches([queries], num_neighbors, nprobe=nprobe)))


@dataclass(frozen=True)
class TieredShardedIvf:
    """Host-tiered blocks split over a group (port of the JAX package's
    ``TieredShardedIvf``): each rank serves its own block rows as a
    ``TieredIvf`` (blocks memory-mapped on its host, centroids on its
    device) and the per-rank top-k merge through ``all_gather_topk``.

    Rows are split as ``ShardedIvf`` splits them (``k_local`` a rank after
    padding to a multiple of the world size) and ``nprobe`` counts per
    rank.  A rank probes its local top-``nprobe`` blocks, the set JAX's
    per-shard ``argpartition`` picks; the padding blocks, which only the
    last ranks have, are not held at all: they carry no ids, so a rank
    probes at most its real blocks and the answer is the same.  Fetched
    blocks are scored through ``TieredIvf``'s grouped route (K4 on the
    card); JAX contracts them in a bf16 einsum, so the two agree within the
    IVF tolerance, not in bits.
    """

    group: Group
    local: TieredIvf  # this rank's real rows
    n_total: int

    @classmethod
    def from_ivf(cls, index: IvfIndex, group: Group) -> "TieredShardedIvf":
        """Host copies of this rank's rows of ``index``; their centroids on the rank's device."""
        _, lo, hi = shard_rows(index.k, group)
        return cls(group, TieredIvf.from_ivf(index.rows(lo, hi), device=group.device), index.n_total)

    @classmethod
    def build(cls, raw_vectors, group: Group, **kw) -> "TieredShardedIvf":
        """``IvfIndex.build(raw_vectors, **kw)`` once (rank 0), each rank's rows moved to its host."""
        return cls.from_ivf(built_on_rank0(raw_vectors, group, **kw), group)

    @classmethod
    def load(cls, path: str, group: Group) -> "TieredShardedIvf":
        """Serve an ``IvfIndex.save`` file: each rank memory-maps only its own block rows."""
        _, lo, hi = shard_rows(read_metadata(path)["k_phys"], group)
        local = TieredIvf.load(path, device=group.device, rows=(lo, hi))
        return cls(group, local, local.n_total)

    def search_batches(self, query_batches, num_neighbors: int = 10, *, nprobe: int = 16):
        """Yield (ids int32[B, k] global, dists f32[B, k]) numpy results,
        the same on every rank: this rank's pipelined tiered search of each
        batch, then ``all_gather_topk``.  Every rank takes the same batches."""
        nprobe = min(nprobe, self.local.k)
        for prepared in self.local.prepared_batches(query_batches, nprobe):
            ids, d = self.local._score(prepared, num_neighbors)
            yield _numpy(all_gather_topk(ids, d, num_neighbors, self.group))

    def search_batch(self, queries, num_neighbors: int = 10, *, nprobe: int = 16):
        """One batch: (ids int32[B, k], dists f32[B, k]) numpy arrays."""
        return next(iter(self.search_batches([queries], num_neighbors, nprobe=nprobe)))
