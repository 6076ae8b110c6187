"""Host-memory tiering of IVF blocks (port of the one-device part of
``granne_tpu/parallel/tiering.py``: ``TieredIvf``).

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

from ..index import io as gio
from ..index.ivf import _DTYPES, _FILE_DTYPES, IVF_MAGIC, IvfIndex, _probe, search_probed, slot_count
from ..ops import distance as D

GROUP_CAP, SLOT_GROUP = 32, 8  # IvfIndex.search_batch's slot shape: 32 queries a slot, 8 slots a K4 block


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
    def load(cls, path: str, device="cuda") -> "TieredIvf":
        """Serve an ``IvfIndex.save`` file (either package's): the blocks,
        ids and scales stay memory-mapped, only the centroids are read and
        moved to ``device``."""
        with open(path, "rb") as f:
            meta = gio._read_metadata(f.read(gio.METADATA_LEN), IVF_MAGIC)
        k, L, d = meta["k_phys"], meta["cluster_cap"], meta["dim"]
        off = gio.METADATA_LEN

        def region(dtype, shape):
            nonlocal off
            arr = np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape)
            off += arr.nbytes
            return arr

        cent = np.array(region("<f4", (k, d)))
        blocks = region(_FILE_DTYPES[meta["dtype"]], (k, L, d))
        ids = region("<i4", (k, L))
        scales = region("<f4", (k, L)) if meta["has_scales"] else np.ones((k, L), np.float32)
        return cls(
            centroids=torch.as_tensor(cent, device=device), host_blocks=blocks, host_block_ids=ids,
            host_block_scales=scales, n_total=meta["n_total"], block_dtype=_DTYPES[meta["dtype"]],
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
        (q, blocks, ids, scales, inv), done = prepared
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in (q, blocks, ids, scales, inv):
                t.record_stream(current)
        B, nprobe = inv.shape
        out = search_probed(
            inv, blocks, ids, scales, q, k_out=num_neighbors, group_cap=GROUP_CAP,
            num_slots=slot_count(blocks.shape[0], B, nprobe, GROUP_CAP), slot_group=SLOT_GROUP,
        )
        return tuple(x.cpu().numpy() for x in out)

    def _streams(self):
        """The prefetch stream (after the caller's pending work) and two
        staging slots on the card; Nones on the CPU."""
        if self.device.type != "cuda":
            return None, [None, None]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        return stream, [_Staging(), _Staging()]

    # -- search ----------------------------------------------------------------

    def search_batches(self, query_batches, num_neighbors: int = 10, *, nprobe: int = 16):
        """Yield (ids int32[B, k], dists f32[B, k]) numpy results batch by
        batch, batch k+1's probe, gather and copy running on a worker
        thread while batch k is scored."""
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
                yield self._score(prepared, num_neighbors)

    def search_batches_sequential(self, query_batches, num_neighbors: int = 10, *, nprobe: int = 16):
        """``search_batches`` without the overlap: each batch prepared, then scored."""
        stream, slots = self._streams()
        for batch in query_batches:
            yield self._score(self._prepare(batch, nprobe, slots[0], stream), num_neighbors)

    def search_batch(self, queries, num_neighbors: int = 10, *, nprobe: int = 16):
        """One batch: (ids int32[B, k], dists f32[B, k]) numpy arrays."""
        return next(iter(self.search_batches([queries], num_neighbors, nprobe=nprobe)))
