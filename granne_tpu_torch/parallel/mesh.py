"""Process groups for multi-device serving (port of ``granne_tpu/parallel/mesh.py``).

The JAX package serves a sharded index from one controller over a 1-D
device ``Mesh`` with ``shard_map`` and ``all_gather``.  PyTorch has no
single-controller mesh: here every rank is a process with one device,
joined by ``torch.distributed``, and each engine keeps only its own rank's
shard.  The three engines (``ShardedIvf``, ``ShardedGranne``,
``TieredShardedIvf``) share this layer:

- ``Group``: a rank's place in the world, its backend and its explicit
  device, made by ``make_group`` from torchrun's environment (or an
  existing default group) or from a ``FileStore``;
- ``all_gather_topk``: the one merge of per-rank top-k candidates;
- ``broadcast_tensors``: rank 0's tensors on every rank (a build made once);
- ``run_ranks``: a launcher that spawns ``world`` ranks on one host, with a
  timeout, for tests, dry runs and ``chip_smoke.py``.

Backends.  NCCL keeps the collectives' tensors on the card and needs one
GPU a rank (the launcher puts rank r on ``cuda:r``).  gloo runs them on host copies: a world of several ranks on one
card (every rank on ``cuda:0``) or on the CPU.  The choice is the backend's,
and ``Group.describe`` names it.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.topk import INF, sort_by_key

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Group:
    """One rank of a process group: its rank, the world size, the backend,
    the rank's device and the ``ProcessGroup``."""

    rank: int
    world: int
    backend: str
    device: torch.device
    pg: object

    @property
    def on_host(self) -> bool:
        """Whether collectives run on host copies (gloo) rather than on the card (NCCL)."""
        return self.backend == "gloo"

    def describe(self) -> str:
        where = "host copies" if self.on_host else f"tensors on {self.device}"
        return f"rank {self.rank} of {self.world}: {self.backend} collectives on {where}, device {self.device}"

    def barrier(self) -> None:
        dist.barrier(group=self.pg)


def _explicit(device) -> torch.device:
    """``"cuda"`` means ``cuda:0``: every rank names its card."""
    device = torch.device(device)
    return torch.device("cuda", 0) if device.type == "cuda" and device.index is None else device


def make_group(device="cuda", *, backend: str | None = None, store_path: str | None = None,
               rank: int | None = None, world: int | None = None) -> Group:
    """This process's ``Group`` on ``device`` (default ``"cuda"``, i.e. ``cuda:0``).

    An initialised default group is taken as it is (its backend must match
    ``backend`` if one is given).  Otherwise one is initialised: from a
    ``FileStore`` at ``store_path`` with ``rank`` and ``world``, or else
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  The default backend is NCCL for a CUDA device and
    gloo for the CPU.
    """
    device = _explicit(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if store_path is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            store = dist.FileStore(store_path, world)
            dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    got = dist.get_backend()
    if backend is not None and got != backend:
        raise ValueError(f"the default process group runs {got}, not {backend}")
    if got == "nccl" and device.type != "cuda":
        raise ValueError("NCCL collectives need a CUDA device")
    group = Group(rank=dist.get_rank(), world=dist.get_world_size(), backend=got, device=device,
                  pg=dist.group.WORLD)
    log.info("%s", group.describe())
    return group


def all_gather_topk(ids: torch.Tensor, dists: torch.Tensor, k: int, group: Group):
    """Merge every rank's candidates into the global top ``k``; the same on every rank.

    ``ids`` int32[B, c] and ``dists`` f32[B, c] (c <= k) are this rank's
    candidates.  An id -1 is moved to +inf first, and a rank with fewer
    than ``k`` columns is padded with (-1, +inf).  The gathered [S, B, k]
    are laid out shard-major per query, [B, S·k] (JAX's
    ``transpose(1, 0, 2).reshape(B, -1)``), and sorted stably on distance,
    so ties go to the lower shard, then the lower position.  On gloo the
    candidates go through the host and the merged [B, k] return to
    ``ids``' device.  Returns (ids int32[B, k], dists f32[B, k]).
    """
    B, c = ids.shape
    d = torch.where(ids >= 0, dists, INF)
    if c < k:
        ids = torch.cat([ids, ids.new_full((B, k - c), -1)], dim=1)
        d = torch.cat([d, d.new_full((B, k - c), INF)], dim=1)
    src_ids, src_d = (ids.cpu(), d.cpu()) if group.on_host else (ids.contiguous(), d.contiguous())
    all_ids = [torch.empty_like(src_ids) for _ in range(group.world)]
    all_d = [torch.empty_like(src_d) for _ in range(group.world)]
    dist.all_gather(all_ids, src_ids, group=group.pg)
    dist.all_gather(all_d, src_d, group=group.pg)
    sd, sids = sort_by_key(torch.stack(all_d, 1).reshape(B, -1), torch.stack(all_ids, 1).reshape(B, -1))
    return sids[:, :k].to(ids.device), sd[:, :k].to(ids.device)


def broadcast_tensors(group: Group, tensors: list[torch.Tensor] | None, src: int = 0) -> list[torch.Tensor]:
    """Rank ``src``'s ``tensors`` (None on the other ranks) on every rank's
    device, bit for bit (each sent as its bytes)."""
    meta = [[(tuple(t.shape), t.dtype) for t in tensors] if group.rank == src else None]
    dist.broadcast_object_list(meta, src=src, group=group.pg)
    wire = "cpu" if group.on_host else group.device
    out = []
    for i, (shape, dtype) in enumerate(meta[0]):
        if group.rank == src:
            buf = tensors[i].contiguous().reshape(-1).view(torch.uint8).to(wire)
        else:
            nbytes = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
            buf = torch.empty(nbytes, dtype=torch.uint8, device=wire)
        if buf.numel():
            dist.broadcast(buf, src=src, group=group.pg)
        out.append(buf.to(group.device).view(dtype).reshape(shape))
    return out


# -- launcher ----------------------------------------------------------------


def _rank_main(job_path, rank, world, backend, device, store_path, results) -> None:
    """A spawned rank: one torch thread, ``fn`` and ``args`` read from
    ``job_path``, a group from the FileStore, ``fn(group, *args)``, the
    group destroyed; the result (or the traceback) goes to the parent."""
    torch.set_num_threads(1)
    # every rank of this launcher runs on one host: the collectives' sockets stay on loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        with open(job_path, "rb") as f:
            fn, args = pickle.load(f)
        group = make_group(device, backend=backend, store_path=store_path, rank=rank, world=world)
        try:
            value = fn(group, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, value))


def rank_devices(world: int, backend: str | None, device, gpus: int | None = None) -> list[torch.device]:
    """Each rank's device for ``run_ranks``.  NCCL refuses two ranks on one
    GPU: with it, ``"cuda"`` puts rank r on ``cuda:r``, and a world larger
    than the host's ``gpus`` (``torch.cuda.device_count()`` by default), or
    one named card for several ranks, is refused.  gloo shares the device:
    every rank on ``device`` (``"cuda"`` means ``cuda:0``)."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend != "nccl" or world == 1:
        return [_explicit(device)] * world
    gpus = torch.cuda.device_count() if gpus is None else gpus
    if device.type != "cuda" or device.index is not None or world > gpus:
        raise ValueError(
            f"NCCL needs a GPU of its own a rank: a world of {world} on {device} with {gpus} GPUs "
            "(backend='gloo' runs several ranks on one card)"
        )
    return [torch.device("cuda", r) for r in range(world)]


def run_ranks(fn, world: int, *args, backend: str | None = None, device="cuda", timeout: float = 600.0) -> list:
    """Run ``fn(group, *args)`` in ``world`` spawned processes on this host
    and return their results in rank order; rank r runs on
    ``rank_devices(world, backend, device)[r]``, which refuses an NCCL
    world that would put two ranks on one GPU.

    ``fn`` and ``args`` are pickled to a file in a temporary directory
    that each rank reads (a large argument written down a dead rank's
    start-up pipe would block ``start`` for good): ``fn`` must live in a
    module that imports no jax, since each rank imports it.  The ranks meet
    through a ``FileStore`` in the same directory.  A rank that raises or
    dies, or ranks still running after ``timeout`` seconds, make the call
    raise; the other ranks are then killed.
    """
    devices = rank_devices(world, backend, device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="granne_group_") as tmp:
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump((fn, args), f)
        results = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(job_path, rank, world, backend, str(dev), os.path.join(tmp, "store"), results))
            for rank, dev in enumerate(devices)
        ]
        for p in procs:
            p.start()
        done, deadline, ok = {}, time.monotonic() + timeout, False
        try:
            while len(done) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = [r for r in range(world) if r not in done]
                    raise TimeoutError(f"ranks {missing} of {world} did not finish within {timeout} s")
                try:
                    rank, success, value = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} of {world} died with exit code {dead[0][1]}") from None
                    continue
                if not success:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                done[rank] = value
            ok = True
        finally:
            for p in procs:
                if ok:
                    p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(world)]
