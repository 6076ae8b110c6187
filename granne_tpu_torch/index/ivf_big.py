"""Chunked IVF construction for datasets larger than device memory (port of
``granne_tpu/index/ivf_big.py``).

The dataset stays on the host (f32, or int8 max-abs codes); k-means trains
on a normalized subsample, assignment streams fixed-size chunks through the
device, and the blocks are laid out on the host as
:meth:`~granne_tpu_torch.index.ivf.IvfIndex.build` lays them out.  The
resulting index either lives on the device or, with
``device_resident=False``, stays in host memory.  No pass holds more than
one chunk of the dataset on the device, and the assignment scores a chunk
against the centroids in slices of ``kmeans.assign_clusters``'s rows, so
no score matrix grows with the chunk (a 4M-row chunk against 8,192
centroids would be 131 GB of f32).  The three stages run in the
``utils.trace`` spans ``ivf_big/train``, ``ivf_big/assign`` and
``ivf_big/layout``, each waiting for the device at its end.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models.brute import merge_chunk_topk
from ..ops import kmeans
from ..ops.distance import as_f32, inv_norms_i8, normalize
from ..ops.topk import top_k
from ..utils import trace
from .ivf import IvfIndex, layout_blocks


def _log(m):
    print(m, file=sys.stderr, flush=True)


def _assign_chunk_f32(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment (bf16-rounded operands, f32 accumulation)
    + the L2-normalized rows of an f32 chunk."""
    xn = normalize(x)
    return kmeans.assign_clusters(xn.to(torch.bfloat16), _bf16(centroids)), xn


def _assign_chunk_i8(x_i8: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment + per-row inverse norms of an int8 chunk.

    argmax_c dot(x, c) is scale-invariant in x, so quantized rows assign to
    the cluster their unit-norm f32 originals would, up to quantization
    noise at near-equal clusters.
    """
    return kmeans.assign_clusters(x_i8, _bf16(centroids)), inv_norms_i8(x_i8)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _train(sample: np.ndarray, n_clusters, kmeans_iters, seed, device, log):
    take = sample.shape[0]
    log(f"[ivf_big] kmeans: k={n_clusters} on {take} samples, {kmeans_iters} iters")
    with trace.span("ivf_big/train", block=True):
        x = normalize(as_f32(sample, device))
        centroids, _ = kmeans.train_kmeans(x, n_clusters, iters=kmeans_iters, seed=seed)
    return centroids


def build_ivf_f32_chunked(
    x: np.ndarray,
    *,
    n_clusters: int,
    cluster_cap: int = 256,
    kmeans_iters: int = 8,
    kmeans_sample: int = 1_000_000,
    chunk: int = 2_000_000,
    seed: int = 0,
    dtype: str = "bfloat16",
    log=_log,
    device="cuda",
) -> IvfIndex:
    """f32-ingest analogue of :func:`build_ivf_i8_chunked`: k-means on a
    subsample, streamed assignment, the standard sub-block layout."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    n, d = x.shape
    rng = np.random.default_rng(seed)
    take = min(kmeans_sample, n)
    sel = np.sort(rng.choice(n, size=take, replace=False)) if take < n else np.arange(n)
    centroids = _train(x[sel], n_clusters, kmeans_iters, seed, device, log)

    assign = np.empty((n,), np.int32)
    xn = np.empty((n, d), np.float32)
    with trace.span("ivf_big/assign", block=True):
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            a, xnc = _assign_chunk_f32(as_f32(x[lo:hi], device), centroids)
            assign[lo:hi] = a.cpu().numpy()
            xn[lo:hi] = xnc.cpu().numpy()
            log(f"[ivf_big] assigned {hi}/{n}")

    L = -(-cluster_cap // 8) * 8
    with trace.span("ivf_big/layout", block=True):
        blocks, ids, cent = layout_blocks(xn, centroids.cpu().numpy(), assign, n_clusters, L)
        index = IvfIndex._from_f32_blocks(blocks, ids, cent, n, dtype, torch.device(device))
    log(f"[ivf_big] layout: {blocks.shape[0]} physical blocks of L={L} ({blocks.shape[0] * L / n - 1:+.1%} padding)")
    return index


def build_ivf_i8_chunked(
    x_i8: np.ndarray,
    *,
    n_clusters: int,
    cluster_cap: int = 512,
    kmeans_iters: int = 8,
    kmeans_sample: int = 1_000_000,
    chunk: int = 4_000_000,
    seed: int = 0,
    device_resident: bool = True,
    log=_log,
    device="cuda",
) -> IvfIndex:
    """Build an int8 IVF index from a host-resident int8 dataset.

    The coarse quantizer and the assignment run on ``device``; the index
    lands there too if ``device_resident``, else its tensors stay on the
    CPU (the host-memory tier).

    Args:
      x_i8: int8[n, d] max-abs quantized vectors (host).
    """
    n, d = x_i8.shape
    rng = np.random.default_rng(seed)

    # 1. coarse quantizer on a normalized f32 subsample
    take = min(kmeans_sample, n)
    sel = rng.choice(n, size=take, replace=False) if take < n else np.arange(n)
    centroids = _train(x_i8[np.sort(sel)], n_clusters, kmeans_iters, seed, device, log)

    # 2. streaming assignment over int8 chunks
    assign = np.empty((n,), np.int32)
    inv_norms = np.empty((n,), np.float32)
    with trace.span("ivf_big/assign", block=True):
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            a, iv = _assign_chunk_i8(torch.tensor(np.asarray(x_i8[lo:hi]), device=device), centroids)
            assign[lo:hi] = a.cpu().numpy()
            inv_norms[lo:hi] = iv.cpu().numpy()
            log(f"[ivf_big] assigned {hi}/{n}")

    # 3. fixed-size sub-block layout (host), then to where the index lives
    L = -(-cluster_cap // 8) * 8
    where = device if device_resident else "cpu"
    with trace.span("ivf_big/layout", block=True):
        cent_np = centroids.cpu().numpy()
        blocks, ids, cent = layout_blocks(np.asarray(x_i8, np.int8), cent_np, assign, n_clusters, L)
        scales = np.where(ids >= 0, inv_norms[ids], np.float32(0))  # each placed row's own, 0 for padding
        index = IvfIndex(
            centroids=torch.as_tensor(cent, device=where),
            blocks=torch.as_tensor(blocks, device=where),
            block_ids=torch.as_tensor(ids, device=where),
            block_scales=torch.as_tensor(scales, device=where),
            n_total=n,
        )
    log(f"[ivf_big] layout: {blocks.shape[0]} physical blocks of L={L} ({blocks.shape[0] * L / n - 1:+.1%} padding)")
    return index


def exact_topk_over_blocks(index: IvfIndex, q, k: int, *, block_chunk: int = 2048):
    """Exact ground truth by scanning every block chunk in f32 (stored
    values upcast losslessly, queries at full precision).  Returns numpy
    (ids int64[B, k], cosines f32[B, k]), best first."""
    qt = as_f32(q, index.blocks.device)
    B = qt.shape[0]
    best_v = np.full((B, k), -np.inf, np.float32)
    best_ids = np.full((B, k), -1, np.int64)
    for lo in range(0, index.blocks.shape[0], block_chunk):
        blk, ids = index.blocks[lo : lo + block_chunk], index.block_ids[lo : lo + block_chunk]
        dots = torch.einsum("sld,bd->bsl", blk.to(torch.float32), qt)
        cos = torch.where((ids >= 0)[None], dots * index.block_scales[lo : lo + block_chunk][None], -torch.inf)
        v, pos = top_k(cos.reshape(B, -1), k)
        best_v, best_ids = merge_chunk_topk(best_v, best_ids, v, ids.reshape(-1)[pos], k)
    return best_ids, best_v
