"""Batched k-means (Lloyd's), the IVF coarse quantizer trainer (port of
``granne_tpu/ops/kmeans.py``).

Assignment is a chunked [n, d] x [d, k] f32 product + argmax (``torch.argmax``
takes the first maximum, as ``jnp.argmax`` does); the update is an
``index_add_`` segment sum.  Its f32 summation order differs from XLA's
scatter-add, so the centroids agree with the JAX package's to rounding and
Lloyd's iterations can part at near-ties.  The seeding
(``_kmeanspp_init``) is pure numpy, copied verbatim, so it is bit-equal for
the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import as_f32


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor, *, chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment by maximum dot product (unit-norm data).

    x: f32[n, d]; centroids: f32[k, d].  Returns int32[n].
    """
    c = centroids.to(torch.float32)
    out = [
        torch.argmax(x[lo : lo + chunk].to(torch.float32) @ c.T, dim=1).to(torch.int32)
        for lo in range(0, x.shape[0], chunk)
    ]
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32, device=x.device)


def _update_centroids(x: torch.Tensor, assign: torch.Tensor, *, k: int):
    idx = assign.long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device).index_add_(0, idx, x)
    ones = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device).index_add_(0, idx, ones)
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator, sample: int = 20000) -> np.ndarray:
    """k-means||-style seeding (distance-proportional, oversampled rounds).

    The init subsample scales with k (>= 4k when data allows) so large-k
    trainings (IVF at 100M+ vectors uses k in the tens of thousands) never
    exhaust the candidate pool; if the remaining d2 mass hits zero (fewer
    distinct points than centers) the tail falls back to uniform picks.
    Centers are drawn in ~32 oversampled rounds with a BLAS distance update
    instead of one python-loop iteration per center.
    """
    n = x.shape[0]
    sample = max(sample, 4 * k)
    if n > sample:
        x = np.ascontiguousarray(x[rng.choice(n, size=sample, replace=False)])
        n = sample
    if k >= n:
        extra = rng.integers(n, size=k - n)
        return np.concatenate([x, x[extra]]).astype(np.float32)
    centers = np.empty((k, x.shape[1]), np.float32)
    centers[0] = x[rng.integers(n)]
    x_sq = np.sum(x.astype(np.float32) ** 2, axis=1)
    d2 = np.maximum(x_sq + np.sum(centers[0] ** 2) - 2.0 * (x @ centers[0]), 0.0)
    i = 1
    while i < k:
        s = float(d2.sum())
        if s <= 1e-12:
            centers[i:] = x[rng.integers(n, size=k - i)]
            break
        batch = min(k - i, max(1, k // 32))
        idx = rng.choice(n, size=batch, p=d2 / s)
        c = x[idx].astype(np.float32)
        centers[i : i + batch] = c
        new_d2 = x_sq[:, None] + np.sum(c**2, axis=1)[None, :] - 2.0 * (x @ c.T)
        d2 = np.minimum(d2, np.maximum(new_d2.min(axis=1), 0.0))
        i += batch
    return centers


def train_kmeans(x, k: int, *, iters: int = 12, seed: int = 0, chunk: int = 65536):
    """k-means++ seeded Lloyd's iterations; empty clusters re-seed randomly.

    ``x`` is a tensor (trained where it lies) or an array (trained on the
    CPU).  Returns (centroids f32[k, d], assignments int32[n]) beside ``x``.
    """
    x = as_f32(x, x.device if isinstance(x, torch.Tensor) else "cpu")
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    centroids = torch.as_tensor(_kmeanspp_init(x.cpu().numpy(), k, rng), device=x.device)
    step = min(chunk, max(256, n))
    for _ in range(iters):
        assign = assign_clusters(x, centroids, chunk=step)
        centroids, counts = _update_centroids(x, assign, k=k)
        empty = (counts == 0).cpu().numpy()
        if empty.any():
            reseed = rng.choice(n, size=int(empty.sum()))
            centroids[torch.as_tensor(np.nonzero(empty)[0], device=x.device)] = x[
                torch.as_tensor(reseed, device=x.device)
            ]
    return centroids, assign_clusters(x, centroids, chunk=step)
