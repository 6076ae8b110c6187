"""Batched f32 cosine distance math (port of ``granne_tpu/ops/distance.py``).

f32 "angular" vectors are L2-normalized on ingest (zero vectors stay zero),
so ``dist = max(0, 1 - x . y)``.

Every contraction runs on f32 operands: bf16 inputs are upcast first, so a
bf16 x bf16 product is exact in f32 and only the accumulation rounds (the
JAX package asks for the same with ``preferred_element_type=float32``).
``torch.matmul`` on bf16 operands would return bf16 and round every beam
distance, which reorders the beam.  TF32 must be off for the same reason
the reference pins ``Precision.HIGHEST``: truncated products cost recall
(see ``full_f32``).
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """Run f32 matrix products and convolutions in full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """L2-normalize along ``axis``; zero vectors are left as zeros."""
    x = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    ok = norm > 0.0
    return torch.where(ok, x / torch.where(ok, norm, torch.ones_like(norm)), x)


def angular_dist_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense distance matrix between unit-norm rows: [m, d] x [n, d] -> [m, n]."""
    dots = a.to(torch.float32) @ b.to(torch.float32).T
    return torch.clamp_min(1.0 - dots, 0.0)


def angular_dist_gathered(vecs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Distances between gathered rows and per-batch queries.

    vecs: [B, C, d] unit-norm candidate vectors; q: [B, d] unit-norm queries.
    Returns f32[B, C].
    """
    dots = torch.bmm(vecs.to(torch.float32), q.to(torch.float32).unsqueeze(-1)).squeeze(-1)
    return torch.clamp_min(1.0 - dots, 0.0)


def angular_pairwise_gathered(vecs: torch.Tensor) -> torch.Tensor:
    """Pairwise distances among gathered rows: [B, C, d] -> f32[B, C, C]."""
    v = vecs.to(torch.float32)
    dots = torch.bmm(v, v.transpose(1, 2))
    return torch.clamp_min(1.0 - dots, 0.0)
