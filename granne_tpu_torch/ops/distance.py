"""Batched f32 and int8 cosine distance math (port of ``granne_tpu/ops/distance.py``).

f32 "angular" vectors are L2-normalized on ingest (zero vectors stay zero),
so ``dist = max(0, 1 - x . y)``.

Every contraction runs on f32 operands: bf16 inputs are upcast first, so a
bf16 x bf16 product is exact in f32 and only the accumulation rounds (the
JAX package asks for the same with ``preferred_element_type=float32``).
``torch.matmul`` on bf16 operands would return bf16 and round every beam
distance, which reorders the beam.  TF32 must be off for the same reason
the reference pins ``Precision.HIGHEST``: truncated products cost recall
(see ``full_f32``).

int8 vectors are max-abs quantized to [-127, 127] and are not unit norm;
their cosine is ``max(0, 1 - r * |x|^-1 * |y|^-1)`` with ``r`` the exact
integer dot (``i8_dots``) and the per-row reciprocal norms precomputed
(``inv_norms_i8``); a zero row has distance 1.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_QVALUE = 127.0


def full_f32() -> None:
    """Run f32 matrix products and convolutions in full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_f32(x, device) -> torch.Tensor:
    """A tensor (moved) or array-like (copied) as f32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """L2-normalize along ``axis``; zero vectors are left as zeros."""
    x = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    ok = norm > 0.0
    return torch.where(ok, x / torch.where(ok, norm, torch.ones_like(norm)), x)


def quantize_i8(x: torch.Tensor, rounding: str = "trunc") -> torch.Tensor:
    """Max-abs quantize f32 rows to int8 in [-127, 127] (a zero row stays zero).

    The codes are bit-equal to the JAX package's: the same op order
    (``x * MAX_QVALUE / denom``) rounds the same in f32.  ``"trunc"``
    truncates like the reference's ``as i8``; ``"nearest"`` rounds half to
    even, as ``jnp.round`` does.
    """
    x = x.to(torch.float32)
    max_abs = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    denom = torch.where(max_abs > 0.0, max_abs, torch.full_like(max_abs, MAX_QVALUE))
    scaled = x * MAX_QVALUE / denom
    if rounding == "nearest":
        return torch.round(scaled).to(torch.int8)
    if rounding != "trunc":
        raise ValueError(f"rounding must be 'trunc' or 'nearest', got {rounding!r}")
    return torch.trunc(scaled).to(torch.int8)


def inv_norms_i8(v: torch.Tensor) -> torch.Tensor:
    """Per-row 1/||v|| for int8 vectors (0.0 for zero rows), squares summed
    in int32 and the sum rounded to f32, as the JAX package does.

    The square root and the reciprocal run in f64 and each rounds once to
    f32, which gives the correctly rounded f32 result (f64 carries more than
    2 * 24 + 2 bits): the same bits on the CPU, on the card and in the JAX
    package, whatever the device's f32 square root and division do."""
    sq = torch.sum(v.to(torch.int32) ** 2, dim=-1, dtype=torch.int32).to(torch.float32)
    norm = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    inv = (1.0 / norm.to(torch.float64)).to(torch.float32)
    return torch.where(norm > 0.0, inv, torch.zeros_like(inv))


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


# ---------------------------------------------------------------------------
# int8 cosine distances: exact integer dots
# ---------------------------------------------------------------------------

# An f32 product of int8 codes is exact while every partial sum is an integer
# below 2^24: d * 127^2 < 2^24 holds for d <= 1040.  (PyTorch has no int32
# matrix product on CUDA, so the JAX package's int32 contraction becomes an
# f32 one on upcast codes, chunked above this width.)
I8_EXACT_LANES = 1040


def i8_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer dot products of int8 rows: a [..., m, d] x b [..., n, d] ->
    f32 [..., m, n], the exact integer rounded once to f32 (as the JAX
    package's int32 contraction followed by ``astype(float32)``).

    Up to ``I8_EXACT_LANES`` lanes one f32 product is exact; wider rows
    are contracted in chunks of that many lanes whose exact partial dots
    are summed as int64."""
    d = a.shape[-1]
    if d <= I8_EXACT_LANES:
        return a.to(torch.float32) @ b.to(torch.float32).transpose(-1, -2)
    r = None
    for lo in range(0, d, I8_EXACT_LANES):
        part = a[..., lo : lo + I8_EXACT_LANES].to(torch.float32) @ (
            b[..., lo : lo + I8_EXACT_LANES].to(torch.float32).transpose(-1, -2)
        )
        part = part.to(torch.int64)
        r = part if r is None else r + part
    return r.to(torch.float32)


def i8_dist_gathered(vecs: torch.Tensor, vec_inv_norms: torch.Tensor, q: torch.Tensor,
                     q_inv_norm: torch.Tensor) -> torch.Tensor:
    """int8 cosine distance for gathered rows: vecs int8[B, C, d],
    vec_inv_norms f32[B, C], q int8[B, d], q_inv_norm f32[B] -> f32[B, C]."""
    r = i8_dots(vecs, q[:, None, :])[..., 0]
    cos = r * vec_inv_norms * q_inv_norm[:, None]
    return torch.clamp_min(1.0 - cos, 0.0)


def i8_pairwise_gathered(vecs: torch.Tensor, vec_inv_norms: torch.Tensor) -> torch.Tensor:
    """Pairwise int8 cosine distances among gathered rows: -> f32[B, C, C]."""
    r = i8_dots(vecs, vecs)
    cos = r * vec_inv_norms[:, :, None] * vec_inv_norms[:, None, :]
    return torch.clamp_min(1.0 - cos, 0.0)


def i8_dist_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense int8 cosine distance matrix: int8[m, d] x int8[n, d] -> f32[m, n]."""
    r = i8_dots(a, b)
    cos = r * inv_norms_i8(a)[:, None] * inv_norms_i8(b)[None, :]
    return torch.clamp_min(1.0 - cos, 0.0)
