"""The plain reference: exact top-k by cosine in f32, and the distance of
given ids at the precision a configuration states.

Plain PyTorch over the vectors the benchmark generated; it imports nothing
of the program and takes nothing the program made.  Matrix products run in
full f32 (TF32 off).  A ``precision`` of "bf16" or "fp8" (e4m3) rounds the
unit vectors to that type and sums their products in f32, as the tensor
cores do: at "bf16" a distance is what a configuration that serves bf16
vectors states it to be, "fp8" is a control.  The distance of given ids is
an elementwise product and a sum.
"""

from __future__ import annotations

import contextlib

import torch

_BLOCK_ELEMS = 1 << 28  # dots held at once by exact_topk: 1 GiB of f32


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit rows in f32, x / sqrt(sum(x * x)) (a zero row stays zero)."""
    x = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.where(norm > 0, norm, torch.ones_like(norm))


@contextlib.contextmanager
def full_f32():
    """Matrix products in full f32: TF32 off, and restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


_ROUNDED = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` and back to f32 ("f32": as it is)."""
    if precision in _ROUNDED:
        return x.to(_ROUNDED[precision]).to(torch.float32)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x


def exact_topk(xn: torch.Tensor, qn: torch.Tensor, k: int, *, precision: str = "f32"):
    """The ``k`` nearest of each unit query ``qn`` [B, d] among the unit rows
    ``xn`` [n, d] by cosine distance: (ids int64[B, k], dists f32[B, k]),
    nearest first, in blocks of queries so the dots fit."""
    xn, qn = rounded(xn, precision), rounded(qn, precision)
    block = max(1, _BLOCK_ELEMS // max(1, xn.shape[0]))
    ids, dists = [], []
    with full_f32():
        for lo in range(0, qn.shape[0], block):
            vals, idx = torch.topk(qn[lo : lo + block] @ xn.T, k, dim=1)
            ids.append(idx)
            dists.append(torch.clamp_min(1.0 - vals, 0.0))
    return torch.cat(ids), torch.cat(dists)


def id_dists(xn: torch.Tensor, qn: torch.Tensor, ids: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """Cosine distance of each query row of ``qn`` [R, d] to the rows ``ids``
    [R, k] (in range) of ``xn``, both rounded to ``precision``, the products
    summed in f32."""
    rows = rounded(xn[ids.long()], precision)  # [R, k, d]
    dots = (rows * rounded(qn, precision)[:, None, :]).sum(dim=2)
    return torch.clamp_min(1.0 - dots, 0.0)


class Exact:
    """The reference put in the program's place: exact search over
    ``corpus`` at ``precision`` (a control)."""

    def __init__(self, corpus: torch.Tensor, k: int, precision: str):
        self.xn, self.k, self.precision = normalize(corpus), k, precision

    def search(self, queries):
        return exact_topk(self.xn, normalize(queries), self.k, precision=self.precision)

    def work(self, pool) -> dict:
        return {}
