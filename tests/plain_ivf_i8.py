"""Plain reference for vectors served as int8 codes by cosine.

Plain PyTorch in f32 with TF32 off; it imports neither JAX, ``granne_tpu``
nor ``granne_tpu_torch``, and knows nothing of blocks, clusters or probes.

* ``quantize``: max-abs codes, ``x * top / max|x|`` rounded half to even
  (``top`` 127 for int8; fewer bits give the lower-precision controls).
* ``exact_topk``: the exact top-k by cosine over the codes' unit rows, in
  f32 (``query_bf16``: the query rounded to bf16 first, as the deployment
  states it).
* ``id_dists``: the cosine distance of given ids with the codes exact and
  the query rounded to bf16 (``query_bf16=False``: in f32), each product
  summed in f32, then divided by the code row's norm.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Matrix products in full f32: TF32 off, and restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def quantize(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Max-abs codes of the rows of ``x`` in [-top, top], top = 2**(bits-1) - 1,
    rounded half to even, as int8 (a zero row stays zero)."""
    top = 2 ** (bits - 1) - 1
    x = x.to(torch.float32)
    m = torch.amax(torch.abs(x), dim=1, keepdim=True)
    return torch.round(x * top / torch.where(m > 0, m, torch.ones_like(m))).to(torch.int8)


def unit(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` over their norms, in f32 (a zero row stays zero)."""
    x = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.where(norm > 0, norm, torch.ones_like(norm))


def _query(q: torch.Tensor, query_bf16: bool) -> torch.Tensor:
    qn = unit(q)
    return qn.to(torch.bfloat16).to(torch.float32) if query_bf16 else qn


def exact_topk(codes: torch.Tensor, queries: torch.Tensor, k: int, *, query_bf16: bool = False,
               block: int = 256):
    """The ``k`` nearest code rows of each query by cosine: (ids int64[B, k],
    dists f32[B, k]), nearest first, ``block`` queries at a time."""
    xn, qn = unit(codes), _query(queries, query_bf16)
    ids, dists = [], []
    with full_f32():
        for lo in range(0, qn.shape[0], block):
            vals, idx = torch.topk(qn[lo : lo + block] @ xn.T, k, dim=1)
            ids.append(idx)
            dists.append(torch.clamp_min(1.0 - vals, 0.0))
    return torch.cat(ids), torch.cat(dists)


def id_dists(codes: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, *, query_bf16: bool = True):
    """Cosine distance of each query of ``queries`` [R, d] to its code rows
    ``ids`` [R, k]: the exact codes times the query (rounded to bf16 with
    ``query_bf16``), summed in f32, over the code row's norm."""
    rows = codes[ids.long()].to(torch.float32)  # [R, k, d], exact
    dots = (rows * _query(queries, query_bf16)[:, None, :]).sum(dim=2)
    norms = torch.sqrt(torch.sum(rows * rows, dim=2))
    return torch.clamp_min(1.0 - dots / torch.where(norms > 0, norms, torch.ones_like(norms)), 0.0)
