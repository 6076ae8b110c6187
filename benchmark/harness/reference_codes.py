"""The plain reference for vectors served as int8 codes by cosine.

The benchmark's own copy of ``tests/plain_ivf_i8.py``: plain PyTorch in f32
with TF32 off, importing nothing of the program and taking nothing it made.

* ``quantize``: max-abs codes, ``x * top / max|x|`` rounded half to even
  (``top`` 127 at 8 bits), what the configuration stores;
* ``exact_topk``: the exact top-k by cosine over the codes' unit rows in
  f32, in blocks of queries so the dots fit;
* ``id_dists``: the cosine distance of given ids with the codes exact and
  the query rounded to bf16, each product summed in f32, over the code
  row's norm: the precision the configuration states ("int8-codes/bf16-
  query"); with ``query_bf16=False`` the query stays f32.
* ``Exact``: the reference put in the program's place below that
  precision, a control: "fp8" rounds the codes' unit rows and the unit
  query to e4m3 (f32 sums), "codes6" requantizes the codes to 6 bits.
"""

from __future__ import annotations

import contextlib

import torch

_BLOCK_ELEMS = 1 << 30  # dots held at once by exact_topk: 4 GiB of f32


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


def topk_rows(xn: torch.Tensor, qn: torch.Tensor, k: int):
    """The ``k`` largest dots of each row of ``qn`` [B, d] with the rows of
    ``xn`` [n, d], as (ids int64, cosine distances f32), nearest first."""
    block = max(1, _BLOCK_ELEMS // max(1, xn.shape[0]))
    ids, dists = [], []
    with full_f32():
        for lo in range(0, qn.shape[0], block):
            vals, idx = torch.topk(qn[lo : lo + block] @ xn.T, k, dim=1)
            ids.append(idx)
            dists.append(torch.clamp_min(1.0 - vals, 0.0))
    return torch.cat(ids), torch.cat(dists)


def exact_topk(codes: torch.Tensor, queries: torch.Tensor, k: int):
    """The ``k`` nearest code rows of each query by cosine, in f32:
    (ids int64[B, k], dists f32[B, k]), nearest first."""
    return topk_rows(unit(codes), unit(queries), k)


def id_dists(codes: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, *, query_bf16: bool = True):
    """Cosine distance of each query of ``queries`` [R, d] to its code rows
    ``ids`` [R, k] (in range): the exact codes times the query (rounded to
    bf16 with ``query_bf16``), summed in f32, over the code row's norm."""
    rows = codes[ids.long()].to(torch.float32)  # [R, k, d], exact
    dots = (rows * _query(queries, query_bf16)[:, None, :]).sum(dim=2)
    norms = torch.sqrt(torch.sum(rows * rows, dim=2))
    return torch.clamp_min(1.0 - dots / torch.where(norms > 0, norms, torch.ones_like(norms)), 0.0)


class Exact:
    """Exact search over ``codes`` below the stated precision (a control):
    "fp8" (the codes' unit rows and the unit query in e4m3, f32 sums) or
    "codes6" (the codes requantized to 6 bits, the query in bf16)."""

    def __init__(self, codes: torch.Tensor, k: int, precision: str):
        if precision == "fp8":
            self.xn, self.query = unit(codes).to(torch.float8_e4m3fn).to(torch.float32), "fp8"
        elif precision == "codes6":
            self.xn, self.query = unit(quantize(codes, bits=6)), "bf16"
        else:
            raise ValueError(f"no control at precision {precision!r}")
        self.k = k

    def search(self, queries):
        qn = unit(queries)
        q = qn.to(torch.float8_e4m3fn if self.query == "fp8" else torch.bfloat16).to(torch.float32)
        return topk_rows(self.xn, q, self.k)

    def work(self, pool) -> dict:
        return {}
