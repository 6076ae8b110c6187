"""Neighbor-vector cache, flat bf16 layout (port of ``granne_tpu/ops/nbr_cache.py``).

Expanding a beam node needs its adjacency row plus the vectors of all M of
its neighbors: 1 + M random row reads.  The cache stores, per node, all of
that in ONE contiguous row:

    flat layout: int16[n, pad128(M*d + 2M)] -- the M neighbor vectors (bf16
        bit patterns) back to back, then the M int32 neighbor ids split into
        2M int16 lanes (low half first), then zero padding.

The table is an INTEGER tensor on purpose: ids whose low or high 16 bits
fall in [0x7F80, 0x8000) or [0xFF80, 0x10000) are NaN bit patterns as bf16,
and UNUSED (-1) embeds as 0xFFFF.  A float table may canonicalize NaN
payloads and corrupt those ids, and a product with an id lane is NaN, so id
lanes are only ever viewed as integers.  Bit views go through
``Tensor.view(dtype)`` on a contiguous last dim, which is little-endian,
as JAX's bitcasts are.

The tiled layout (Pallas kernel K2) and the f32 flat rows are not ported
yet (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

import torch

from ..elements.base import supports_cache

_CHUNK = 65536


def not_ported(what: str) -> NotImplementedError:
    """The error for a cache feature that a later item of ROADMAP.md ports."""
    return NotImplementedError(
        f"{what} is not ported to granne_tpu_torch yet (ROADMAP.md, Queue 1 item 8)"
    )


def row_width(M: int, d: int, dtype=torch.bfloat16) -> int:
    """Flat cache-row width in int16 lanes: M*d vector lanes + 2M id lanes,
    zero-padded up to a multiple of 128 (the file-compatible layout of the
    JAX package)."""
    if dtype != torch.bfloat16:
        raise not_ported(f"a {dtype} cache row")
    return -(-(M * d + 2 * M) // 128) * 128


def unpack_ids(rows: torch.Tensor, M: int, d: int) -> torch.Tensor:
    """int16[..., row_width] flat rows -> the embedded int32 ids [..., M]."""
    return rows[..., M * d : M * d + 2 * M].contiguous().view(torch.int32)


def row_vecs(rows: torch.Tensor, M: int, d: int) -> torch.Tensor:
    """View the vector payload of flat rows as bf16[..., M*d]."""
    return rows[..., : M * d].contiguous().view(torch.bfloat16)


def pack_rows(vals: torch.Tensor, layout: str, ids: torch.Tensor | None = None) -> torch.Tensor:
    """bf16[R, M, d] neighbor vectors + int32[R, M] ids -> int16[R, row_width]."""
    if layout != "flat":
        raise not_ported(f"the {layout!r} cache layout")
    if vals.dtype != torch.bfloat16:
        raise not_ported(f"a {vals.dtype} cache row")
    if ids is None:
        raise ValueError("flat cache rows embed the adjacency ids")
    R, M, d = vals.shape
    v = vals.reshape(R, M * d).contiguous().view(torch.int16)
    idb = ids.to(torch.int32).reshape(R, M).contiguous().view(torch.int16)
    pad = row_width(M, d) - M * d - 2 * M
    zeros = torch.zeros((R, pad), dtype=torch.int16, device=vals.device)
    return torch.cat([v, idb, zeros], dim=1)


def make_neighbor_cache(
    adj: torch.Tensor,
    elements,
    chunk: int = _CHUNK,
    rows: int | None = None,
    layout: str = "flat",
    cache_dtype: str = "bf16",
) -> torch.Tensor:
    """Bulk-build the cache for a layer: int32[n, M] adjacency -> table.

    ``rows`` bounds the table to the populated prefix.  Built in ``chunk``
    row blocks so the gathered f32 vectors stay bounded.  UNUSED (-1) slots
    cache row 0's vector; readers mask on the embedded id being >= 0.
    """
    if cache_dtype not in ("bf16", "f32"):
        raise ValueError(f"cache_dtype must be 'bf16' or 'f32', got {cache_dtype!r}")
    if cache_dtype == "f32" and layout != "flat":
        raise ValueError("cache_dtype='f32' is only supported for layout='flat'")
    if layout != "flat":
        raise not_ported(f"the {layout!r} cache layout")
    if cache_dtype != "bf16":
        raise not_ported("the f32 cache table")
    if not supports_cache(elements):
        raise ValueError(f"{type(elements).__name__} cannot feed a neighbor cache")
    n, M = adj.shape
    if rows is not None:
        n = min(n, rows)
    out = torch.empty((n, row_width(M, elements.dim)), dtype=torch.int16, device=adj.device)
    for lo in range(0, n, chunk):
        a = adj[lo : lo + chunk]
        out[lo : lo + a.shape[0]] = pack_rows(elements.cache_rows(a.clamp_min(0)), "flat", ids=a)
    return out


def table_kind(tab: torch.Tensor) -> str:
    """The cache table's layout/precision contract, as an explicit name."""
    if tab.ndim == 3:
        return "tiled"
    if tab.dtype == torch.int32:
        return "flat-f32"
    if tab.dtype == torch.int16:
        return "flat-bf16"
    raise ValueError(f"not a cache table: ndim={tab.ndim} dtype={tab.dtype}")
