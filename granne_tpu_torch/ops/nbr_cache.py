"""Neighbor-vector cache (port of ``granne_tpu/ops/nbr_cache.py``).

Expanding a beam node needs its adjacency row plus the vectors of all M of
its neighbors: 1 + M random row reads.  The cache stores, per node, the M
neighbor vectors in ONE contiguous row, in one of three encodings:

    flat bf16: int16[n, pad128(M*d + 2M)] -- the M neighbor vectors (bf16
        bit patterns) back to back, then the M int32 neighbor ids split
        into 2M int16 lanes (low half first), then zero padding.  Scored
        by the fused kernel K1 (``ops.kernels.nbr_score.gather_score_flat``).
    flat f32:  int32[n, pad128(M*d + M)] -- the M f32 vectors (bit
        patterns), then the M int32 ids stored directly.  Twice the bytes,
        but every cached score is exact.  Scored in plain PyTorch (the JAX
        package has no kernel for it either).
    tiled:     bf16[n, pad8(M), 128] -- each vector zero-padded to 128
        lanes, rows padded to 8 vectors (the TPU's DMA granule); no ids, the
        beam reads them from the adjacency.  Scored by the kernel K2
        (``ops.kernels.nbr_score.gather_score``); requires d <= 128.
        A container whose ``tiled_refusal`` is set (int8 elements)
        cannot feed it.

The flat tables are INTEGER tensors on purpose: ids whose low or high 16
bits fall in [0x7F80, 0x8000) or [0xFF80, 0x10000) are NaN bit patterns as
bf16, and UNUSED (-1) embeds as 0xFFFF.  A float table may canonicalize NaN
payloads and corrupt those ids, and a product with an id lane is NaN, so id
lanes are only ever viewed as integers.  Bit views go through
``Tensor.view(dtype)`` on a contiguous last dim, which is little-endian,
as JAX's bitcasts are.
"""

from __future__ import annotations

import torch

from ..elements.base import supports_cache

_CHUNK = 65536


def row_width(M: int, d: int, dtype=torch.bfloat16) -> int:
    """Flat cache-row width in lanes, zero-padded up to a multiple of 128
    (the layout of the JAX package): bf16 rows hold M*d vector lanes + 2M
    int16 id lanes, f32 rows M*d vector lanes + M int32 id lanes."""
    if dtype == torch.float32:
        return -(-(M * d + M) // 128) * 128
    return -(-(M * d + 2 * M) // 128) * 128


def unpack_ids(rows: torch.Tensor, M: int, d: int) -> torch.Tensor:
    """int16|int32[..., row_width] flat rows -> the embedded int32 ids [..., M]."""
    if rows.dtype == torch.int32:
        return rows[..., M * d : M * d + M]
    return rows[..., M * d : M * d + 2 * M].contiguous().view(torch.int32)


def row_vecs(rows: torch.Tensor, M: int, d: int) -> torch.Tensor:
    """View the vector payload of flat rows as bf16|f32[..., M*d]."""
    dtype = torch.float32 if rows.dtype == torch.int32 else torch.bfloat16
    return rows[..., : M * d].contiguous().view(dtype)


def tiled_height(M: int) -> int:
    """Tiled cache-row height: M padded up to the TPU's 8-sublane DMA
    granule (kept so tables stay interchangeable with the JAX package)."""
    return -(-M // 8) * 8


def check_layout(elements, layout: str) -> None:
    """Raise ValueError unless ``elements`` can feed a cache in ``layout``."""
    if not supports_cache(elements):
        raise ValueError(f"{type(elements).__name__} cannot feed a neighbor cache")
    if layout == "tiled" and elements.tiled_refusal is not None:
        raise ValueError(f"{type(elements).__name__} cannot feed the tiled neighbor cache: {elements.tiled_refusal}")


def pack_rows(vals: torch.Tensor, layout: str, ids: torch.Tensor | None = None) -> torch.Tensor:
    """[R, M, d] neighbor vectors -> cache rows in ``layout``.

    flat:  bf16 vectors + int32[R, M] ``ids`` -> int16[R, row_width];
           f32 vectors + ids -> int32[R, row_width(M, d, f32)].
    tiled: bf16 vectors -> bf16[R, pad8(M), 128], zero padded (d <= 128).
    """
    R, M, d = vals.shape
    if layout == "tiled":
        if d > 128:
            raise ValueError(f"the tiled layout holds d <= 128, got d={d}")
        out = torch.zeros((R, tiled_height(M), 128), dtype=torch.bfloat16, device=vals.device)
        out[:, :M, :d] = vals
        return out
    if layout != "flat":
        raise ValueError(f"cache layout must be 'flat' or 'tiled', got {layout!r}")
    if ids is None:
        raise ValueError("flat cache rows embed the adjacency ids")
    ids = ids.to(torch.int32).reshape(R, M).contiguous()
    if vals.dtype == torch.float32:
        parts = [vals.reshape(R, M * d).contiguous().view(torch.int32), ids]
    elif vals.dtype == torch.bfloat16:
        parts = [vals.reshape(R, M * d).contiguous().view(torch.int16), ids.view(torch.int16)]
    else:
        raise ValueError(f"flat cache rows hold bf16 or f32 vectors, got {vals.dtype}")
    dtype = parts[0].dtype
    pad = row_width(M, d, vals.dtype) - sum(p.shape[1] for p in parts)
    parts.append(torch.zeros((R, pad), dtype=dtype, device=vals.device))
    return torch.cat(parts, dim=1)


def make_neighbor_cache(
    adj: torch.Tensor,
    elements,
    chunk: int = _CHUNK,
    rows: int | None = None,
    layout: str = "flat",
    cache_dtype: str = "bf16",
) -> torch.Tensor:
    """Bulk-build the cache for a layer: int32[n, M] adjacency -> table.

    ``rows`` bounds the table to the populated prefix; unlike the JAX
    package the table holds exactly that many rows.  Built in ``chunk`` row
    blocks so the gathered vectors stay bounded.  UNUSED (-1) slots cache
    row 0's vector; readers mask on the id being >= 0.  ``cache_dtype="f32"``
    (flat only) stores ``elements.cache_rows_exact``.
    """
    if cache_dtype not in ("bf16", "f32"):
        raise ValueError(f"cache_dtype must be 'bf16' or 'f32', got {cache_dtype!r}")
    if cache_dtype == "f32" and layout != "flat":
        raise ValueError("cache_dtype='f32' is only supported for layout='flat'")
    if layout not in ("flat", "tiled"):
        raise ValueError(f"cache layout must be 'flat' or 'tiled', got {layout!r}")
    check_layout(elements, layout)
    n, M = adj.shape
    if rows is not None:
        n = min(n, rows)
    rows_of = elements.cache_rows_exact if cache_dtype == "f32" else elements.cache_rows
    parts = []
    for lo in range(0, n, chunk):
        a = adj[lo : min(lo + chunk, n)]
        parts.append(pack_rows(rows_of(a.clamp_min(0)), layout, ids=a))
    if not parts:
        parts.append(pack_rows(rows_of(adj[:0].clamp_min(0)), layout, ids=adj[:0]))
    return torch.cat(parts)


def table_kind(tab: torch.Tensor) -> str:
    """The cache table's layout/precision contract, as an explicit name."""
    if tab.ndim == 3:
        return "tiled"
    if tab.dtype == torch.int32:
        return "flat-f32"
    if tab.dtype == torch.int16:
        return "flat-bf16"
    raise ValueError(f"not a cache table: ndim={tab.ndim} dtype={tab.dtype}")


def rows_to_vecs(tab: torch.Tensor, ids: torch.Tensor, M: int, d: int) -> torch.Tensor:
    """Gather the cache rows of ``ids`` [N] as [N, M, d] neighbor vectors
    (either layout): one row read per id instead of M element rows, the
    cache-fed merge's source."""
    rows = tab.index_select(0, ids.clamp(0, tab.shape[0] - 1).long())
    if tab.ndim == 2:
        return row_vecs(rows, M, d).reshape(ids.shape[0], M, d)
    return rows[:, :M, :d]


def score_cached(tab: torch.Tensor, sel_ids: torch.Tensor, queries, elements, M: int, lanes=None):
    """Distances from the query batch (B queries) to the cached neighbors of
    their E expanded nodes ``sel_ids`` [B, E]: f32[B, E*M].

    A tiled table goes through K2 on ``elements.query_lanes(queries)`` (or
    ``lanes``, when the caller made them once for many calls, as the beam
    does) and ``elements.dist_from_dots_q``; a flat table through a row
    gather and ``elements.score_block``.
    """
    from .kernels.nbr_score import gather_score  # the kernel module reads this one's layout

    B, E = sel_ids.shape
    if table_kind(tab) == "tiled":
        check_layout(elements, "tiled")
        if lanes is None:
            lanes = elements.query_lanes(queries)
        dots = gather_score(tab, sel_ids.contiguous(), lanes, M=M)
        return elements.dist_from_dots_q(dots, queries)
    d = elements.dim
    rows = tab.index_select(0, sel_ids.reshape(-1).clamp(0, tab.shape[0] - 1).long())
    return elements.score_block(row_vecs(rows, M, d).reshape(B, E * M, d), queries)
