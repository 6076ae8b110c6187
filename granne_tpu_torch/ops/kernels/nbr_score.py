"""K1: fused flat neighbor-cache gather + scoring + id unpack.

Replaces the Pallas TPU kernel
``granne_tpu/ops/pallas/nbr_score.py::gather_score_flat``.  The CUDA kernel
is ``granne_tpu_torch/csrc/nbr_score.cu`` (its header says what bounds it on
the H100 and how the design answers that).  Unlike the TPU kernel it takes
the plain bf16 query: the query-tile pattern and the segment-indicator
matmul of the Pallas version only avoid an in-kernel relayout on the TPU,
and its ``S % 8 == 0`` row rule is the TPU's DMA sublane rule, so any
``RW == row_width(M, d)`` is accepted here.

``gather_score_flat`` runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors; for a CUDA tensor it launches the kernel or
raises.  ``gather_score_flat.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..nbr_cache import row_vecs, row_width, unpack_ids
from .build import load_cuda_library

_SIGNATURES = {
    "gt_gather_score_flat": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # tab, n, RW
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # sel_ids, B*E, E
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # q, M, d
            ctypes.c_void_p, ctypes.c_void_p,  # dots, nbrs
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ],
    ),
    "gt_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def load_kernel():
    """Build (at first use) and load the kernel's library."""
    return load_cuda_library("nbr_score", _SIGNATURES)


def _check(tab, sel_ids, q, M: int, d: int) -> None:
    if tab.ndim != 2 or tab.dtype != torch.int16 or not tab.is_contiguous():
        raise ValueError(f"tab must be a contiguous int16[n, RW] table, got {tab.dtype}{tuple(tab.shape)}")
    if tab.shape[1] != row_width(M, d):
        raise ValueError(f"tab rows have {tab.shape[1]} lanes, row_width({M}, {d}) = {row_width(M, d)}")
    if sel_ids.ndim != 2 or sel_ids.dtype != torch.int32 or not sel_ids.is_contiguous():
        raise ValueError(f"sel_ids must be contiguous int32[B, E], got {sel_ids.dtype}{tuple(sel_ids.shape)}")
    if q.shape != (sel_ids.shape[0], d) or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"q must be contiguous bf16[{sel_ids.shape[0]}, {d}], got {q.dtype}{tuple(q.shape)}")
    if not (tab.device == sel_ids.device == q.device):
        raise ValueError(f"tensors on different devices: {tab.device}, {sel_ids.device}, {q.device}")


def gather_score_flat_reference(tab, sel_ids, q, *, M: int, d: int):
    """Plain PyTorch version: row gather, bit views, f32 contraction."""
    B, E = sel_ids.shape
    rows = tab.index_select(0, sel_ids.reshape(-1).clamp(0, tab.shape[0] - 1).long())
    vecs = row_vecs(rows, M, d).reshape(B, E * M, d).to(torch.float32)
    dots = torch.bmm(vecs, q.to(torch.float32).unsqueeze(-1)).squeeze(-1)
    return dots, unpack_ids(rows, M, d).reshape(B, E * M)


def gather_score_flat(tab, sel_ids, q, *, M: int, d: int):
    """Score each query against its E selected nodes' cached neighbors.

    tab: int16[n, row_width(M, d)] flat cache table (``ops.nbr_cache``);
    sel_ids: int32[B, E] expanded-node ids (negative ids clip to row 0);
    q: bf16[B, d] queries.  Returns (dots f32[B, E*M] raw query . neighbor
    products, nbrs int32[B, E*M] embedded adjacency ids).
    """
    _check(tab, sel_ids, q, M, d)
    if tab.device.type == "cpu":
        return gather_score_flat_reference(tab, sel_ids, q, M=M, d=d)
    if tab.device.type != "cuda":
        raise ValueError(f"gather_score_flat takes cpu or cuda tensors, got {tab.device}")
    lib = load_kernel()
    B, E = sel_ids.shape
    dots = torch.empty((B, E * M), dtype=torch.float32, device=tab.device)
    nbrs = torch.empty((B, E * M), dtype=torch.int32, device=tab.device)
    if B * E == 0:
        return dots, nbrs
    if tab.data_ptr() % 16:
        raise ValueError("tab must start on a 16-byte boundary")
    stream = torch.cuda.current_stream(tab.device)
    err = lib.gt_gather_score_flat(
        tab.data_ptr(), tab.shape[0], tab.shape[1],
        sel_ids.data_ptr(), B * E, E,
        q.data_ptr(), M, d,
        dots.data_ptr(), nbrs.data_ptr(),
        tab.device.index, stream.cuda_stream,
    )
    if err:
        raise RuntimeError(f"gather_score_flat launch failed: {lib.gt_cuda_error_string(err).decode()}")
    gather_score_flat.launches += 1
    return dots, nbrs


gather_score_flat.launches = 0
