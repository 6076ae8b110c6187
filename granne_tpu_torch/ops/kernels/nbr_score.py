"""The neighbor-cache scorers K1 (flat layout) and K2 (tiled layout).

K1, ``gather_score_flat``, replaces the Pallas TPU kernel
``granne_tpu/ops/pallas/nbr_score.py::gather_score_flat``: row gather,
scoring and id unpack in one pass.  Unlike the TPU kernel it takes the
plain bf16 query: the query-tile pattern and the segment-indicator matmul
of the Pallas version only avoid an in-kernel relayout on the TPU, and its
``S % 8 == 0`` row rule is the TPU's DMA sublane rule, so any
``RW == row_width(M, d)`` is accepted here.

K2, ``gather_score``, replaces ``granne_tpu/ops/pallas/nbr_score.py::gather_score``:
row gather and scoring over the tiled layout.  It too takes the plain
bf16[B, d] query (d <= 128) where the JAX wrapper passes the query padded
to 128 zero lanes: the pad adds only zero products.

Both CUDA kernels are in ``granne_tpu_torch/csrc/nbr_score.cu`` (its header
says what bounds them on the H100 and how the design answers that).  Each
wrapper runs its plain PyTorch version for CPU tensors and the kernel for
CUDA tensors; for a CUDA tensor it launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches.

A launch costs the host little and is capture-safe: the library is loaded
once per process, the outputs come from ``torch.empty``, and the kernel
goes to ``torch.cuda.current_stream()`` with no host synchronisation, so a
call inside ``torch.cuda.graph`` is captured and replays.
"""

from __future__ import annotations

import ctypes

import torch

from ..nbr_cache import row_vecs, row_width, unpack_ids
from .build import load_cuda_library

SIGNATURES = {
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
    "gt_gather_score": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # tab, n, Mp
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # sel_ids, B*E, E
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # q, M, d
            ctypes.c_void_p,  # dots
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ],
    ),
    "gt_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


_lib = None


def load_kernel():
    """Build (at first use) and load the kernels' library; once loaded, it
    is returned at once."""
    global _lib
    if _lib is None:
        _lib = load_cuda_library("nbr_score", SIGNATURES)
    return _lib


def _launched(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.gt_cuda_error_string(err).decode()}")


def launch_flat(lib, tab, sel_ids, q, M: int, d: int):
    """K1 from ``lib`` on checked CUDA tensors: (dots, nbrs), uncounted."""
    B, E = sel_ids.shape
    dev = tab.device
    dots = torch.empty((B, E * M), dtype=torch.float32, device=dev)
    nbrs = torch.empty((B, E * M), dtype=torch.int32, device=dev)
    if B * E:
        _launched(lib, lib.gt_gather_score_flat(
            tab.data_ptr(), tab.shape[0], tab.shape[1], sel_ids.data_ptr(), B * E, E, q.data_ptr(), M, d,
            dots.data_ptr(), nbrs.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ), "gather_score_flat")
    return dots, nbrs


def launch_tiled(lib, tab, sel_ids, q, M: int):
    """K2 from ``lib`` on checked CUDA tensors: dots, uncounted."""
    B, E = sel_ids.shape
    dev = tab.device
    dots = torch.empty((B, E * M), dtype=torch.float32, device=dev)
    if B * E:
        _launched(lib, lib.gt_gather_score(
            tab.data_ptr(), tab.shape[0], tab.shape[1], sel_ids.data_ptr(), B * E, E, q.data_ptr(), M, q.shape[1],
            dots.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ), "gather_score")
    return dots


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
    if tab.data_ptr() % 16:
        raise ValueError("tab must start on a 16-byte boundary")
    out = launch_flat(lib, tab, sel_ids, q, M, d)
    gather_score_flat.launches += 1
    return out


gather_score_flat.launches = 0


def _check_tiled(tab, sel_ids, q, M: int) -> None:
    if tab.ndim != 3 or tab.dtype != torch.bfloat16 or tab.shape[2] != 128 or not tab.is_contiguous():
        raise ValueError(f"tab must be a contiguous bf16[n, Mp, 128] table, got {tab.dtype}{tuple(tab.shape)}")
    if not 0 < M <= tab.shape[1]:
        raise ValueError(f"M={M} does not fit the table's {tab.shape[1]} vectors per row")
    if sel_ids.ndim != 2 or sel_ids.dtype != torch.int32 or not sel_ids.is_contiguous():
        raise ValueError(f"sel_ids must be contiguous int32[B, E], got {sel_ids.dtype}{tuple(sel_ids.shape)}")
    B = sel_ids.shape[0]
    if q.ndim != 2 or q.shape[0] != B or not 0 < q.shape[1] <= 128 or q.dtype != torch.bfloat16 \
            or not q.is_contiguous():
        raise ValueError(f"q must be contiguous bf16[{B}, d <= 128], got {q.dtype}{tuple(q.shape)}")
    if not (tab.device == sel_ids.device == q.device):
        raise ValueError(f"tensors on different devices: {tab.device}, {sel_ids.device}, {q.device}")


def gather_score_reference(tab, sel_ids, q, *, M: int):
    """Plain PyTorch version of K2: row gather, f32 contraction over the
    first M vectors and the first d lanes."""
    B, E = sel_ids.shape
    d = q.shape[1]
    rows = tab.index_select(0, sel_ids.reshape(-1).clamp(0, tab.shape[0] - 1).long())
    vecs = rows[:, :M, :d].reshape(B, E * M, d).to(torch.float32)
    return torch.bmm(vecs, q.to(torch.float32).unsqueeze(-1)).squeeze(-1)


def gather_score(tab, sel_ids, q, *, M: int):
    """Score each query against its E selected nodes' cached neighbors (K2).

    tab: bf16[n, Mp, 128] tiled cache table (``ops.nbr_cache``), Mp >= M;
    sel_ids: int32[B, E] expanded-node ids (negative ids clip to row 0);
    q: bf16[B, d] queries, d <= 128.  Returns dots f32[B, E*M], the raw
    query . neighbor products.
    """
    _check_tiled(tab, sel_ids, q, M)
    if tab.device.type == "cpu":
        return gather_score_reference(tab, sel_ids, q, M=M)
    if tab.device.type != "cuda":
        raise ValueError(f"gather_score takes cpu or cuda tensors, got {tab.device}")
    lib = load_kernel()
    if tab.data_ptr() % 16:
        raise ValueError("tab must start on a 16-byte boundary")
    out = launch_tiled(lib, tab, sel_ids, q, M)
    gather_score.launches += 1
    return out


gather_score.launches = 0
