"""Row top-k on the card: the ``k`` largest of each row, best first.

Replaces no Pallas kernel: the JAX package leaves ``lax.top_k`` to XLA.
``row_top_k`` has the contract of ``ops/topk.py::top_k``, its plain
version, on a contiguous f32 [R, C] and 1 <= k <= min(C, K_MAX): values
f32 [R, k] and columns int64 [R, k], best first, equal values to the lower
column (numerically, so -0.0 equals +0.0), -inf below every finite value
and NaN below -inf, each value the input's own bits.  The CUDA kernel is
``granne_tpu_torch/csrc/row_topk.cu`` (its header says what bounds it on
the H100 and how the design answers that): one read of each row, a warp a
row, the running top-32 in registers.

CPU tensors take ``top_k`` itself; for a CUDA tensor the wrapper launches
the kernel or raises.  ``row_top_k.launches`` counts kernel launches.  A
launch is capture-safe: the library is loaded once per process, the
outputs come from ``torch.empty`` (every element is written), and the
kernel goes to ``torch.cuda.current_stream()`` with no host
synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from ..topk import top_k
from .build import load_cuda_library

K_MAX = 32  # an entry of the running top-k a lane of the warp

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "gt_row_topk": (_I, [_P, _LL, _I, _I, _P, _P, _I, _P]),  # scores, R, C, k, out_v, out_i, device, stream
    "gt_row_topk_error_string": (ctypes.c_char_p, [_I]),
}

_lib = None


def load_kernel():
    """Build (at first use) and load the kernel's library; once loaded, it
    is returned at once."""
    global _lib
    if _lib is None:
        _lib = load_cuda_library("row_topk", SIGNATURES)
    return _lib


def _check(scores, k: int) -> None:
    if scores.ndim != 2 or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError(f"scores must be contiguous f32[R, C], got {scores.dtype}{tuple(scores.shape)}")
    if not 1 <= k <= min(scores.shape[1], K_MAX):
        raise ValueError(f"k must be in [1, min(C, {K_MAX})] = [1, {min(scores.shape[1], K_MAX)}], got {k}")
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_top_k takes cpu or cuda tensors, got {scores.device}")


def row_top_k(scores, k: int):
    """The ``k`` largest of each row of ``scores`` (f32 [R, C]), best first,
    ties to the lower column: (values f32 [R, k], columns int64 [R, k])."""
    _check(scores, k)
    if scores.device.type == "cpu":
        return top_k(scores, k)
    R, C = scores.shape
    dev = scores.device
    out_v = torch.empty((R, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((R, k), dtype=torch.int64, device=dev)
    if R == 0:
        return out_v, out_i
    lib = load_kernel()
    err = lib.gt_row_topk(
        scores.data_ptr(), R, C, k, out_v.data_ptr(), out_i.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"row_top_k launch failed: {lib.gt_row_topk_error_string(err).decode()}")
    row_top_k.launches += 1
    return out_v, out_i


row_top_k.launches = 0
