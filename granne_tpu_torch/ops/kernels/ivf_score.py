"""K3, K4, K5: IVF slot scoring and fused scoring + per-row top-k, and the
pair store the grouped search runs.

Replace the Pallas TPU kernels of ``granne_tpu/ops/pallas/ivf_score.py``:
``ivf_score_slots`` (K3), ``ivf_score_slots_grouped`` (K4) and
``ivf_score_topk`` (K5).  The CUDA kernel is
``granne_tpu_torch/csrc/ivf_score.cu`` (its header says what bounds each
kernel on the H100 and how the design answers that): K3 and K4 are one
tensor-core body fed by bulk copies, with the slot group G as a parameter
(G = 1 for K3); K5 is the same body with a running per-row top-k in its
epilogue, one slot per thread block.

``ivf_score_pairs`` is a third output kind of that body, with no Pallas
counterpart: K4's scores (K3's at ``group`` 1), each times its block row's
scale and -inf where the row's id is negative, written straight into the
merge's [pairs, L] rows, the row of slot ``s``'s place ``c`` being
``slot_pairs[s, c]``; empty places write nothing, and every other row of
the caller's buffer keeps what it held (``index/ivf.py::search_probed``
fills it with -inf).  Its plain version is K3/K4's followed by the scale,
the mask and the scatter of each place's row to its pair; the kernel gives
the same bits (the scale is one f32 multiply after the sum).

Unlike the Pallas kernels, blocks may be bf16, f32 or int8 for every one of
them (each element is rounded to bf16 as the JAX einsum does), any ``d``
works (the ``d % 128`` gate of ``index/ivf.py`` is a Mosaic rule), and S is
never padded to a multiple of G.  ``qg`` is bf16, as the JAX callers cast it.

Each public function runs its plain PyTorch version (``*_reference``) for
CPU tensors and the kernel for CUDA tensors; for a CUDA tensor it launches
the kernel or raises.  ``<function>.launches`` counts kernel launches.

A launch is capture-safe: the library is loaded once per process, the
outputs come from ``torch.empty`` (K5 writes every output column) or are
the caller's (the pair store), and the kernel goes to
``torch.cuda.current_stream()`` with no host synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from ..topk import top_k
from .build import load_cuda_library

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "gt_ivf_score_slots": (
        _I,
        [
            _P, _I, _LL, _I, _I,  # blocks, dtype, k, L, d
            _P, _I, _P, _I, _I,  # slot_keys, S, qg, cap, group
            _P, _I, _P,  # out, device, stream
        ],
    ),
    "gt_ivf_score_topk": (
        _I,
        [
            _P, _I, _LL, _I, _I,  # blocks, dtype, k, L, d
            _P, _P,  # block_ids, block_scales
            _P, _I, _P, _I, _I,  # slot_keys, S, qg, cap, group
            _I, _I, _P, _P,  # kp, k_out, out_v, out_i
            _I, _P,  # device, stream
        ],
    ),
    "gt_ivf_score_pairs": (
        _I,
        [
            _P, _I, _LL, _I, _I,  # blocks, dtype, k, L, d
            _P, _P,  # block_ids, block_scales
            _P, _I, _P, _I, _I,  # slot_keys, S, qg, cap, group
            _P, _P,  # slot_pairs, out
            _I, _P,  # device, stream
        ],
    ),
    "gt_ivf_cuda_error_string": (ctypes.c_char_p, [_I]),
}


_lib = None


def load_kernel():
    """Build (at first use) and load the kernels' library; once loaded, it
    is returned at once."""
    global _lib
    if _lib is None:
        _lib = load_cuda_library("ivf_score", SIGNATURES)
    return _lib


def _check(blocks, slot_keys, qg) -> None:
    if blocks.ndim != 3 or blocks.dtype not in _DTYPE_CODES or not blocks.is_contiguous():
        raise ValueError(f"blocks must be contiguous bf16|f32|i8[k, L, d], got {blocks.dtype}{tuple(blocks.shape)}")
    if slot_keys.ndim != 1 or slot_keys.dtype != torch.int32 or not slot_keys.is_contiguous():
        raise ValueError(f"slot_keys must be contiguous int32[S], got {slot_keys.dtype}{tuple(slot_keys.shape)}")
    S, d = slot_keys.shape[0], blocks.shape[2]
    if qg.ndim != 3 or qg.shape[0] != S or qg.shape[2] != d or qg.dtype != torch.bfloat16 or not qg.is_contiguous():
        raise ValueError(f"qg must be contiguous bf16[{S}, cap, {d}], got {qg.dtype}{tuple(qg.shape)}")
    if not (blocks.device == slot_keys.device == qg.device):
        raise ValueError(f"tensors on different devices: {blocks.device}, {slot_keys.device}, {qg.device}")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"IVF scoring takes cpu or cuda tensors, got {blocks.device}")


def _check_cols(blocks, block_ids, block_scales) -> None:
    k, L = blocks.shape[:2]
    if block_ids.shape != (k, L) or block_ids.dtype != torch.int32 or not block_ids.is_contiguous():
        raise ValueError(f"block_ids must be contiguous int32[{k}, {L}], got {block_ids.dtype}{tuple(block_ids.shape)}")
    if block_scales.shape != (k, L) or block_scales.dtype != torch.float32 or not block_scales.is_contiguous():
        raise ValueError(
            f"block_scales must be contiguous f32[{k}, {L}], got {block_scales.dtype}{tuple(block_scales.shape)}"
        )
    if not (blocks.device == block_ids.device == block_scales.device):
        raise ValueError("blocks, block_ids and block_scales on different devices")


def _gather_bf16(blocks, slot_keys):
    """The slots' blocks rounded to bf16, as f32 [S, L, d] (clamped keys)."""
    keys = slot_keys.long().clamp(0, blocks.shape[0] - 1)
    return blocks.index_select(0, keys).to(torch.bfloat16).to(torch.float32)


def ivf_score_slots_reference(blocks, slot_keys, qg):
    """Plain PyTorch version of K3/K4: gather, bf16 rounding, f32 contraction."""
    return torch.bmm(qg.to(torch.float32), _gather_bf16(blocks, slot_keys).transpose(1, 2))


def ivf_score_topk_reference(blocks, block_ids, block_scales, slot_keys, qg, *, k_out: int):
    """Plain PyTorch version of K5: scores, scale, mask, then a stable
    descending sort, so equal scores keep the lower column first."""
    S, cap = qg.shape[:2]
    L = blocks.shape[1]
    keys = slot_keys.long().clamp(0, blocks.shape[0] - 1)
    ids_g = block_ids.index_select(0, keys)  # [S, L]
    scores = ivf_score_slots_reference(blocks, slot_keys, qg) * block_scales.index_select(0, keys)[:, None, :]
    scores = torch.where((ids_g >= 0)[:, None, :], scores, -torch.inf)
    kp = min(k_out, L)
    vals, pos = top_k(scores, kp)
    ids = torch.gather(ids_g[:, None, :].expand(S, cap, L), 2, pos)
    ids = torch.where(vals > -torch.inf, ids, -1)
    out_v = torch.full((S, cap, k_out), -torch.inf, dtype=torch.float32, device=qg.device)
    out_i = torch.full((S, cap, k_out), -1, dtype=torch.int32, device=qg.device)
    out_v[:, :, :kp] = vals
    out_i[:, :, :kp] = ids
    return out_v, out_i


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("blocks, qg, block_ids and block_scales must start on 16-byte boundaries")


def launch_scores(lib, blocks, slot_keys, qg, group: int):
    """K3 (``group`` 1) or K4 from ``lib`` on checked CUDA tensors: the
    scores, uncounted."""
    k, L, d = blocks.shape
    S, cap, _ = qg.shape
    out = torch.empty((S, cap, L), dtype=torch.float32, device=blocks.device)
    if out.numel() == 0:
        return out
    _aligned(blocks, qg)
    stream = torch.cuda.current_stream(blocks.device)
    err = lib.gt_ivf_score_slots(
        blocks.data_ptr(), _DTYPE_CODES[blocks.dtype], k, L, d,
        slot_keys.data_ptr(), S, qg.data_ptr(), cap, group,
        out.data_ptr(), blocks.device.index, stream.cuda_stream,
    )
    if err:
        raise RuntimeError(f"IVF slot scoring launch failed: {lib.gt_ivf_cuda_error_string(err).decode()}")
    return out


def ivf_score_slots(blocks, slot_keys, qg):
    """K3: f32[S, cap, L] raw dot scores, one slot per thread block.

    blocks: bf16|f32|i8[k, L, d]; slot_keys: int32[S] block of each slot
    (clamped into [0, k)); qg: bf16[S, cap, d] each slot's query group.
    """
    _check(blocks, slot_keys, qg)
    if blocks.device.type == "cpu":
        return ivf_score_slots_reference(blocks, slot_keys, qg)
    out = launch_scores(load_kernel(), blocks, slot_keys, qg, 1)
    ivf_score_slots.launches += 1
    return out


def ivf_score_slots_grouped(blocks, slot_keys, qg, *, group: int = 8):
    """K4: K3's result with ``group`` consecutive slots per thread block,
    the next item's copy in flight while the current one is scored; K3 and
    K4 give equal scores bit for bit."""
    _check(blocks, slot_keys, qg)
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if blocks.device.type == "cpu":
        return ivf_score_slots_reference(blocks, slot_keys, qg)
    out = launch_scores(load_kernel(), blocks, slot_keys, qg, group)
    ivf_score_slots_grouped.launches += 1
    return out


def _check_pairs(blocks, slot_keys, qg, slot_pairs, out) -> None:
    S, cap = qg.shape[:2]
    if slot_pairs.shape != (S, cap) or slot_pairs.dtype != torch.int32 or not slot_pairs.is_contiguous():
        raise ValueError(
            f"slot_pairs must be contiguous int32[{S}, {cap}], got {slot_pairs.dtype}{tuple(slot_pairs.shape)}"
        )
    L = blocks.shape[1]
    if out.ndim != 2 or out.shape[1] != L or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out must be contiguous f32[P, {L}], got {out.dtype}{tuple(out.shape)}")
    if not (blocks.device == slot_pairs.device == out.device):
        raise ValueError("blocks, slot_pairs and out on different devices")


def ivf_score_pairs_reference(blocks, block_ids, block_scales, slot_keys, qg, slot_pairs, out):
    """Plain PyTorch version of the pair store: K3/K4's scores times each
    slot's block row scales, -inf where the block's id is negative, and each
    place's row written to ``out[slot_pairs[s, c]]`` where that is not -1;
    ``out`` (f32 [P, L]) is returned.  No host synchronisation, so a CUDA
    graph can capture it: the empty places' rows go to a spare row past
    ``out``'s."""
    keys = slot_keys.long().clamp(0, blocks.shape[0] - 1)
    scores = ivf_score_slots_reference(blocks, slot_keys, qg) * block_scales[keys][:, None, :]
    scores = torch.where((block_ids[keys] >= 0)[:, None, :], scores, -torch.inf)
    P, L = out.shape
    rows = torch.cat([out, out.new_empty((1, L))])
    rows.index_copy_(0, torch.where(slot_pairs >= 0, slot_pairs, P).reshape(-1).long(), scores.reshape(-1, L))
    return out.copy_(rows[:P])


def launch_pairs(lib, blocks, block_ids, block_scales, slot_keys, qg, slot_pairs, out, group: int):
    """The pair store from ``lib`` on checked CUDA tensors, into ``out``,
    uncounted."""
    k, L, d = blocks.shape
    S, cap, _ = qg.shape
    if S == 0 or cap == 0 or L == 0 or out.shape[0] == 0:
        return out
    _aligned(blocks, qg, block_ids, block_scales)
    if out.data_ptr() % 8:  # float2 stores
        raise ValueError("out must start on an 8-byte boundary")
    stream = torch.cuda.current_stream(blocks.device)
    err = lib.gt_ivf_score_pairs(
        blocks.data_ptr(), _DTYPE_CODES[blocks.dtype], k, L, d,
        block_ids.data_ptr(), block_scales.data_ptr(),
        slot_keys.data_ptr(), S, qg.data_ptr(), cap, group,
        slot_pairs.data_ptr(), out.data_ptr(), blocks.device.index, stream.cuda_stream,
    )
    if err:
        raise RuntimeError(f"ivf_score_pairs launch failed: {lib.gt_ivf_cuda_error_string(err).decode()}")
    return out


def ivf_score_pairs(blocks, block_ids, block_scales, slot_keys, qg, slot_pairs, out, *, group: int = 8):
    """The pair store: K4's scores (``group`` slots per thread block; K3's
    at 1) times ``block_scales``, -inf where ``block_ids < 0``, each
    place's row written into ``out`` (f32 [P, L]) at row ``slot_pairs[s,
    c]`` (int32 [S, cap]; -1 marks an empty place, every other value is
    below P).  Every other row of ``out`` keeps what it held; a pair held
    by two places is written by both.  On the card ``out`` starts on an
    8-byte boundary.  Returns ``out``.
    """
    _check(blocks, slot_keys, qg)
    _check_cols(blocks, block_ids, block_scales)
    _check_pairs(blocks, slot_keys, qg, slot_pairs, out)
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if blocks.device.type == "cpu":
        return ivf_score_pairs_reference(blocks, block_ids, block_scales, slot_keys, qg, slot_pairs, out)
    launch_pairs(load_kernel(), blocks, block_ids, block_scales, slot_keys, qg, slot_pairs, out, group)
    ivf_score_pairs.launches += 1
    return out


def launch_topk(lib, blocks, block_ids, block_scales, slot_keys, qg, k_out: int, *, prefill: bool = False):
    """K5 from ``lib`` on checked CUDA tensors: (vals, ids), uncounted.
    ``prefill`` fills the outputs with (-inf, -1) first, as a library that
    writes only the first K' columns needs."""
    k, L, d = blocks.shape
    S, cap, _ = qg.shape
    dev = blocks.device
    if prefill or L == 0:
        out_v = torch.full((S, cap, k_out), -torch.inf, dtype=torch.float32, device=dev)
        out_i = torch.full((S, cap, k_out), -1, dtype=torch.int32, device=dev)
    else:
        out_v = torch.empty((S, cap, k_out), dtype=torch.float32, device=dev)
        out_i = torch.empty((S, cap, k_out), dtype=torch.int32, device=dev)
    if out_v.numel() == 0 or L == 0:
        return out_v, out_i
    _aligned(blocks, qg, block_ids, block_scales)
    stream = torch.cuda.current_stream(dev)
    err = lib.gt_ivf_score_topk(
        blocks.data_ptr(), _DTYPE_CODES[blocks.dtype], k, L, d,
        block_ids.data_ptr(), block_scales.data_ptr(),
        slot_keys.data_ptr(), S, qg.data_ptr(), cap, 1,
        min(k_out, L), k_out, out_v.data_ptr(), out_i.data_ptr(),
        dev.index, stream.cuda_stream,
    )
    if err:
        raise RuntimeError(f"ivf_score_topk launch failed: {lib.gt_ivf_cuda_error_string(err).decode()}")
    return out_v, out_i


def ivf_score_topk(blocks, block_ids, block_scales, slot_keys, qg, *, k_out: int):
    """K5: fused scoring + per-(slot, row) top-k.

    Scores are multiplied by ``block_scales`` and set to -inf where
    ``block_ids < 0``; each (slot, query row) keeps its K' = min(k_out, L)
    best, ties to the lower column.  Returns (vals f32[S, cap, k_out],
    ids int32[S, cap, k_out]) with (-inf, -1) padding and ids -1 wherever
    the value is -inf.  One slot per thread block, as the Pallas kernel
    has one slot per grid step.
    """
    _check(blocks, slot_keys, qg)
    _check_cols(blocks, block_ids, block_scales)
    if k_out < 1:
        raise ValueError(f"k_out must be >= 1, got {k_out}")
    if blocks.device.type == "cpu":
        return ivf_score_topk_reference(blocks, block_ids, block_scales, slot_keys, qg, k_out=k_out)
    out = launch_topk(load_kernel(), blocks, block_ids, block_scales, slot_keys, qg, k_out)
    ivf_score_topk.launches += 1
    return out


ivf_score_slots.launches = 0
ivf_score_slots_grouped.launches = 0
ivf_score_topk.launches = 0
ivf_score_pairs.launches = 0
