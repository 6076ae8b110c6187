"""Peaks of the device and the least time a kernel's work can take.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W
limit); a card set to a lower power limit runs below them, so every result
line carries the card's limit.  ``bound`` is ``chip_smoke.py::bound``'s
arithmetic: the larger of bytes over HBM bandwidth and operations over the
bf16 tensor-core rate.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12},
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}: add the card's data-sheet rates to harness/roofline.py")
    return PEAKS[kind]


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations", whichever bounds it)."""
    p = peaks(kind)
    t_bytes, t_ops = nbytes / p["hbm_bytes_per_s"], flops / p["bf16_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slot_score_work(queries: int, nprobe: int, blocks_touched: int, L: int, d: int, k: int,
                    elem_bytes: int = 2) -> tuple[float, float]:
    """(bytes, operations) that scoring ``queries`` queries against their
    ``nprobe`` probed blocks of ``L`` rows of ``d`` lanes needs, whatever
    kernel does it: each of the ``blocks_touched`` distinct blocks read once
    (``elem_bytes`` a lane), each query read once in bf16, and each probed
    block's best ``k`` (an f32 score and an int32 id) written once for the
    merge; a multiply and an add per lane of every (query, probed row) pair."""
    nbytes = blocks_touched * L * d * elem_bytes + queries * d * 2 + queries * nprobe * k * 8
    flops = 2.0 * queries * nprobe * L * d
    return float(nbytes), flops
