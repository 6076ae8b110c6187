"""Tracing and profiling hooks (port of ``granne_tpu/utils/trace.py``).

A span annotates a region in the profiler's trace
(``torch.profiler.record_function``) and, once CUDA is initialised, as an
NVTX range; a timer registry collects each span's wall time and count for
programmatic inspection.

Usage:
    from granne_tpu_torch.utils import trace
    with trace.span("build/insert_wave"):
        ...
    trace.start_profiler("profile_dir")   # a Chrome trace for TensorBoard or Perfetto
    ...
    trace.stop_profiler()
    print(trace.summary())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_profiler = None


@contextlib.contextmanager
def span(name: str, block: bool = False):
    """Time a region and annotate it in the trace.

    ``block=True`` waits for the current CUDA device to finish
    (``torch.cuda.synchronize``) before the clock stops, so the recorded
    time includes the device work launched in the region.  Before CUDA is
    initialised no device work can be pending, and nothing is waited for.
    """
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            try:
                if block and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            finally:
                _times[name] += time.perf_counter() - t0
                _counts[name] += 1
                if nvtx:
                    torch.cuda.nvtx.range_pop()


def summary() -> dict:
    return {
        name: {"total_s": round(_times[name], 4), "count": _counts[name]}
        for name in sorted(_times)
    }


def reset() -> None:
    _times.clear()
    _counts.clear()


def start_profiler(logdir: str) -> None:
    """Start ``torch.profiler.profile`` over the CPU, and CUDA where a card
    is present.  ``stop_profiler`` writes its trace into ``logdir`` through
    ``tensorboard_trace_handler``: one Chrome-trace JSON file
    (``*.pt.trace.json``), which TensorBoard's profiler plugin and Perfetto
    read."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("the profiler is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    )
    prof.start()
    _profiler = prof


def stop_profiler() -> None:
    """Stop the profiler ``start_profiler`` started and write its trace."""
    global _profiler
    prof, _profiler = _profiler, None
    if prof is None:
        raise RuntimeError("the profiler is not running")
    prof.stop()
