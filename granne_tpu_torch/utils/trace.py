"""Tracing and profiling hooks (port of ``granne_tpu/utils/trace.py``).

A span annotates a region in the profiler's trace
(``torch.profiler.record_function``, while a profiler records) and, once
CUDA is initialised, as an NVTX range; a timer registry collects each
span's wall time and count for programmatic inspection.

While a ``torch.profiler`` runs (``recording()``), a span on a CUDA
device also times the device: a pair of CUDA events on the current stream
at its entry and exit, resolved by ``summary()`` into the span's
``device_s`` (the stream's time between the two, idle included), and
``count(name, value)`` adds to a counter.  Off the recording a span
opens no ``record_function`` (no torch profiler runs to record it, and
it costs ~10 us), and ``count`` does nothing.

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
import threading
import time
from collections import defaultdict

import torch

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_device: dict[str, float] = defaultdict(float)  # span name -> device seconds of resolved event pairs
_counters: dict = {}  # counter name -> int, or a 0-d device tensor summed without a sync
_pending: list[tuple] = []  # (name, device index, start event, end event) not yet resolved
_free: dict[int, list] = defaultdict(list)  # resolved events, by device index, for reuse
_lock = threading.Lock()
_DRAIN_AT = 1024  # pending pairs past which a span's exit resolves the finished ones (no wait)
_profiler = None


def recording() -> bool:
    """Whether a ``torch.profiler`` is running (any profile start sets the
    flag): spans then time the device and counters count."""
    return torch.autograd.profiler._is_profiler_enabled


def _event_pair(name: str) -> tuple:
    dev = torch.cuda.current_device()
    with _lock:
        free = _free[dev]
        start, end = (free.pop() if free else torch.cuda.Event(enable_timing=True) for _ in range(2))
    return name, dev, start, end


def _resolve(wait: bool) -> None:
    """Fold pending event pairs into ``_device``: all of them after one
    synchronize of each device they ran on (``wait``), else those already
    finished."""
    with _lock:
        if wait:
            for dev in {p[1] for p in _pending}:
                torch.cuda.synchronize(dev)
        keep = []
        for pair in _pending:
            name, dev, start, end = pair
            if wait or end.query():
                _device[name] += start.elapsed_time(end) / 1e3
                _free[dev] += [start, end]
            else:
                keep.append(pair)
        _pending[:] = keep


@contextlib.contextmanager
def span(name: str, block: bool = False):
    """Time a region and annotate it in the trace.

    ``block=True`` waits for the current CUDA device to finish
    (``torch.cuda.synchronize``) before the clock stops, so the recorded
    time includes the device work launched in the region.  Before CUDA is
    initialised no device work can be pending, and nothing is waited for.
    While ``recording()`` the region is a ``record_function`` range, and
    CUDA events on the current stream time it on the device, with no wait.
    """
    nvtx = torch.cuda.is_initialized()
    rec = recording()
    pair = _event_pair(name) if nvtx and rec else None
    with torch.profiler.record_function(name) if rec else contextlib.nullcontext():
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        if pair:
            pair[2].record()
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
                if pair:
                    pair[3].record()
                    with _lock:
                        _pending.append(pair)
                    if len(_pending) > _DRAIN_AT:
                        _resolve(wait=False)
                if nvtx:
                    torch.cuda.nvtx.range_pop()


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor added on its device without a
    sync) to the counter ``name``; nothing unless ``recording()``.  A
    caller that has to compute the value checks ``recording()`` first."""
    if recording():
        with _lock:
            _counters[name] = _counters.get(name, 0) + value


def summary() -> dict:
    """Each span's ``total_s`` (host clock) and ``count``, with ``device_s``
    where it was timed on the device, and each counter's ``total``."""
    _resolve(wait=True)
    out = {}
    for name in sorted(_times):
        out[name] = {"total_s": round(_times[name], 4), "count": _counts[name]}
        if name in _device:
            out[name]["device_s"] = _device[name]
    for name in sorted(_counters):
        out[name] = {"total": int(_counters[name])}
    return out


def reset() -> None:
    with _lock:
        _times.clear()
        _counts.clear()
        _device.clear()
        _counters.clear()
        for _, dev, start, end in _pending:
            _free[dev] += [start, end]
        _pending.clear()


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
