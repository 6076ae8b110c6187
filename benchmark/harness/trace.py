"""The device trace of a ``--trace 1`` window, reduced to what the metrics read.

The measured window is profiled for device activity alone (kernels, copies,
fills): recording every CPU op would slow the host that launches the work,
and the idle share would read the profiler's own cost.  Its length is the
host's clock around the body.  A second, shorter pass after the window is
profiled with CPU ops too, and only names the device's idle gaps by the
innermost host op running at each gap's middle; there the window is a
``record_function`` span (``WINDOW``) on the profiler's clock.  The
reduction is ``chip_smoke.py::hnsw_profile``'s method (device events summed,
span annotations on the device track left out), plus the union of the device
intervals for the busy time.
"""

from __future__ import annotations

import contextlib
import time
import types
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "bench/window"
NO_HOST_OP = "_no_host_op_running_"
TOP = 10
NAMING_S = 2.0  # seconds of the pass that names idle gaps


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int  # kernel launches that ran on the device in the window
    device_ops: int  # kernels, copies and fills
    op_seconds: dict = field(default_factory=dict)  # device op name -> seconds in the window
    op_counts: dict = field(default_factory=dict)
    gap_seconds: dict = field(default_factory=dict)  # host op name -> device idle seconds (host ops profiled)

    def seconds_of(self, name_part: str) -> float:
        """Device seconds of the ops whose name holds ``name_part``."""
        return sum(s for n, s in self.op_seconds.items() if name_part in n)

    def count_of(self, name_part: str) -> int:
        return sum(c for n, c in self.op_counts.items() if name_part in n)

    def breakdown(self, named: "TraceSummary | None" = None) -> dict:
        """The device ops that took most time, and the longest idle gaps by
        host op (from ``named``, the pass with host ops, where given)."""
        top = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(self.op_seconds), "idle_gaps": top((named or self).gap_seconds)}


@contextlib.contextmanager
def profiled(enabled: bool, host_ops: bool = False):
    """Profile the body when ``enabled``: its device activity, and CPU ops
    only with ``host_ops`` (or where there is no CUDA to profile).  Yields a
    holder whose ``summary`` is set after the body, or left None."""
    holder = types.SimpleNamespace(summary=None)
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host_ops or not acts:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield holder
        window_s = time.perf_counter() - start
    holder.summary = summarize(raw_events(prof), window_s)


def raw_events(prof) -> list[tuple]:
    """(name, is_device, is_annotation, is_kernel, thread, start_ns, end_ns)
    of every event, read from kineto's own list (building the profiler's
    Python event objects for millions of events would take minutes)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        name = e.name()
        # copies and fills are device ops but not kernels (not every torch's
        # events say their activity type, so the name decides)
        out.append((name, dev, e.is_user_annotation(), dev and not name.startswith(("Memcpy", "Memset")),
                    e.start_thread_id(), e.start_ns(), e.end_ns()))
    return out


def summarize(events: list[tuple], window_s: float | None = None) -> TraceSummary:
    """Reduce the window's events.  Where the trace holds the ``WINDOW``
    span (host ops profiled) it bounds the window and idle gaps are named;
    otherwise the device events are the window's own and ``window_s``, the
    host's clock around the body, is its length."""
    win = [e for e in events if e[0] == WINDOW and not e[1]]
    dev_ev = [e for e in events if e[1] and not e[2]]
    if win:
        _, _, _, _, thread, w0, w1 = win[0]
    elif window_s is not None:
        thread = None
        w0 = min((e[5] for e in dev_ev), default=0)
        w1 = max((e[6] for e in dev_ev), default=w0)
    else:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span and no window length was given")
    op_s, op_n = defaultdict(float), defaultdict(int)
    starts, ends, kernels = [], [], 0
    for name, _, _, kern, _, s, t in dev_ev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        starts.append(s)
        ends.append(t)
        op_s[name[:96]] += (t - s) / 1e9
        op_n[name[:96]] += 1
        kernels += kern
    gaps = idle_gaps(np.asarray(starts, np.int64), np.asarray(ends, np.int64), w0, w1)
    busy_ns = (w1 - w0) - sum(b - a for a, b in gaps)
    gap_s = defaultdict(float)
    if win:
        host = sorted(((s, t, name) for name, dev, ann, _, th, s, t in events
                       if not dev and th == thread and name != WINDOW and t > w0 and s < w1),
                      key=lambda e: (e[0], -e[1]))
        for (a, b), name in zip(gaps, name_gaps(gaps, host)):
            gap_s[name] += (b - a) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9 if win else window_s, busy_s=busy_ns / 1e9, kernels=kernels,
        device_ops=len(starts), op_seconds=dict(op_s), op_counts=dict(op_n), gap_seconds=dict(gap_s),
    )


def idle_gaps(starts: np.ndarray, ends: np.ndarray, w0: int, w1: int) -> list[tuple[int, int]]:
    """The intervals of [w0, w1] that no device interval covers."""
    if starts.size == 0:
        return [(w0, w1)]
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    lo = np.concatenate([[w0], e])
    hi = np.concatenate([s, [w1]])
    keep = hi > lo
    return list(zip(lo[keep].tolist(), hi[keep].tolist()))


def name_gaps(gaps: list[tuple[int, int]], host: list[tuple[int, int, str]]) -> list[str]:
    """The innermost host op running at the middle of each gap (gaps in
    time order; ``host`` sorted by start, outer ops first on ties)."""
    names, stack, i = [], [], 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names.append(stack[-1][2] if stack else NO_HOST_OP)
    return names
