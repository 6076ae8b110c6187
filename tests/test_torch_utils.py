"""granne_tpu_torch's ``utils`` (``progress.ProgressBar``, ``trace``) against
granne_tpu's, and the one-device build's progress bars and wave spans."""

import io
import json
import math
import time

import numpy as np
import pytest
import torch

from granne_tpu.utils import progress as jprogress
from granne_tpu.utils import trace as jtrace
from granne_tpu_torch import AngularVectors, BuildConfig, build_layers
from granne_tpu_torch.index.builder import _wave_ranges
from granne_tpu_torch.utils import progress, trace


@pytest.fixture
def clock(monkeypatch):
    """A settable ``time.time``, which both packages' bars read."""
    now = [100.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


# (seconds since the bar was made, call, argument); None: finish()
STEPS = [(0.1, "add", 3), (0.2, "add", 5), (0.5, "add", 10), (0.6, "set", 40), (0.61, "add", 1),
         (0.9, "add", 0), (2.0, "set", 120), (2.5, None, None)]


@pytest.mark.parametrize("total,prefix", [(100, "insert "), (0, ""), (7, "reinsert ")])
def test_progress_bar_writes_jax_bytes(clock, total, prefix):
    """The same ``add``/``set``/``finish`` sequence under the same clock
    writes the same bytes: the 0.25 s throttle, the bar, rate and ETA."""
    streams = []
    for cls in (jprogress.ProgressBar, progress.ProgressBar):
        clock[0] = 100.0
        stream = io.StringIO()
        bar = cls(total, prefix=prefix, stream=stream)
        for t, call, arg in STEPS:
            clock[0] = 100.0 + t
            bar.finish() if call is None else getattr(bar, call)(arg)
        streams.append(stream.getvalue())
    assert streams[1] == streams[0]
    assert streams[1].endswith("\n") and f"\r{prefix}[" in streams[1]


def test_span_counts_totals_and_summary_shape():
    """Counts and wall totals per name, the body's exception passes through
    and is still counted, ``block=True`` runs on the CPU, and ``summary()``
    has JAX's shape and counts; ``reset()`` clears it."""
    names = ["a/x", "b", "a/x", "b", "a/x"]
    for mod in (jtrace, trace):
        mod.reset()
        for name in names:
            with mod.span(name, block=name == "b"):
                pass
        with pytest.raises(KeyError):
            with mod.span("raises"):
                raise KeyError("x")
    with trace.span("slept"):
        time.sleep(0.02)
    mine, want = trace.summary(), jtrace.summary()
    assert mine.pop("slept")["total_s"] >= 0.02
    assert list(mine) == list(want) == ["a/x", "b", "raises"]
    for name in want:
        assert set(mine[name]) == set(want[name]) == {"total_s", "count"}
        assert mine[name]["count"] == want[name]["count"]
        assert isinstance(mine[name]["total_s"], float) and mine[name]["total_s"] >= 0
    trace.reset()
    jtrace.reset()
    assert trace.summary() == {}


def test_profiler_writes_a_trace_naming_a_span(tmp_path):
    trace.start_profiler(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        trace.start_profiler(str(tmp_path))
    with trace.span("test/profiled_span"):
        torch.ones(64).sum()
    trace.stop_profiler()
    with pytest.raises(RuntimeError, match="not running"):
        trace.stop_profiler()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "test/profiled_span" for e in events)
    trace.reset()


def test_show_progress_build_reports_on_stderr_and_spans_every_wave(capsys):
    """A ``show_progress`` build draws an ``insert`` and a ``reinsert`` bar a
    layer on stderr, writes nothing to stdout, and opens one span a wave:
    the insert waves of ``_wave_ranges`` and the reinsert waves of every
    layer."""
    vecs = np.random.default_rng(3).standard_normal((300, 8)).astype(np.float32)
    cfg = BuildConfig(num_neighbors=8, max_search=16, wave_size=32, layer_multiplier=8.0, show_progress=True)
    trace.reset()
    stack = build_layers(AngularVectors.from_raw(vecs, device="cpu"), cfg)
    out, err = capsys.readouterr()
    assert out == ""
    counts = (0, *stack.counts)
    assert err.count("\rinsert [") >= len(stack) and err.count("\rreinsert [") >= len(stack)
    assert err.count("building layer") == len(stack) and err.count("\n") == 3 * len(stack)
    spans = trace.summary()
    inserts = sum(len(list(_wave_ranges(lo, hi, cfg.wave_size))) for lo, hi in zip(counts, counts[1:]))
    reinserts = sum(math.ceil(c / cfg.wave_size) for c in stack.counts)
    assert spans["build/insert_wave"]["count"] == inserts
    assert spans["build/reinsert_wave"]["count"] == reinserts
    trace.reset()


def test_counters_and_device_time_only_while_recording():
    """Off a profiler ``count`` leaves nothing and a span has no
    ``device_s``; under one (CPU here: no CUDA events) ints and tensors add
    up, ``summary()`` lists each counter as ``{"total": n}`` after the
    spans, and ``reset()`` clears counters too."""
    trace.reset()
    assert not trace.recording()
    trace.count("test/c", 3)
    with trace.span("test/s"):
        pass
    assert trace.summary() == {"test/s": {"total_s": pytest.approx(0, abs=1e-3), "count": 1}}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.recording()
        with trace.span("test/s"):
            trace.count("test/c", 3)
            trace.count("test/c", torch.tensor(4))
            trace.count("test/d", torch.tensor([1, 0, 1]).sum())
    got = trace.summary()
    assert list(got) == ["test/s", "test/c", "test/d"]
    assert got["test/c"] == {"total": 7} and got["test/d"] == {"total": 2}
    assert set(got["test/s"]) == {"total_s", "count"} and got["test/s"]["count"] == 2
    trace.reset()
    assert trace.summary() == {}


def test_count_adds_a_tensor_without_reading_it(monkeypatch):
    """A tensor given to ``count`` is added where it lives: nothing reads
    its value on the host (which would wait for its device) until
    ``summary()``."""
    def read(*_):
        raise AssertionError("count read a tensor's value on the host")

    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with monkeypatch.context() as mp:
            for name in ("item", "tolist", "__int__", "__index__", "__bool__", "__float__", "cpu", "numpy"):
                mp.setattr(torch.Tensor, name, read)
            for v in (torch.tensor(5), 2, torch.tensor(6)):
                trace.count("test/t", v)
    assert trace.summary() == {"test/t": {"total": 13}}
    trace.reset()
