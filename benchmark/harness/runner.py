"""One run of one cell: set-up, the measured window, the check, the result line.

Order (the reference runs last, so its memory and time are the check's, not
the program's): set-up (data from the seed, the program's index, the
warm-up of the cell's shapes; ``setup_s`` runs from process start to here),
the window (with ``--trace 1`` profiled for device activity, then a short
pass profiled with host ops that names the idle gaps), the device's memory
peak, the program's state freed, then the reference and the comparison.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import checks, spec as specs, trace

JAX_NAMES = {"jax", "jaxlib", "flax", "granne_tpu"}


@dataclass
class Ctx:
    config: dict
    cell: dict
    seed: int
    seconds: float
    device: str
    control: dict | None = None  # a control in the program's place (limits.py): a cell's ``control``


@dataclass
class MetricCtx:
    """What a per-layer reader (``metrics/<name>.py``: ``read(m) -> float |
    None``) reads."""

    trace: trace.TraceSummary | None
    spans: dict  # granne_tpu_torch.utils.trace.summary() over the window
    counts: dict  # the traffic's counts: calls, queries, each call's pool batch, the work of each batch
    kind: str  # the device's name


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def jax_modules() -> list[str]:
    """Modules of JAX or the JAX package in this process, by whole top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in JAX_NAMES)


def card(count: int) -> dict:
    """The card's name, the cards used and the power limit (``nvidia-smi``;
    "not read" where it cannot say)."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": count, "power_limit": "not read"}
    limit = "not read"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or limit
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count, "power_limit": limit}


def clocks() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
                              "--format=csv,noheader", "-i", "0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(s: specs.Spec, seed: int, seconds: float, traced: bool, *, t0: float, device: str = "cuda",
             control: dict | None = None) -> dict:
    """Run ``s`` once; the result line as a dict (``checks`` last)."""
    from granne_tpu_torch.utils import trace as spans

    ctx = Ctx(s.config, s.cell, seed, seconds, device, control)
    traffic = specs.load_module("traffic", s.cell["traffic"]["kind"])
    system = specs.load_module("systems", s.config["system"])
    dev = card(s.chips)
    state = traffic.setup(ctx, system)
    setup_s = time.perf_counter() - t0
    log(f"{s.workload} seed={seed}: setup_s={setup_s} clocks (sm, mem, power, temp)={clocks()} "
        f"[{dev['kind']}, power limit {dev['power_limit']}]")
    spans.reset()
    with trace.profiled(traced) as prof:
        e2e = traffic.window(ctx, state)
    span_summary = spans.summary()
    log(f"window: {e2e} seconds={state.window_s} clocks={clocks()}")
    counts = traffic.counts(ctx, state) if traced else {}
    named = None
    if traced:  # its answers are judged with the window's; its rate is not a metric
        with trace.profiled(True, host_ops=True) as named:
            more = traffic.window(ctx, state, min(trace.NAMING_S, seconds))
        log(f"gap-naming pass, host ops profiled: {more} seconds={state.window_s}")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    traffic.release(state)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    tally, more, attempted, failed = traffic.judge(ctx, state)
    e2e.update(more, setup_s=setup_s)
    correct, shown = checks.judge(tally.numbers(), s.cell["limits"])

    dev["memory_peak_bytes"] = int(peak)
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if traced:
        m = MetricCtx(prof.summary, span_summary, counts, dev["kind"])
        metrics = {}
        for entry in s.per_layer:
            value = specs.load_metric(entry["name"]).read(m)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        if prof.summary is not None:
            dev.update(busy_s=prof.summary.busy_s, window_s=prof.summary.window_s)
    else:
        missing = [e["name"] for e in s.end_to_end if e["name"] not in e2e]
        if missing:
            raise RuntimeError(f"the {s.cell['traffic']['kind']} traffic gives no {missing}")
        metrics = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]} for e in s.end_to_end}
    result.update(metrics=metrics, device=dev)
    if traced and prof.summary is not None:
        result["breakdown"] = prof.summary.breakdown(named.summary)
    result["checks"] = shown
    return result
