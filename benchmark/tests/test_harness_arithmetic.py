"""The rate, recall, distance-gap, trace and roofline arithmetic on made-up inputs."""

import math

import pytest
import torch
from harness import checks, reference, roofline, spec, trace
from harness.runner import MetricCtx

H100 = "NVIDIA H100 80GB HBM3"


def unit(rows):
    return reference.normalize(torch.tensor(rows, dtype=torch.float32))


def test_tally_recall_gap_and_bad_rows():
    xn = unit([[1, 0], [0, 1], [1, 1], [1, -1], [-1, 0]])
    qn = unit([[1, 0.1], [0.1, 1]])
    gt, gd = reference.exact_topk(xn, qn, 2)
    t = checks.Tally(2)
    t.add(xn, qn, gt, gd, gt)
    assert t.recall == 1.0 and t.bad_rows == 0 and t.err_max < 1e-6
    # a distance off by 0.25 on one id, and a row with one of its two true ids
    ids = gt.clone()
    ids[1, 1] = 4
    dists = reference.id_dists(xn, qn, ids)
    dists[0, 1] += 0.25  # still ascending
    u = checks.Tally(2)
    u.add(xn, qn, ids, dists, gt)
    assert u.recall == pytest.approx(3 / 4)
    assert u.err_max == pytest.approx(0.25, abs=1e-6)
    n = u.numbers()
    assert n["recall_miss"] == pytest.approx(1 / 4) and n["bad_rows"] == u.bad_rows


@pytest.mark.parametrize("fault", ["out_of_range", "negative", "repeated", "nan", "descending"])
def test_bad_rows(fault):
    xn = unit([[1, 0], [0, 1], [1, 1]])
    qn = unit([[1, 0.2]])
    ids, dists = reference.exact_topk(xn, qn, 2)
    ids, dists = ids.clone(), dists.clone()
    if fault == "out_of_range":
        ids[0, 1] = 3
    elif fault == "negative":
        ids[0, 1] = -1
    elif fault == "repeated":
        ids[0, 1] = ids[0, 0]
    elif fault == "nan":
        dists[0, 1] = math.nan
    else:
        dists[0, 0] = dists[0, 1] + 0.1
    t = checks.Tally(2)
    t.add(xn, qn, ids, dists, ids)
    assert t.bad_rows == 1 and t.hits == 0


def test_judge():
    ok, shown = checks.judge({"dist_err": 0.1, "bad_rows": 0, "recall_miss": 0.2},
                             {"dist_err": 0.1, "bad_rows": 0, "recall_miss": 0.3})
    assert ok and shown["dist_err"] == {"value": 0.1, "limit": 0.1}
    assert list(shown) == ["dist_err", "bad_rows", "recall_miss"]
    assert not checks.judge({"bad_rows": 1}, {"bad_rows": 0})[0]
    with pytest.raises(KeyError):  # a cell states a limit for every number
        checks.judge({"dist_err": 0.1}, {})


def test_judge_answers_in_blocks(monkeypatch):
    monkeypatch.setattr(checks, "_ROWS", 3)
    g = torch.Generator().manual_seed(5)
    xn, qn = reference.normalize(torch.randn(50, 4, generator=g)), reference.normalize(torch.randn(8, 4, generator=g))
    gt, gd = reference.exact_topk(xn, qn, 5)
    rows = torch.tensor([7, 0, 3, 3, 1, 2, 6])
    t = checks.judge_answers(xn, qn, [(rows, gt[rows], gd[rows])], gt, 5, "f32")
    assert t.rows == 7 and t.recall == 1.0 and t.err_max < 1e-6


def test_gap_at_the_stated_precision():
    """A bf16 cell's distances are held to bf16 vectors summed in f32: the
    f32 distance reads a gap of bf16 rounding, the bf16 one none."""
    g = torch.Generator().manual_seed(9)
    xn, qn = reference.normalize(torch.randn(64, 100, generator=g)), reference.normalize(torch.randn(4, 100, generator=g))
    ids = torch.arange(40).reshape(4, 10)
    d32, d16 = reference.id_dists(xn, qn, ids), reference.id_dists(xn, qn, ids, "bf16")
    d16, order = torch.sort(d16, dim=1)
    ids16 = torch.gather(ids, 1, order)
    t = checks.Tally(10, "bf16")
    t.add(xn, qn, ids16, d16, ids16)
    assert t.err_max == 0.0 and t.bad_rows == 0
    gap = float((d32 - reference.id_dists(xn, qn, ids, "bf16")).abs().max())
    assert 1e-5 < gap < 1e-2


def test_bound_and_slot_score_work():
    nbytes, flops = roofline.slot_score_work(10_000, 16, 5_000, 256, 100, 10)
    assert nbytes == 5_000 * 256 * 100 * 2 + 10_000 * 100 * 2 + 10_000 * 16 * 10 * 8
    assert flops == 2.0 * 10_000 * 16 * 256 * 100
    t, by = roofline.bound(nbytes, flops, H100)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    t, by = roofline.bound(1.0, 989e12, H100)
    assert by == "operations" and t == pytest.approx(1.0)
    with pytest.raises(KeyError):
        roofline.peaks("some other card")


def events(kernels, host, window=(0, 1000)):
    """Made-up raw events: kernels [(name, s, t)], host ops [(name, s, t)]."""
    out = [(trace.WINDOW, False, True, False, 1, *window)]
    out += [(n, True, False, not n.startswith("Memcpy"), 0, s, t) for n, s, t in kernels]
    out += [(n, False, False, False, 1, s, t) for n, s, t in host]
    return out


def test_summarize_busy_gaps_and_names():
    ev = events(kernels=[("k1", 100, 200), ("k2", 150, 300), ("Memcpy HtoD", 500, 550), ("k1", 990, 1100)],
                host=[("outer", 0, 900), ("inner", 320, 480), ("late", 950, 1000)])
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((200 + 50 + 10) * 1e-9)
    assert s.kernels == 3 and s.device_ops == 4
    assert s.seconds_of("k1") == pytest.approx(110e-9) and s.count_of("k1") == 2
    assert s.gap_seconds["outer"] == pytest.approx((100 + 440) * 1e-9)  # [0,100) and [550,990)
    assert s.gap_seconds["inner"] == pytest.approx(200e-9)  # [300,500): its middle falls in "inner"
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k2" and len(b["idle_gaps"]) == 2


def test_device_only_trace_takes_the_hosts_window():
    """Without host ops (the measured window) the device events bound the
    trace, the host's clock gives the window, and no gap is named."""
    ev = events(kernels=[("k1", 100, 200), ("k2", 400, 450)], host=[])[1:]  # no WINDOW span
    s = trace.summarize(ev, window_s=1000e-9)
    assert s.window_s == pytest.approx(1000e-9) and s.busy_s == pytest.approx(150e-9)
    assert s.gap_seconds == {} and s.kernels == 2
    with pytest.raises(RuntimeError):
        trace.summarize(ev)
    named = trace.summarize(events(kernels=[("k1", 100, 200)], host=[("outer", 0, 900)]))
    b = s.breakdown(named)
    assert [n for n, _ in b["device_ops"]] == ["k1", "k2"] and b["idle_gaps"][0][0] == "outer"


@pytest.mark.parametrize("host_ops", [False, True])
def test_a_profiled_window_reduces(host_ops):
    """The profiler's own events through ``raw_events``: a CPU-only window
    has host ops and no device op, and the window is the host's clock."""
    with trace.profiled(True, host_ops=host_ops) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    s = prof.summary
    assert s.window_s > 0 and s.busy_s == 0 and s.device_ops == 0 and s.kernels == 0
    assert sum(s.gap_seconds.values()) == pytest.approx(s.window_s)


def test_summarize_no_device_ops_and_no_host_op():
    s = trace.summarize(events(kernels=[], host=[]))
    assert s.busy_s == 0 and s.gap_seconds == {trace.NO_HOST_OP: pytest.approx(1e-6)}


def metric(name, **kw):
    base = dict(trace=None, spans={}, counts={}, kind=H100)
    base.update(kw)
    return spec.load_metric(name).read(MetricCtx(**base))


def test_idle_launch_and_k1_readers():
    s = trace.summarize(events(kernels=[("nbr_score_kernel(Params)", 0, 250), ("elementwise", 300, 400)],
                               host=[]))
    counts = {"queries": 2000}
    assert metric("device_idle_pct.serve", trace=s) == pytest.approx(65.0)
    assert metric("device_idle_pct.serve") is None
    assert metric("launches_per_kq.hnsw_serve", trace=s, counts=counts) == pytest.approx(1.0)
    assert metric("nbr_score_ms_per_kq.hnsw_serve", trace=s, counts=counts) == pytest.approx(250e-9 * 1e3 / 2)
    no_k1 = trace.summarize(events(kernels=[("elementwise", 300, 400)], host=[]))
    assert metric("nbr_score_ms_per_kq.hnsw_serve", trace=no_k1, counts=counts) is None


def test_slot_score_roofline_reads_the_same_for_each_route():
    """The work comes from the inputs and the cell's shapes: K4's route
    (scores written whole, then a merge) and K5's (a fused top-k) read the
    same share where the slot scorer takes the same time."""
    work = {"blocks_touched": [4000, 4100], "nprobe": 16, "L": 256, "d": 100, "k": 10, "elem_bytes": 2,
            "queries_per_call": 10_000}
    counts = {"batches": [0, 1, 0], "work": work, "queries": 30_000}
    k4 = trace.summarize(events(kernels=[("slot_score_kernel(SlotArgs)", 0, 600_000),
                                         ("radixSort", 600_000, 700_000)], host=[], window=(0, 10**6)))
    k5 = trace.summarize(events(kernels=[("slot_score_kernel(SlotArgs)", 0, 600_000)], host=[],
                                window=(0, 10**6)))
    least = sum(roofline.bound(*roofline.slot_score_work(10_000, 16, work["blocks_touched"][b], 256, 100, 10),
                               H100)[0] for b in counts["batches"])
    want = 100.0 * least / 600e-6
    assert metric("slot_score_roofline", trace=k4, counts=counts) == pytest.approx(want)
    assert metric("slot_score_roofline", trace=k5, counts=counts) == pytest.approx(want)
    assert metric("slot_score_roofline", trace=trace.summarize(events([], [])), counts=counts) is None
