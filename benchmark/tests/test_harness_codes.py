"""The int8-codes cell (``deep96-i8-ivf.batch10k``): its reference, its
judge, its controls and faults, its work count and its two readers, at a
size the CPU holds (the port's plain kernels; the harness's look for a
card is skipped)."""

import time
from types import SimpleNamespace

import pytest
import torch
from harness import reference_codes, roofline, runner, spec
from harness.runner import Ctx
from harness.traffic import closed_batch_codes
from test_harness_faults import serving_fault
from test_harness_imports import imported_names

WORKLOAD = "deep96-i8-ivf.batch10k"


def tiny() -> spec.Spec:
    """The cell at 20,000 codes and 32 clusters (blocks of the cell's L 512,
    so nprobe 32 probes about half of them), 100 queries a call."""
    s = spec.load_spec(WORKLOAD)
    s.config["data"]["n"] = 20_000
    s.config["index"].update(n_clusters=32, kmeans_sample=8192, chunk=7000, kmeans_iters=4)
    s.cell["traffic"].update(queries_per_call=100, pool_calls=3, warmup_calls=1)
    return s


def run(s: spec.Spec, **kw) -> dict:
    return runner.run_cell(s, 2**31 + 77, 0.3, False, t0=time.perf_counter(), device="cpu", **kw)


def test_sound_run_is_correct_at_the_stated_precision():
    r = run(tiny())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0 and list(r)[-1] == "checks"
    assert r["checks"]["dist_err"]["value"] <= 1e-6  # f32 summation order over 96 exact products
    assert r["metrics"]["recall_at_10"]["value"] >= 0.9


@pytest.mark.parametrize("i", range(len(spec.load_spec(WORKLOAD).cell["controls"])))
def test_control_fails(i):
    s = tiny()
    r = run(s, control=s.cell["controls"][i])
    assert not r["correct"], r["checks"]
    assert r["checks"]["dist_err"]["value"] > s.cell["limits"]["dist_err"]  # caught by the distances


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_caught(monkeypatch, fault):
    serving_fault(monkeypatch, WORKLOAD, fault)
    r = run(tiny())
    assert not r["correct"], r["checks"]


def _state(codes, queries, answers, B):
    ctx = Ctx({}, {"traffic": {"k": 10, "queries_per_call": B}, "precision": "int8-codes/bf16-query"}, 1, 1.0, "cpu")
    st = closed_batch_codes.State(codes, queries, None)
    st.answers = answers
    return ctx, st


def test_the_judge_scores_the_reference_itself_at_zero_error():
    """The reference's own f32 top-10 with its own f32 distances: no bad
    row, no distance error, no miss; the same ids with the distances at
    the stated precision (the query in bf16) read no error either."""
    gen = torch.Generator().manual_seed(3)
    codes = reference_codes.quantize(torch.randn((3000, 96), generator=gen))
    queries = torch.randn((200, 96), generator=gen)
    ids, _ = reference_codes.exact_topk(codes, queries, 10)
    exact = reference_codes.id_dists(codes, queries, ids, query_bf16=False)
    stated = reference_codes.id_dists(codes, queries, ids)
    for dists in (exact, stated):
        order = torch.argsort(dists, dim=1, stable=True)  # ascending, as an answer is
        answers = [(b, torch.gather(ids[b * 100 : (b + 1) * 100], 1, order[b * 100 : (b + 1) * 100]),
                    torch.gather(dists[b * 100 : (b + 1) * 100], 1, order[b * 100 : (b + 1) * 100])) for b in (0, 1)]
        tally, e2e, attempted, failed = closed_batch_codes.judge(*_state(codes, queries, answers, 100))
        assert tally.numbers() == {"bad_rows": 0, "dist_err": 0.0, "recall_miss": 0.0}
        assert e2e == {"recall_at_10": 1.0} and (attempted, failed) == (200, 0)


def test_quantize_rounds_half_to_even_at_max_abs():
    x = torch.tensor([[254.0, 1.0, -3.0, 0.0], [0.0, 0.0, 0.0, 0.0], [-2.0, 1.0, 0.0, 0.0]])
    assert reference_codes.quantize(x).tolist() == [[127, 0, -2, 0], [0, 0, 0, 0], [-127, 64, 0, 0]]
    assert reference_codes.quantize(x, bits=6).tolist() == [[31, 0, 0, 0], [0, 0, 0, 0], [-31, 16, 0, 0]]


def test_slot_score_roofline_counts_one_byte_a_lane():
    """The new system's work says 1 byte a lane (int8 blocks), and the
    roofline reader's least time uses it."""
    from harness.systems import ivf_i8

    s = tiny()
    codes = reference_codes.quantize(torch.randn((20_000, 96), generator=torch.Generator().manual_seed(4)))
    server = ivf_i8.serve(s.config, s.cell, codes.numpy(), device="cpu")
    pool = torch.randn((2, 50, 96), generator=torch.Generator().manual_seed(5))
    w = server.work(pool)
    assert w["elem_bytes"] == 1 and (w["L"], w["d"], w["nprobe"]) == (512, 96, 32)
    kind = "NVIDIA H100 80GB HBM3"
    m = SimpleNamespace(counts={"work": w, "batches": [0, 1, 0]}, kind=kind,
                        trace=SimpleNamespace(seconds_of=lambda name: 1e-3))
    nbytes = [w["blocks_touched"][b] * 512 * 96 * 1 + 50 * 96 * 2 + 50 * 32 * 10 * 8 for b in (0, 1, 0)]
    flops = 2.0 * 50 * 32 * 512 * 96
    least = sum(roofline.bound(b, flops, kind)[0] for b in nbytes)
    assert spec.load_metric("slot_score_roofline").read(m) == pytest.approx(100 * least / 1e-3)


def test_readers_of_the_epilogue_span_and_the_slot_fill():
    spans = {"ivf/epilogue": {"total_s": 1.0, "count": 4, "device_s": 0.3},
             "ivf/pairs": {"total": 320}, "ivf/slot_rows": {"total": 640}}
    m = SimpleNamespace(trace=SimpleNamespace(window_s=2.0), spans=spans, counts={"queries": 20_000})
    assert spec.load_metric("epilogue_ms_per_kq.ivf_serve").read(m) == pytest.approx(15.0)
    assert spec.load_metric("slot_fill.ivf_serve").read(m) == pytest.approx(50.0)
    host_only = {"ivf/epilogue": {"total_s": 1.0, "count": 4}}
    for bare in ({}, host_only):
        m = SimpleNamespace(trace=SimpleNamespace(window_s=2.0), spans=bare, counts={"queries": 20_000})
        assert spec.load_metric("epilogue_ms_per_kq.ivf_serve").read(m) is None
        assert spec.load_metric("slot_fill.ivf_serve").read(m) is None


def test_the_codes_reference_imports_nothing_of_the_program():
    tops = {n.split(".")[0] for n in imported_names(spec.BENCH_DIR / "harness" / "reference_codes.py")}
    assert tops <= {"__future__", "contextlib", "torch"}, tops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


CARD_CASES = ["sound"] + [f"control{i}" for i in range(len(spec.load_spec(WORKLOAD).cell["controls"]))] + [
    "stale", "half", "altered"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_on_the_card_only_the_sound_run_is_correct(card, monkeypatch, case):
    """The cell at 100,000 codes on the card (K4 over int8 blocks, ``row_top_k``):
    correct without a fault, and not with a control or a planted fault."""
    s = tiny()
    s.config["data"]["n"] = 100_000
    s.config["index"].update(n_clusters=128, kmeans_sample=50_000, chunk=40_000)
    s.cell["traffic"].update(queries_per_call=2_000)
    control = s.cell["controls"][int(case[7:])] if case.startswith("control") else None
    if case in ("stale", "half", "altered"):
        serving_fault(monkeypatch, WORKLOAD, case)
    r = runner.run_cell(s, 2**31 + 99, 0.3, False, t0=time.perf_counter(), device=card, control=control)
    assert r["correct"] == (case == "sound"), r["checks"]
