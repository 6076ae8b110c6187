"""Closed-loop batch serving: one caller sends a batch of queries, waits for
the answers on the host, and sends the next (ann-benchmarks' batch mode).

The cell's ``traffic`` gives ``queries_per_call``, ``pool_calls`` (the pool
of held-out queries is that many batches, sent in turn, so consecutive calls
never repeat a batch), ``warmup_calls`` and ``k``.  Every call has the same
shape, so the warm-up calls warm every shape the window uses.  A call ends
when its answers are on the host (copied into page-locked buffers sized in
set-up from the warm-up's pace, so the window allocates nothing) and the
device is synchronized.  ``qps`` is every query answered in the window over
the window's seconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import checks, data, reference


class AnswerStore:
    """Host buffers for the answers of the window's calls, in chunks of
    ``calls`` calls like ``ids``/``dists``: one chunk is made in set-up, and
    a window that outruns it makes another."""

    def __init__(self, ids: torch.Tensor, dists: torch.Tensor, calls: int):
        self.like, self.calls, self.chunks = (ids, dists), calls, []
        self._grow()

    def _grow(self):
        pin = self.like[0].is_cuda
        self.chunks.append(tuple(torch.empty((self.calls, *t.shape), dtype=t.dtype, pin_memory=pin)
                                 for t in self.like))

    def put(self, i: int, ids: torch.Tensor, dists: torch.Tensor):
        """Copy call ``i``'s answers to the host; returns the host views."""
        if i // self.calls >= len(self.chunks):
            self._grow()
        ids_h, dists_h = (c[i % self.calls] for c in self.chunks[i // self.calls])
        ids_h.copy_(ids, non_blocking=True)
        dists_h.copy_(dists, non_blocking=True)
        return ids_h, dists_h


@dataclass
class State:
    corpus: torch.Tensor
    queries: torch.Tensor  # [pool_calls * queries_per_call, d]
    server: object
    store: AnswerStore | None = None
    answers: list = field(default_factory=list)  # (pool batch, ids, dists) on the host, one a call
    window_s: float = 0.0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def pool(ctx, st: State) -> torch.Tensor:
    t = ctx.cell["traffic"]
    return st.queries.view(t["pool_calls"], t["queries_per_call"], -1)


def setup(ctx, system) -> State:
    t = ctx.cell["traffic"]
    corpus, queries = data.make(ctx.config["data"], ctx.seed, ctx.config["data"]["n"],
                                t["pool_calls"] * t["queries_per_call"], ctx.device)
    c = ctx.control
    if c is not None and c["path"] == "reference":
        server = reference.Exact(corpus, t["k"], c["precision"])
    else:
        server = system.serve(ctx.config, ctx.cell, corpus, control=c)
    st = State(corpus, queries, server)
    batches = pool(ctx, st)
    for i in range(t["warmup_calls"]):
        start = time.perf_counter()
        ids, dists = st.server.search(batches[-1 - i % t["pool_calls"]])
        _sync(ctx.device)
        pace = time.perf_counter() - start
    st.store = AnswerStore(ids, dists, int(2 * ctx.seconds / pace) + 4)
    return st


def window(ctx, st: State, seconds: float | None = None) -> dict:
    """Calls for ``seconds`` (the cell's window by default); their answers
    join the ones to judge."""
    t = ctx.cell["traffic"]
    batches = pool(ctx, st)
    _sync(ctx.device)
    first = len(st.answers)
    start = time.perf_counter()
    while True:
        b = len(st.answers) % t["pool_calls"]
        ids, dists = st.server.search(batches[b])
        st.answers.append((b, *st.store.put(len(st.answers), ids, dists)))
        _sync(ctx.device)
        if time.perf_counter() - start >= (ctx.seconds if seconds is None else seconds):
            break
    st.window_s = time.perf_counter() - start
    return {"qps": (len(st.answers) - first) * t["queries_per_call"] / st.window_s}


def counts(ctx, st: State) -> dict:
    """What the per-layer readers divide by, and the work of each call."""
    return {"calls": len(st.answers), "queries": len(st.answers) * ctx.cell["traffic"]["queries_per_call"],
            "batches": [b for b, _, _ in st.answers], "work": st.server.work(pool(ctx, st))}


def release(st: State) -> None:
    st.server = None


def judge(ctx, st: State) -> tuple[checks.Tally, dict, int, int]:
    """(tally, end-to-end values, attempted, failed) once the program is freed."""
    t = ctx.cell["traffic"]
    xn, qn = reference.normalize(st.corpus), reference.normalize(st.queries)
    gt, _ = reference.exact_topk(xn, qn, t["k"])
    B = t["queries_per_call"]
    rows = [torch.arange(b * B, (b + 1) * B) for b in range(t["pool_calls"])]
    answers = [(rows[b], ids, dists) for b, ids, dists in st.answers]
    tally = checks.judge_answers(xn, qn, answers, gt, t["k"], ctx.cell["precision"])
    return tally, {"recall_at_10": tally.recall}, len(st.answers) * B, tally.bad_rows
