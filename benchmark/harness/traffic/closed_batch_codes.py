"""Closed-loop batch serving over int8 codes: ``closed_batch``'s one caller,
window, counts and release, for a configuration that stores its vectors as
max-abs int8 codes (its ``codes``: ``bits``).

Set-up draws the corpus and the query pool on the device from ``--seed``
(``data.make``), quantizes the corpus to codes with the reference's own
quantizer (``reference_codes.quantize``) and hands the system the codes on
the host, as a deployment that keeps its data as codes does; the f32
corpus is dropped.  The queries stay f32.  The warm-up is
``closed_batch``'s.  Every control of such a cell is the reference in the
program's place.

The judge holds every answer against the reference over the codes:
``bad_rows`` as ``checks.Tally`` finds them, ``dist_err`` against the
reference's distance of the same id with the codes exact and the query in
f32 or in bf16 (the stated precision), whichever is nearer, and
``recall_miss`` against the exact f32 top-k over the codes' unit rows.  A
control (``reference_codes.Exact``, below the stated precision) goes
through the same judge.
"""

from __future__ import annotations

import time

import torch

from .. import checks, data, reference_codes
from ..runner import log
from .closed_batch import AnswerStore, State, _sync, counts, pool, release, window  # noqa: F401


def setup(ctx, system) -> State:
    t = ctx.cell["traffic"]
    start = time.perf_counter()
    corpus, queries = data.make(ctx.config["data"], ctx.seed, ctx.config["data"]["n"],
                                t["pool_calls"] * t["queries_per_call"], ctx.device)
    codes = reference_codes.quantize(corpus, ctx.config["codes"]["bits"])
    del corpus
    if ctx.control is not None:
        server = reference_codes.Exact(codes, t["k"], ctx.control["precision"])
    else:
        host = codes.cpu().numpy()
        log(f"codes drawn, quantized and on the host in {time.perf_counter() - start:.3f} s")
        server = system.serve(ctx.config, ctx.cell, host, device=ctx.device)
    st = State(codes, queries, server)
    batches = pool(ctx, st)
    warm = time.perf_counter()
    for i in range(t["warmup_calls"]):
        start = time.perf_counter()
        ids, dists = st.server.search(batches[-1 - i % t["pool_calls"]])
        _sync(ctx.device)
        pace = time.perf_counter() - start
    log(f"warm-up: {t['warmup_calls']} calls in {time.perf_counter() - warm:.3f} s")
    st.store = AnswerStore(ids, dists, int(2 * ctx.seconds / pace) + 4)
    return st


class CodesTally(checks.Tally):
    """``checks.Tally`` over the codes: ``add`` takes the codes and the raw
    queries in place of unit rows."""

    def add(self, codes, queries, ids, dists, gt) -> None:
        n = codes.shape[0]
        ids = ids.to(codes.device).long()
        dists = dists.to(codes.device).to(torch.float32)
        srt = torch.sort(ids, dim=1).values
        bad = ~(((ids >= 0) & (ids < n)).all(dim=1) & ~(srt[:, 1:] == srt[:, :-1]).any(dim=1)
                & torch.isfinite(dists).all(dim=1) & (dists[:, 1:] >= dists[:, :-1]).all(dim=1))
        safe = ids.clamp(0, n - 1)
        err = torch.minimum((dists - reference_codes.id_dists(codes, queries, safe)).abs(),
                            (dists - reference_codes.id_dists(codes, queries, safe, query_bf16=False)).abs())
        err = err[~bad]
        hit = (ids[:, :, None] == gt[:, None, :].to(ids.device)).any(dim=2) & ~bad[:, None]
        self.rows += ids.shape[0]
        self.bad_rows += int(bad.sum())
        self.hits += int(hit.sum())
        if err.numel():
            self.err_max = max(self.err_max, float(err.max()))


def judge(ctx, st: State) -> tuple[checks.Tally, dict, int, int]:
    """(tally, end-to-end values, attempted, failed) once the program is freed."""
    t = ctx.cell["traffic"]
    k, B = t["k"], t["queries_per_call"]
    gt, _ = reference_codes.exact_topk(st.corpus, st.queries, k)
    tally = CodesTally(k, ctx.cell["precision"])
    for b, ids, dists in st.answers:
        rows = slice(b * B, (b + 1) * B)
        tally.add(st.corpus, st.queries[rows], ids, dists, gt[rows])
    return tally, {"recall_at_10": tally.recall}, len(st.answers) * B, tally.bad_rows
