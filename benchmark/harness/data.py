"""The synthetic corpus and queries, drawn on the device from ``--seed``.

A copy of ``bench.py``'s generator (``chip_smoke.py::bench_data``): Gaussian
blobs of width ``sigma`` around ``centres`` standard-normal centres, each
vector around a centre drawn uniformly; queries are held out, drawn the same
way.  The centres are the data set's shape and come from the
configuration's ``centres_seed``, so every seed draws from one distribution
(a seed that placed its own centres changed the work: one read 3% lower
qps in both of two sets).  The seed draws the query pool, then the corpus,
on the device through one ``torch.Generator`` in a few large calls, so the
same seed gives the same inputs and the queries do not depend on the corpus
size.
"""

from __future__ import annotations

import torch

_SEED_MOD = 2**63


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % _SEED_MOD)
    return g


def _draw(g, centres, count: int, sigma: float) -> torch.Tensor:
    assign = torch.randint(0, centres.shape[0], (count,), generator=g, device=centres.device)
    noise = torch.randn((count, centres.shape[1]), generator=g, device=centres.device)
    return centres[assign] + sigma * noise


def make(data: dict, seed: int, n: int, n_queries: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus f32[n, d], queries f32[n_queries, d]) for ``data`` (a
    configuration's ``data``: ``d``, ``centres``, ``centres_seed``, ``sigma``)."""
    centres = torch.randn((data["centres"], data["d"]), generator=generator(data["centres_seed"], device),
                          device=device)
    g = generator(seed, device)
    queries = _draw(g, centres, n_queries, data["sigma"])
    corpus = _draw(g, centres, n, data["sigma"])
    return corpus, queries
