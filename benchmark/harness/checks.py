"""What decides ``correct``: the program's answers against the reference.

An answer is one query's ``k`` ids and distances as the program returned
them.  Three numbers are compared, each with a limit of its own (a cell's
``limits``):

* ``bad_rows``: answers with an id out of range, a repeated id, a distance
  that is not finite, or distances out of ascending order (exact: limit 0);
* ``dist_err``: the largest gap between a returned distance and the
  reference's distance of the same id, in f32 or at the precision the cell
  states (bf16 vectors summed in f32 for the bf16 serving copies),
  whichever is nearer, over every id of every sound answer: a scoring path
  below the stated precision, or an answer altered, shows here, and one
  above it does not;
* ``recall_miss``: the share of the reference's exact top-k that the answers
  missed, over every answer (1 - recall@k; a bad answer counts as missed).

``recall_at_k`` is also the cell's end-to-end ``recall_at_10``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import reference

_ROWS = 1 << 16  # answers judged at once


@dataclass
class Tally:
    """Running sums over blocks of answers."""

    k: int
    precision: str = "f32"  # of the distances the answers claim
    rows: int = 0
    bad_rows: int = 0
    hits: int = 0
    err_max: float = 0.0

    def add(self, xn, qn, ids, dists, gt) -> None:
        """Judge answers ``ids``/``dists`` [R, k] to the unit queries ``qn``
        [R, d] whose exact top-k ids are ``gt`` [R, k]."""
        n = xn.shape[0]
        ids = ids.to(xn.device).long()
        dists = dists.to(xn.device).to(torch.float32)
        in_range = ((ids >= 0) & (ids < n)).all(dim=1)
        srt = torch.sort(ids, dim=1).values
        repeated = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
        finite = torch.isfinite(dists).all(dim=1)
        ascending = (dists[:, 1:] >= dists[:, :-1]).all(dim=1)
        bad = ~(in_range & ~repeated & finite & ascending)
        ok = ~bad
        safe = ids.clamp(0, n - 1)
        err = (dists - reference.id_dists(xn, qn, safe)).abs()
        if self.precision != "f32":
            err = torch.minimum(err, (dists - reference.id_dists(xn, qn, safe, self.precision)).abs())
        err = err[ok]
        hit = (ids[:, :, None] == gt[:, None, :].to(ids.device)).any(dim=2) & ok[:, None]
        self.rows += ids.shape[0]
        self.bad_rows += int(bad.sum())
        self.hits += int(hit.sum())
        if err.numel():
            self.err_max = max(self.err_max, float(err.max()))

    @property
    def recall(self) -> float:
        return self.hits / max(1, self.rows * self.k)

    def numbers(self) -> dict:
        return {"bad_rows": self.bad_rows, "dist_err": self.err_max, "recall_miss": 1.0 - self.recall}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at most its limit."""
    shown = {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
    return all(c["value"] <= c["limit"] for c in shown.values()), shown


def judge_answers(xn, queries_n, answers, gt, k: int, precision: str) -> Tally:
    """A ``Tally`` over ``answers``: (query rows LongTensor [b], ids [b, k],
    dists [b, k]) triples, each answering the unit queries
    ``queries_n[rows]``, whose exact top-k ids are ``gt[rows]``."""
    tally = Tally(k, precision)
    for rows, ids, dists in answers:
        for lo in range(0, ids.shape[0], _ROWS):
            r = rows[lo : lo + _ROWS].to(xn.device)
            tally.add(xn, queries_n[r], ids[lo : lo + _ROWS], dists[lo : lo + _ROWS], gt[r])
    return tally
