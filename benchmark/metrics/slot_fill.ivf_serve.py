"""Share of the slot scorer's query rows that hold a query (%): the (query,
block) pairs (counter ``ivf/pairs``, queries times nprobe) over the query
rows of the slots scored (``ivf/slot_rows``, slots times the group cap),
both counted in ``index/ivf.py::search_probed``.  K4 scores every row of a
slot, so the rest of its output is work that no query reads.  Nothing where
the program has no such counters."""


def read(m):
    pairs, rows = (m.spans.get(name, {}).get("total") for name in ("ivf/pairs", "ivf/slot_rows"))
    if not pairs or not rows:
        return None
    return 100.0 * pairs / rows
