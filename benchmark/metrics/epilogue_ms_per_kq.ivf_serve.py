"""Device milliseconds of the slot-scoring epilogue (``index/ivf.py::
search_probed``: the scale by each row's inverse norm, the mask of padding
rows and empty query places, and the gather of each (slot, place) score
row back to its pair) per 1,000 queries answered: the ``ivf/epilogue``
span's ``device_s`` (``granne_tpu_torch/utils/trace.py``: CUDA events on
the stream at its entry and exit, so idle inside the span counts).  The
span lies inside ``ivf/score``.  Nothing where the program has no such span
or did not time it on the device."""

SPAN = "ivf/epilogue"


def read(m):
    device_s = m.spans.get(SPAN, {}).get("device_s")
    if device_s is None or not m.counts.get("queries"):
        return None
    return 1e3 * device_s / (m.counts["queries"] / 1000.0)
