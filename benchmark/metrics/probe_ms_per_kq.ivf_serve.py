"""Device milliseconds of the coarse probe (``index/ivf.py::_probe``: the
centroid GEMM and its top-k) per 1,000 queries answered: the ``ivf/probe``
span's ``device_s`` (``granne_tpu_torch/utils/trace.py``: CUDA events on the
stream at its entry and exit, so idle inside the span counts).  Nothing
where the program has no such span or did not time it on the device."""

SPAN = "ivf/probe"


def read(m):
    device_s = m.spans.get(SPAN, {}).get("device_s")
    if device_s is None or not m.counts.get("queries"):
        return None
    return 1e3 * device_s / (m.counts["queries"] / 1000.0)
