"""Share of the served window's device time outside every search call (%):
100 x (1 - the ``ivf/search`` spans' device seconds / the window).  A span's
device time runs from its entry to its exit on the stream, idle inside the
call included, so what is left is the caller's share of
``device_idle_pct.serve``: waiting for the answers, copying them out,
starting the next call.  Nothing where the program has no such span or did
not time it on the device."""

SPAN = "ivf/search"


def read(m):
    device_s = m.spans.get(SPAN, {}).get("device_s")
    if m.trace is None or device_s is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - device_s / m.trace.window_s)
