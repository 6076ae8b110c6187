"""Share of the served window in which no operation ran on the device (%)."""


def read(m):
    if m.trace is None or m.trace.device_ops == 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
