"""Kernels that ran on the device in the window per 1,000 queries answered:
the host enqueues each one, and the HNSW beam is bound by that count."""


def read(m):
    if m.trace is None or m.trace.kernels == 0 or not m.counts.get("queries"):
        return None
    return m.trace.kernels / (m.counts["queries"] / 1000.0)
