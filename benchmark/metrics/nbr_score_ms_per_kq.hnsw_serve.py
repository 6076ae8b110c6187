"""Device milliseconds of K1 (``nbr_score_kernel``, csrc/nbr_score.cu) per
1,000 queries answered; nothing where K1 did not run."""

KERNEL = "nbr_score_kernel"


def read(m):
    if m.trace is None or m.trace.count_of(KERNEL) == 0 or not m.counts.get("queries"):
        return None
    return 1e3 * m.trace.seconds_of(KERNEL) / (m.counts["queries"] / 1000.0)
