"""IVF slot scoring's share of its roofline (%): the least time the window's
scoring work needs on this card, over the device time of the slot scorer
(``slot_score_kernel``, csrc/ivf_score.cu: K3, K4 and K5 alike).

The work is counted from the inputs and the cell's parameters
(``harness.roofline.slot_score_work``: each distinct probed block read once,
the queries read once, each probed block's best k written once; a multiply
and an add per lane of every query and probed row), never from the kernel's
launches.  At the cell's shapes the bytes bound it.  Nothing where the
kernel did not run.
"""

from harness import roofline

KERNEL = "slot_score_kernel"


def read(m):
    w = m.counts.get("work", {})
    if m.trace is None or "blocks_touched" not in w or m.trace.seconds_of(KERNEL) <= 0:
        return None
    least = 0.0
    for b in m.counts["batches"]:
        nbytes, flops = roofline.slot_score_work(w["queries_per_call"], w["nprobe"], w["blocks_touched"][b],
                                                 w["L"], w["d"], w["k"], w["elem_bytes"])
        least += roofline.bound(nbytes, flops, m.kind)[0]
    return 100.0 * least / m.trace.seconds_of(KERNEL)
