"""Block reads of the IVF slot scorer for each block the roofline counts
once: the slots it scored (counter ``ivf/slots``) over the distinct blocks
among the used ones (``ivf/blocks``), both counted in
``index/ivf.py::search_probed``.  An unused slot re-scores block 0, and a
block probed by more than a slot's queries fills several slots.  Nothing
where the program has no such counters."""


def read(m):
    slots, blocks = (m.spans.get(name, {}).get("total") for name in ("ivf/slots", "ivf/blocks"))
    if not slots or not blocks:
        return None
    return slots / blocks
