"""granne_tpu_torch's chunked int8 IVF over host-resident codes, as a
configuration's ``index`` states it.

``index/ivf_big.py::build_ivf_i8_chunked`` trains the coarse quantizer on a
sample of the codes, streams them through the device in chunks for the
assignment and lays out the int8 blocks with their inverse norms; the index
serves from device memory through ``systems/ivf.py``'s ``Server``
(``IvfIndex.search_batch``: probe, ``group_pairs``, K4, merge), whose
``work`` counts 1 byte a lane for int8 blocks.  The build's three spans
(``ivf_big/train``, ``ivf_big/assign``, ``ivf_big/layout``, host seconds
with the device waited for at each end) go to standard error.
"""

from __future__ import annotations

from granne_tpu_torch.index import ivf_big
from granne_tpu_torch.utils import trace

from ..runner import log
from .ivf import Server


def serve(config: dict, cell: dict, codes, device="cuda") -> Server:
    """``codes``: int8[n, d] numpy on the host."""
    ix = config["index"]
    trace.reset()
    index = ivf_big.build_ivf_i8_chunked(
        codes, n_clusters=ix["n_clusters"], cluster_cap=ix["cluster_cap"], kmeans_iters=ix["kmeans_iters"],
        kmeans_sample=ix["kmeans_sample"], chunk=ix["chunk"], seed=ix["kmeans_seed"],
        device_resident=ix["device_resident"], log=log, device=device,
    )
    spans = trace.summary()
    log("build spans (s): " + ", ".join(f"{name} {spans[name]['total_s']}" for name in
                                        ("ivf_big/train", "ivf_big/assign", "ivf_big/layout") if name in spans)
        + f"; {index.k} blocks of L {index.cluster_cap}")
    return Server(index, cell["serve"]["nprobe"], cell["traffic"]["k"])
