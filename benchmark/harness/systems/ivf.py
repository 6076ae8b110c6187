"""granne_tpu_torch's IVF index, as a configuration's ``index`` states it.

``IvfIndex.build`` trains the coarse quantizer and lays out the blocks;
``IvfIndex.search_batch`` answers through the probe, ``group_pairs``, the
slot scorer (K4 by default) and the merge.  ``work`` counts, for the
slot-scoring roofline, the distinct blocks each query batch's probes touch:
the harness's own probe (the nearest ``nprobe`` centroids of each unit
query), which never looks at a kernel's launches.
"""

from __future__ import annotations

import granne_tpu_torch as gt
import torch

from .. import reference


class Server:
    def __init__(self, index: gt.IvfIndex, nprobe: int, k: int):
        self.index, self.nprobe, self.k = index, nprobe, k

    def search(self, queries):
        return self.index.search_batch(queries, self.k, nprobe=self.nprobe)

    def work(self, pool) -> dict:
        """Blocks touched by each batch of ``pool`` [calls, B, d], and the
        shapes of the slot scoring."""
        c = self.index.centroids.to(torch.float32)
        touched = []
        for batch in pool:
            probes = torch.topk(reference.normalize(batch) @ c.T, self.nprobe, dim=1).indices
            touched.append(int(torch.unique(probes).numel()))
        b = self.index.blocks
        return {"blocks_touched": touched, "nprobe": self.nprobe, "L": int(b.shape[1]), "d": int(b.shape[2]),
                "k": self.k, "elem_bytes": b.element_size(), "queries_per_call": int(pool.shape[1])}


def serve(config: dict, cell: dict, corpus, control: dict | None = None) -> Server:
    ix = config["index"]
    index = gt.IvfIndex.build(
        corpus, n_clusters=corpus.shape[0] // ix["clusters_per"], kmeans_iters=ix["kmeans_iters"],
        cluster_cap=ix["cluster_cap"], dtype=control["dtype"] if control else ix["dtype"],
        seed=ix["kmeans_seed"], device=corpus.device,
    )
    return Server(index, cell["serve"]["nprobe"], cell["traffic"]["k"])
