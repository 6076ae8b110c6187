"""granne_tpu_torch's HNSW, as a configuration's ``build`` and ``serve`` state it.

``GranneBuilder`` builds the graph over f32 elements in set-up, and a copy
of the index with the serving elements (bf16, or a control's int8 codes)
behind a bottom-layer neighbor cache answers through ``Granne.search_batch``
(the descent, the beam and K1).
"""

from __future__ import annotations

import granne_tpu_torch as gt


def build_config(config: dict) -> gt.BuildConfig:
    b = config["build"]
    return gt.BuildConfig(num_neighbors=b["num_neighbors"], max_search=b["max_search"], wave_size=b["wave_size"],
                          expand=b["expand"], reinsert_elements=b["reinsert_elements"])


def elements(config: dict, corpus, kind: str):
    if kind == "f32":
        return gt.AngularVectors.from_raw(corpus, device=corpus.device)
    if kind == "bf16":
        return gt.AngularVectors.from_raw(corpus, device=corpus.device).as_bf16()
    if kind == "int8":
        return gt.AngularIntVectors.from_raw(corpus, device=corpus.device)
    raise ValueError(f"unknown element kind {kind!r}")


class Server:
    def __init__(self, index: gt.Granne, ef: int, k: int, expand: int):
        self.index, self.ef, self.k, self.expand = index, ef, k, expand

    def search(self, queries):
        return self.index.search_batch(queries, max_search=self.ef, num_neighbors=self.k, expand=self.expand)

    def work(self, pool) -> dict:
        return {}


def serve(config: dict, cell: dict, corpus, control: dict | None = None) -> Server:
    """The serving index over ``corpus`` (f32 on the device)."""
    builder = gt.GranneBuilder.from_elements(elements(config, corpus, config["build"]["elements"]),
                                             config=build_config(config))
    builder.build()
    built = builder.get_index()
    s = config["serve"]
    kind = control["elements"] if control else s["elements"]
    index = gt.Granne(layers=built.layers, elements=elements(config, corpus, kind))
    if s.get("neighbor_cache"):
        index = index.with_neighbor_cache(s["neighbor_cache"])
    return Server(index, cell["serve"]["ef"], cell["traffic"]["k"], s["expand"])

