"""Query-side index, the ``Granne`` equivalent (port of
``granne_tpu/index/granne.py``).  ``search_batch`` serves [B, d] batches;
``search`` wraps it for one query.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import distance, frontier
from .graph import LayerStack


@dataclass(frozen=True)
class Granne:
    """An immutable searchable index: layer stack + element container.

    ``nbr_vecs`` (see ``with_neighbor_cache``) is a flat bf16 cache of the
    bottom layer: search then reads one row per expanded node through the
    K1 kernel.  It costs ``n * pad128(M*d + 2M) * 2`` bytes of device memory.
    """

    layers: LayerStack
    elements: object  # an element container
    nbr_vecs: object = None

    def with_neighbor_cache(self, layout: str = "flat") -> "Granne":
        """Return a copy serving through a bottom-layer neighbor cache."""
        from ..ops.nbr_cache import make_neighbor_cache, supports_cache

        if not supports_cache(self.elements):
            raise ValueError(f"{type(self.elements).__name__} cannot feed a neighbor cache")
        if len(self.layers) == 0:
            raise ValueError("an empty index has no layer to cache")
        tab = make_neighbor_cache(
            self.layers.layers[-1], self.elements, rows=self.layers.num_elements, layout=layout
        )
        return Granne(layers=self.layers, elements=self.elements, nbr_vecs=tab)

    # -- persistence ---------------------------------------------------------

    def save_index(self, path: str, compressed: bool = True) -> None:
        from . import io as gio

        gio.save_index(self.layers, path, compressed=compressed)

    def save_elements(self, path: str) -> None:
        from . import io as gio

        gio.save_elements(self.elements, path)

    # -- introspection ---------------------------------------------------------

    def __len__(self) -> int:
        return self.layers.num_elements

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def layer_len(self, layer: int) -> int:
        return self.layers.layer_len(layer)

    def get_neighbors(self, index: int, layer: int) -> list[int]:
        return self.layers.get_neighbors(layer, index)

    def get_element(self, index: int) -> np.ndarray:
        n = len(self.elements)
        if not 0 <= index < n:
            raise IndexError(f"element index {index} out of range [0, {n})")
        return self.elements.vectors[index].to(torch.float32).cpu().numpy()

    # -- search ----------------------------------------------------------------

    def search_batch(
        self,
        queries,
        max_search: int = 200,
        num_neighbors: int = 20,
        *,
        expand: int = 1,
        max_iters: int | None = None,
    ):
        """Batched search: raw f32 [B, d] queries -> (ids, dists) [B, k]
        tensors on the index's device."""
        distance.full_f32()
        q = self.elements.prepare_queries(queries)
        return frontier.search_layers(
            self.layers.layers, self.elements, q, ef=max_search, num_neighbors=num_neighbors,
            expand=expand, max_iters=max_iters, nbr_vecs=self.nbr_vecs,
        )

    def search(self, element, max_search: int = 200, num_neighbors: int = 20):
        """Single-query search returning [(id, dist)], nearest first."""
        q = np.asarray(element, np.float32)[None, :]
        ids, d = self.search_batch(q, max_search, num_neighbors)
        ids = ids[0].cpu().numpy()
        d = d[0].cpu().numpy()
        return [(int(i), float(x)) for i, x in zip(ids, d) if i >= 0]
