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

    ``nbr_vecs`` (see ``with_neighbor_cache``) is a neighbor cache of the
    bottom layer (``ops.nbr_cache``): search then reads one row per
    expanded node.  A flat bf16 table goes through the K1 kernel and costs
    ``n * pad128(M*d + 2M) * 2`` bytes of device memory; a tiled one goes
    through K2 and costs ``n * pad8(M) * 256`` bytes; a flat f32 table
    (``make_neighbor_cache(cache_dtype="f32")``) scores exactly in plain
    PyTorch at ``n * pad128(M*d + M) * 4`` bytes.
    """

    layers: LayerStack
    elements: object  # an element container
    nbr_vecs: object = None

    def with_neighbor_cache(self, layout: str = "flat") -> "Granne":
        """Return a copy serving through a bottom-layer neighbor cache in
        ``layout``: "flat" (K1) or "tiled" (K2, d <= 128; not for int8
        elements)."""
        from ..ops.nbr_cache import make_neighbor_cache

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

    def _check_element_index(self, index: int) -> None:
        n = len(self.elements)
        if not 0 <= index < n:
            raise IndexError(f"element index {index} out of range [0, {n})")

    def get_element(self, index: int) -> np.ndarray:
        """The element's vector as ``elements.get`` gives it: the f32 unit
        vector, int8 codes for int8 elements, the summed unit vector for
        SumEmbeddings (a bf16 copy's row comes back as f32: numpy has no bf16)."""
        self._check_element_index(index)
        row = self.elements.get(torch.tensor([index], device=self.elements.device))[0]
        return (row.to(torch.float32) if row.dtype == torch.bfloat16 else row).cpu().numpy()

    def get_internal_element(self, index: int):
        """The element as the index stores it (py/src/lib.rs:255-258): the
        term-id list of a SumEmbeddings element, else ``get_element``."""
        self._check_element_index(index)
        get_terms = getattr(self.elements, "get_terms", None)
        if get_terms is not None:
            return get_terms(index)
        return self.get_element(index)

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

    # -- reordering (Granne::reorder, src/index/reorder.rs:59-82) --------------

    def reorder(self, order=None):
        """Return (reordered index, order) with ``order[new_id] = old_id``.

        ``order=None`` computes the entrypoint-trail locality order on the
        elements' device; a given permutation is applied as it is.  The
        reordered index carries no neighbor cache (a table of the old ids
        would score the wrong rows): call ``with_neighbor_cache`` on it again.
        """
        from .reorder import reorder_index

        layers, elements, order = reorder_index(self.layers, self.elements, order)
        return Granne(layers=layers, elements=elements), order

    def reorder_by_keys(self, keys):
        """Reorder by external per-element sort keys [n] or [n, K]
        (reorder.rs:90-125); as ``reorder``, without a neighbor cache.
        Returns (reordered index, order) with ``order[new_id] = old_id``."""
        from .reorder import reorder_by_keys

        layers, elements, order = reorder_by_keys(self.layers, self.elements, keys)
        return Granne(layers=layers, elements=elements), order
