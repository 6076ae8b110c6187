"""User-facing API shaped like granne's Python bindings (port of
``granne_tpu/api.py``).  Every entry point takes ``device`` (default
``"cuda"``): nothing moves to the CPU on its own.

Example (build -> save -> load from disk -> search -> same results; executed
by ``tests/test_torch_api.py``):

>>> import tempfile, os, numpy as np
>>> import granne_tpu_torch as granne
>>> rng = np.random.default_rng(7)
>>> builder = granne.GranneBuilder(
...     "angular", num_neighbors=8, max_search=16, wave_size=32, device="cpu")
>>> for v in rng.standard_normal((200, 8)).astype(np.float32):
...     builder.append(v)
>>> builder.build()
>>> builder.num_layers >= 2
True
>>> tmp = tempfile.mkdtemp()
>>> builder.save_index(os.path.join(tmp, "index.granne"))
>>> builder.save_elements(os.path.join(tmp, "elements.bin"))
>>> index = granne.load_granne(
...     os.path.join(tmp, "index.granne"), os.path.join(tmp, "elements.bin"), device="cpu")
>>> query = builder.get_element(123)
>>> res = index.search(query, 16, 5)  # [(id, dist)], nearest first
>>> res[0][0]
123
>>> res == builder.search(query, 16, 5)  # the loaded index answers the same
True
>>> res[0][1] < 1e-5
True
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .elements.angular import AngularVectors
from .elements.angular_int import AngularIntVectors
from .index import io as gio
from .index.builder import BuildConfig, build_layers
from .index.granne import Granne
from .index.graph import LayerStack
from .ops import distance

DEFAULT_MAX_SEARCH = 200
DEFAULT_NUM_ELEMENTS = 10

_ELEMENT_TYPES = {"angular": AngularVectors, "angular_int": AngularIntVectors}


def _element_class(element_type: str):
    if element_type not in _ELEMENT_TYPES:
        raise ValueError(
            f"element type {element_type!r} is not ported to granne_tpu_torch yet "
            "(ported: 'angular', 'angular_int'; ROADMAP.md, Queue 1 item 10)"
        )
    return _ELEMENT_TYPES[element_type]


def compute_distance(element_type: str, a, b, device="cuda") -> float:
    """Distance between two raw vectors."""
    cls = _element_class(element_type)
    pair = np.stack([np.asarray(a, np.float32), np.asarray(b, np.float32)])
    return cls.from_raw(pair, device=device).dist(0, 1)


def load_granne(index_path, elements_path, device="cuda") -> Granne:
    """Open a saved index + elements pair (file paths or bytes-like buffers)."""
    distance.full_f32()
    return Granne(
        layers=gio.load_index(index_path, device=device),
        elements=gio.load_elements(elements_path, device=device),
    )


class GranneBuilder:
    """Mutable builder over the wave builder: append elements, build
    (optionally partially), save, introspect, and hand out snapshots.

    A snapshot from ``get_index`` stays valid after a later ``build``: the
    build never writes into tensors of an earlier state.
    """

    def __init__(
        self,
        element_type: str = "angular",
        dim: Optional[int] = None,
        config: Optional[BuildConfig] = None,
        *,
        device="cuda",
        **config_kwargs,
    ):
        if config is None:
            config = BuildConfig(**config_kwargs)
        elif config_kwargs:
            raise ValueError("pass either config or kwargs, not both")
        distance.full_f32()
        self.config = config
        self.device = torch.device(device)
        self._cls = _element_class(element_type)
        self._dim = dim
        self._pending: list[np.ndarray] = []
        self._elements = None
        self._layers: Optional[LayerStack] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_elements(cls, elements, config: Optional[BuildConfig] = None, **kw) -> "GranneBuilder":
        kind = next((name for name, c in _ELEMENT_TYPES.items() if isinstance(elements, c)), type(elements).__name__)
        b = cls(kind, dim=elements.dim, config=config, device=elements.device, **kw)
        b._elements = elements
        return b

    @classmethod
    def from_index(
        cls, index_path, elements_path, config: Optional[BuildConfig] = None, device="cuda", **kw
    ) -> "GranneBuilder":
        """Resume building from a saved index."""
        b = cls.from_elements(gio.load_elements(elements_path, device=device), config=config, **kw)
        b._layers = gio.load_index(index_path, device=device)
        return b

    @classmethod
    def from_bytes(
        cls, index_bytes, elements_bytes, config: Optional[BuildConfig] = None, device="cuda", **kw
    ) -> "GranneBuilder":
        """Resume building from caller-owned buffers of the two files
        (``GranneBuilder::from_bytes``, src/index/mod.rs:430-446)."""
        return cls.from_index(index_bytes, elements_bytes, config=config, device=device, **kw)

    # -- element ingestion -------------------------------------------------

    def append(self, vector) -> None:
        """Append one element [d], or a batch [n, d]."""
        v = np.asarray(vector, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if self._dim is None:
            self._dim = v.shape[1]
        if v.shape[1] != self._dim:
            raise ValueError(f"dimension mismatch: {v.shape[1]} != {self._dim}")
        self._pending.append(v)

    def _flush(self):
        if self._pending:
            batch = np.concatenate(self._pending, axis=0)
            self._pending.clear()
            if self._elements is None:
                self._elements = self._cls.from_raw(batch, device=self.device)
            else:
                self._elements = self._elements.extend(batch)
        if self._elements is None:  # nothing appended yet: an empty view, not stored
            return self._cls.from_raw(np.zeros((0, self._dim or 1), np.float32), device=self.device)
        return self._elements

    @property
    def elements(self):
        return self._flush()

    def __len__(self) -> int:
        """Number of elements (indexed or not)."""
        return len(self._flush())

    @property
    def indexed_elements(self) -> int:
        return self._layers.num_elements if self._layers is not None else 0

    # -- building ----------------------------------------------------------

    def build(self, num_elements: Optional[int] = None) -> None:
        """Build the index, optionally only the first ``num_elements``."""
        self._layers = build_layers(self._flush(), self.config, num_elements, state=self._layers)

    # -- persistence -------------------------------------------------------

    def save_index(self, path: str, compressed: bool = True) -> None:
        gio.save_index(self._layers or LayerStack(layers=(), counts=()), path, compressed=compressed)

    def save_elements(self, path: str) -> None:
        gio.save_elements(self._flush(), path)

    # -- introspection / search -------------------------------------------

    def get_index(self) -> Granne:
        """Searchable snapshot of the current build state."""
        return Granne(layers=self._layers or LayerStack(layers=(), counts=()), elements=self._flush())

    @property
    def num_layers(self) -> int:
        return len(self._layers) if self._layers is not None else 0

    def layer_len(self, layer: int) -> int:
        return self._layers.layer_len(layer) if self._layers is not None else 0

    def get_neighbors(self, index: int, layer: int) -> list[int]:
        return self._layers.get_neighbors(layer, index) if self._layers is not None else []

    def get_element(self, index: int) -> np.ndarray:
        """The ingested element at ``index``: normalized f32, or int8 codes."""
        return self.get_index().get_element(index)

    def search(self, element, max_search: int = DEFAULT_MAX_SEARCH, num_elements: int = DEFAULT_NUM_ELEMENTS):
        return self.get_index().search(element, max_search, num_elements)
