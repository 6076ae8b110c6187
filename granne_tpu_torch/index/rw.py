"""Concurrent build and serve: the extensible online index (port of
``granne_tpu/index/rw.py``).

The reference's ``RwGranneBuilder`` (``src/index/rw/``) inserts elements
into a live index while it serves searches; an inserted element is
searchable as soon as ``insert``/``insert_batch`` returns
(``rw/mod.rs:99-182``).  Here immutability does the locking:

* the graph state (layer stack + elements) is a ``Granne`` snapshot swapped
  under a small mutex; a search runs on whatever snapshot it took;
* inserts land in a pending tail that every search scans exactly and merges
  into its result, until a flush indexes the tail through the resumable
  builder (``build_layers(..., state=...)``).  The builder copies the layer
  it resumes before it writes, so a snapshot taken before a flush searches
  the same graph after it;
* flushes are serialized under a build lock (two flushes from one base
  snapshot would drop each other's layers), and the tail is trimmed only
  after the new snapshot is in, so no inserted element is ever unfindable;
* ``save`` holds the write lock: no insert lands between its flush and its
  files.

Searches and flushes may run in different threads on one CUDA device; every
one of them works on the device's current stream.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..ops.topk import merge_topk
from .builder import BuildConfig, build_layers
from .granne import Granne
from .graph import LayerStack


def _tail_container(elements, tail: np.ndarray):
    """The pending rows as a container of the snapshot's kind, quantized and
    typed as the flush's ``extend`` will index them."""
    return elements.permute(torch.empty(0, dtype=torch.long)).extend(tail)


class RwGranneBuilder:
    """Thread-safe online index: concurrent ``insert``/``search``/``save``."""

    def __init__(self, elements, config: Optional[BuildConfig] = None, **config_kwargs):
        self.config = config if config is not None else BuildConfig(**config_kwargs)
        layers = build_layers(elements, self.config) if len(elements) else LayerStack((), ())
        self._snapshot = Granne(layers=layers, elements=elements)
        self._pending: list[np.ndarray] = []
        self._mutex = threading.Lock()  # guards the snapshot and the pending list
        self._build_lock = threading.Lock()  # serializes flushes
        self._write_lock = threading.Lock()  # holds inserts off during save (rw/mod.rs:70-97)

    # -- serving -----------------------------------------------------------

    def get_index(self) -> Granne:
        """The indexed graph as it stands (without the pending tail; call
        ``flush()`` first for a complete index).  A later flush leaves it as
        it is."""
        return self._snapshot

    def _state(self):
        with self._mutex:
            snap = self._snapshot
            pend = list(self._pending)
        return snap, (np.concatenate(pend, axis=0) if pend else None)

    def search(self, element, max_search: int = 200, num_neighbors: int = 20):
        """Single-query search returning [(id, dist)], nearest first."""
        ids, d = self.search_batch(np.asarray(element, np.float32)[None, :], max_search, num_neighbors)
        return [(int(i), float(x)) for i, x in zip(ids[0].cpu().numpy(), d[0].cpu().numpy()) if i >= 0]

    def search_batch(self, queries, max_search: int = 200, num_neighbors: int = 20):
        """Search the snapshot and the pending tail (an exact scan), merged:
        an element is found the moment its ``insert_batch`` returned.  Ties
        keep the snapshot's ids first."""
        snap, tail = self._state()
        ids, d = snap.search_batch(queries, max_search, num_neighbors)
        if tail is None:
            return ids, d
        tc = _tail_container(snap.elements, tail)
        q = tc.prepare_queries(queries)
        tid = torch.arange(len(tc), dtype=torch.int32, device=ids.device).expand(ids.shape[0], len(tc))
        td = tc.dist_ids_to_queries(tid, q)
        d, (ids,) = merge_topk(d, td, (ids,), (len(snap.elements) + tid,), num_neighbors)
        return ids, d

    def __len__(self) -> int:
        """Every element, indexed or pending (all are searchable)."""
        with self._mutex:
            return len(self._snapshot.elements) + sum(p.shape[0] for p in self._pending)

    @property
    def indexed_elements(self) -> int:
        return len(self._snapshot)

    # -- inserting ---------------------------------------------------------

    def insert(self, vector) -> None:
        self.insert_batch(np.asarray(vector, np.float32)[None, :])

    def insert_batch(self, vectors) -> None:
        """Append elements; they are searchable when this returns
        (rw/mod.rs:103-182).  They go to the pending tail at once and into
        the graph when ``wave_size`` are pending or at ``flush()``."""
        vectors = np.asarray(vectors, np.float32)
        with self._write_lock:
            with self._mutex:
                self._pending.append(vectors)
                total = sum(p.shape[0] for p in self._pending)
            if total >= self.config.wave_size:
                self.flush()

    def flush(self) -> None:
        """Index every pending element and swap in the new snapshot."""
        with self._build_lock:
            with self._mutex:
                if not self._pending:
                    return
                chunks = list(self._pending)
                snap = self._snapshot
            elements = snap.elements.extend(np.concatenate(chunks, axis=0))
            layers = build_layers(elements, self.config, state=snap.layers if len(snap.layers) else None)
            with self._mutex:
                self._snapshot = Granne(layers=layers, elements=elements)
                del self._pending[: len(chunks)]

    # -- persistence (rw/mod.rs:70-97) --------------------------------------

    def save(self, index_path: str, elements_path: str, compressed: bool = True) -> None:
        """Flush, then write the index and the elements (each file to a
        temporary name moved into place)."""
        from . import io as gio

        with self._write_lock:
            self.flush()
            snap = self._snapshot
            gio.save_index(snap.layers, index_path, compressed=compressed)
            gio.save_elements(snap.elements, elements_path)
