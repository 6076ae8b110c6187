"""User-facing API shaped like granne's Python bindings (port of
``granne_tpu/api.py``).  Every entry point takes ``device`` (default
``"cuda"``): nothing moves to the CPU on its own.

Besides the builder and the loader: the bag-of-embeddings ETL
(``parse_elements_and_save_to_disk``, ``compute_embeddings_and_save_to_disk``),
the standalone word-embedding collection ``Embeddings`` (host numpy, as in
the JAX package) and ``WordEmbeddingsGranne``, an index queried by vectors
or by text.  A text query sums the embeddings of all its known words (the
JAX package's embeds only the first word).

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

import json
import os

import numpy as np
import torch

from .elements.angular import AngularVectors
from .elements.angular_int import AngularIntVectors
from .elements.embeddings import SumEmbeddings
from .index import io as gio
from .index.builder import BuildConfig, build_layers
from .index.granne import Granne
from .index.graph import LayerStack
from .ops import distance

DEFAULT_MAX_SEARCH = 200
DEFAULT_NUM_ELEMENTS = 10

_ELEMENT_TYPES = {"angular": AngularVectors, "angular_int": AngularIntVectors}
EMBEDDINGS = "embeddings"  # the kind of a SumEmbeddings container (the element files' name)


def _element_class(element_type: str):
    if element_type not in _ELEMENT_TYPES:
        raise ValueError(
            f"element type {element_type!r} is not a vector type (types: 'angular', 'angular_int'; "
            "bag-of-embeddings elements need their table: "
            "GranneBuilder.from_elements(SumEmbeddings.from_parts(table, term_lists)))"
        )
    return _ELEMENT_TYPES[element_type]


def _element_kind(elements) -> str:
    if isinstance(elements, SumEmbeddings):
        return EMBEDDINGS
    for name, c in _ELEMENT_TYPES.items():
        if isinstance(elements, c):
            return name
    raise ValueError(f"no GranneBuilder element type for a {type(elements).__name__} container")


def _term_lists(element) -> list[list[int]]:
    """One term-id list, or a list of them, as lists of ints.  A raw vector
    (any float) is refused: a bag-of-embeddings element is its terms."""
    if isinstance(element, (np.ndarray, torch.Tensor)):
        element = element.tolist()
    items = list(element)
    lists = [items] if all(not isinstance(t, (list, tuple, np.ndarray)) for t in items) else [list(t) for t in items]
    for terms in lists:
        for t in terms:
            if not isinstance(t, (int, np.integer)) or isinstance(t, bool):
                raise ValueError(
                    f"'embeddings' elements are term-id lists (one list, or a list of lists), not vectors: got {t!r}"
                )
    return [[int(t) for t in terms] for terms in lists]


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


def parse_elements_and_save_to_disk(corpus_dir: str, words_path: str, output_path: str, num_shards: int = 1) -> None:
    """Tokenize a corpus directory against a word dictionary into term-id
    elements: one ``.npz`` of padded ``terms`` (``np.savez`` adds the suffix),
    or ``num_shards`` shard files in the directory ``output_path``."""
    from .elements import embeddings_etl as etl
    from .elements.embeddings import pad_term_lists

    words = etl.WordDict.from_file(words_path)
    lists = etl.parse_corpus_dir(corpus_dir, words)
    if num_shards <= 1:
        np.savez(output_path, terms=pad_term_lists(lists))
    else:
        etl.write_shards(lists, output_path, num_shards)


def compute_embeddings_and_save_to_disk(elements_path: str, embeddings, output_path: str, device="cuda") -> None:
    """Sum the elements of an ``.npz`` of padded ``terms`` over ``embeddings``
    [V, d] on ``device`` and save the unit vectors as an int8 (``i1``)
    element file."""
    from .elements import embeddings_etl as etl
    from .elements.embeddings import SumEmbeddings

    with np.load(elements_path) as data:
        terms = data["terms"]
    container = SumEmbeddings.from_parts(embeddings, terms, device=device)
    gio.save_elements(etl.precompute_quantized_vectors(container), output_path)


class Embeddings:
    """A standalone word-embedding collection (py/src/embeddings.rs:8-144),
    in host numpy: append (word, vector) pairs, embed ids, id lists or text
    as bag-of-embeddings sums, and compute angular distances.  Files: the
    matrix as a memory-mappable ``.npy``, the words as JSON lines."""

    def __init__(self, embeddings_path: Optional[str] = None, words_path: Optional[str] = None):
        from .elements.embeddings_etl import WordDict

        if (embeddings_path is None) != (words_path is None):
            raise ValueError("embeddings_path and words_path must be given together")
        if embeddings_path is not None:
            self._matrix = np.load(embeddings_path, mmap_mode="r")
            self.words = WordDict.from_file(words_path)
        else:
            self._matrix = None
            self.words = WordDict([])
        self._rows: list[np.ndarray] = []  # appended rows, past the (mapped) matrix

    def __len__(self) -> int:
        return len(self.words)

    @property
    def _base(self) -> int:
        return self._matrix.shape[0] if self._matrix is not None else 0

    def _row(self, idx: int) -> np.ndarray:
        return self._matrix[idx] if idx < self._base else self._rows[idx - self._base]

    @property
    def _dim(self) -> Optional[int]:
        if self._matrix is not None:
            return int(self._matrix.shape[1])
        return int(self._rows[0].shape[0]) if self._rows else None

    def append(self, embedding, word: str) -> bool:
        """Add a word and its vector; False (and nothing added) if the word exists."""
        if self.words.get_id(word) is not None:
            return False
        v = np.asarray(embedding, np.float32).ravel()
        if self._dim is not None and v.shape[0] != self._dim:
            raise ValueError(f"dimension mismatch: {v.shape[0]} != {self._dim}")
        self._rows.append(v)
        self.words.index[word] = len(self.words.words)
        self.words.words.append(word)
        return True

    def _ids_of(self, query) -> list[int]:
        if isinstance(query, (int, np.integer)):
            return [int(query)]
        if isinstance(query, str):
            return self.words.to_ids(query)
        return [int(i) for i in query]

    def get_embedding(self, query) -> np.ndarray:
        """The unnormalized sum for an id, an id list or a text."""
        ids = self._ids_of(query)
        if not ids:
            return np.zeros(self._dim or 0, np.float32)
        return np.sum([self._row(i) for i in ids], axis=0, dtype=np.float32)

    @staticmethod
    def _angular(a: np.ndarray, b: np.ndarray) -> float:
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0.0 or nb == 0.0:
            return 1.0
        return float(max(0.0, 1.0 - np.dot(a / na, b / nb)))

    def dist(self, left, right) -> float:
        return self._angular(self.get_embedding(left), self.get_embedding(right))

    def dists(self, left, rights) -> list[float]:
        lv = self.get_embedding(left)
        return [self._angular(lv, self.get_embedding(r)) for r in rights]

    def save_embeddings(self, path: str) -> None:
        """Write the matrix as ``.npy`` (the suffix added if missing), the
        mapped part streamed in bounded chunks, to a temporary file moved
        into place: saving over the file this collection maps is safe."""
        if not path.endswith(".npy"):
            path += ".npy"
        n, d = self._base + len(self._rows), self._dim or 0
        tmp = path + ".tmp"
        if n == 0 or d == 0:  # a zero-size array cannot be mapped
            with open(tmp, "wb") as f:
                np.save(f, np.zeros((n, d), np.float32))
        else:
            out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32, shape=(n, d))
            step = max(1, (64 << 20) // (4 * d))
            for lo in range(0, self._base, step):
                out[lo : min(lo + step, self._base)] = self._matrix[lo : lo + step]
            for i, row in enumerate(self._rows):
                out[self._base + i] = row
            out.flush()
            del out
        os.replace(tmp, path)

    def save_words(self, path: str) -> None:
        """One JSON string a line (the reference's word-dictionary format)."""
        with open(path, "w", encoding="utf-8") as f:
            for w in self.words.words:
                f.write(json.dumps(w) + "\n")

    def save(self, embeddings_path: str, words_path: str) -> None:
        self.save_embeddings(embeddings_path)
        self.save_words(words_path)


class WordEmbeddingsGranne:
    """An index queried by raw vectors or by text (py/src/variants/index.rs:90-122):
    a text is tokenized against ``word_dict`` and embedded as the normalized
    sum of all its known words' rows of ``embeddings``, on the index's device."""

    def __init__(self, index: Granne, embeddings, word_dict):
        from .elements.embeddings import SumEmbeddings

        self.index = index
        self.words = word_dict
        self._embedder = SumEmbeddings.from_parts(embeddings, [[0]], device=index.elements.device)

    def _to_vector(self, query) -> np.ndarray:
        if isinstance(query, str):
            return self._embedder.create_embedding(self.words.to_ids(query))
        return np.asarray(query, np.float32)

    def search(self, query, max_search: int = DEFAULT_MAX_SEARCH, num_elements: int = DEFAULT_NUM_ELEMENTS):
        return self.index.search(self._to_vector(query), max_search, num_elements)

    def get_internal_vector(self, query) -> np.ndarray:
        return self._to_vector(query)

    def get_element(self, idx: int) -> np.ndarray:
        """The element's vector (py/src/variants/index.rs:112-114)."""
        return self.index.get_element(idx)

    def get_internal_element(self, idx: int):
        """The element's words (py/src/variants/index.rs:116-121), or the
        index's own form when its elements are not term lists."""
        get_terms = getattr(self.index.elements, "get_terms", None)
        if get_terms is None:
            return self.index.get_internal_element(idx)
        return [self.words.words[t] for t in get_terms(idx)]


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
        elements=None,
        **config_kwargs,
    ):
        """``elements``, an element container to continue from, sets the
        kind, ``dim`` and ``device`` (see ``from_elements``)."""
        if elements is not None:
            element_type, dim, device = _element_kind(elements), elements.dim, elements.device
        else:
            _element_class(element_type)
        if config is None:
            config = BuildConfig(**config_kwargs)
        elif config_kwargs:
            raise ValueError("pass either config or kwargs, not both")
        distance.full_f32()
        self.config = config
        self.device = torch.device(device)
        self.element_type = element_type
        self._dim = dim
        self._pending: list = []  # raw vector batches, or term-id lists for "embeddings"
        self._elements = elements
        self._layers: Optional[LayerStack] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_elements(cls, elements, config: Optional[BuildConfig] = None, **kw) -> "GranneBuilder":
        """Continue from an element container: f32 or int8 vectors, or a
        ``SumEmbeddings`` (kind ``"embeddings"``; its ``append`` takes
        term-id lists)."""
        return cls(config=config, elements=elements, **kw)

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
        """Append one element [d], or a batch [n, d]; for ``"embeddings"``
        one term-id list, or a list of them."""
        if self.element_type == EMBEDDINGS:
            self._pending.extend(_term_lists(vector))
            return
        v = np.asarray(vector, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if self._dim is None:
            self._dim = v.shape[1]
        if v.shape[1] != self._dim:
            raise ValueError(f"dimension mismatch: {v.shape[1]} != {self._dim}")
        self._pending.append(v)

    def _flush(self):
        if self._pending and self.element_type == EMBEDDINGS:
            self._elements = self._elements.extend(self._pending)
            self._pending.clear()
        elif self._pending:
            batch = np.concatenate(self._pending, axis=0)
            self._pending.clear()
            if self._elements is None:
                self._elements = _ELEMENT_TYPES[self.element_type].from_raw(batch, device=self.device)
            else:
                self._elements = self._elements.extend(batch)
        if self._elements is None:  # nothing appended yet: an empty view, not stored
            empty = np.zeros((0, self._dim or 1), np.float32)
            return _ELEMENT_TYPES[self.element_type].from_raw(empty, device=self.device)
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
