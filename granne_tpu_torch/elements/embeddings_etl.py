"""Offline ETL for bag-of-embeddings corpora (port of
``granne_tpu/elements/embeddings_etl.py``).

Parse a JSON-lines word dictionary, tokenize a directory of (optionally
gzipped) text files into term-id lists, one worker thread a file, write
element shards, and precompute the summed vectors as int8 codes (the
reference's ``embeddings/parsing.rs``).  Everything but the last step is
host numpy; the precompute runs on the container's device.
"""

from __future__ import annotations

import gzip
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class WordDict:
    """Word <-> id mapping: the id of a word is its line in the file, a line
    being ``{"word": <str>}``, a JSON string, or a bare word."""

    def __init__(self, words: list[str]):
        self.words = list(words)
        self.index = {w: i for i, w in enumerate(self.words)}

    @classmethod
    def from_file(cls, path: str) -> "WordDict":
        words = []
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    words.append(obj["word"] if isinstance(obj, dict) else str(obj))
                except json.JSONDecodeError:
                    words.append(line)
        return cls(words)

    def __len__(self) -> int:
        return len(self.words)

    def get_word(self, idx: int) -> str:
        return self.words[idx]

    def get_id(self, word: str) -> int | None:
        return self.index.get(word)

    def to_ids(self, text: str) -> list[int]:
        """Ids of the known words of ``text``, in order (unknown words dropped)."""
        return [self.index[w] for w in text.split() if w in self.index]


def parse_file(path: str, words: WordDict) -> list[list[int]]:
    """One corpus file -> a term-id list per line with a known word."""
    op = gzip.open if path.endswith(".gz") else open
    out = []
    with op(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            ids = words.to_ids(line.strip())
            if ids:
                out.append(ids)
    return out


def parse_corpus_dir(directory: str, words: WordDict, max_workers: int = 8) -> list[list[int]]:
    """Every file of ``directory`` in name order, one worker a file."""
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory) if os.path.isfile(os.path.join(directory, f))
    )
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(lambda p: parse_file(p, words), files))
    return [lst for r in results for lst in r]


def get_shard_name(shard: int, total: int) -> str:
    """Zero-padded shard name (parsing.rs:50-61)."""
    digits = len(str(total - 1)) if total > 1 else 1
    return f"shard-{shard:0{digits}d}-of-{total}"


def write_shards(term_lists: list[list[int]], out_dir: str, num_shards: int) -> list[str]:
    """Split term lists into ``num_shards`` ``.npz`` files, each with the
    padded terms of its slice (the width of the longest list overall) and
    its bounds ``lo``, ``hi``.  Returns the paths."""
    from .embeddings import pad_term_lists

    os.makedirs(out_dir, exist_ok=True)
    bounds = np.linspace(0, len(term_lists), num_shards + 1).astype(int)
    width = max((len(t) for t in term_lists), default=1)
    paths = []
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        path = os.path.join(out_dir, get_shard_name(s, num_shards))
        np.savez(path, terms=pad_term_lists(term_lists[lo:hi], width), lo=lo, hi=hi)
        paths.append(path + ".npz")
    return paths


def precompute_quantized_vectors(container, chunk: int = 4096):
    """Every element's summed unit vector as int8 codes (parsing.rs:103-152):
    an ``AngularIntVectors`` on the container's device, built ``chunk``
    elements at a time.  The unit vectors come from
    ``embeddings.unit_rows_lane_order``, so the codes are the same on the
    card and the CPU, and equal to the JAX package's on the CPU."""
    from .angular_int import AngularIntVectors
    from .embeddings import unit_rows_lane_order

    dev = container.device
    n = len(container)
    parts = [
        unit_rows_lane_order(container, torch.arange(lo, min(n, lo + chunk), device=dev))
        for lo in range(0, n, chunk)
    ]
    vecs = torch.cat(parts) if parts else torch.zeros((0, container.dim), dtype=torch.float32, device=dev)
    return AngularIntVectors.from_raw(vecs, device=dev)
