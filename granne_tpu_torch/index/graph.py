"""Dense layer-stack graph (port of ``granne_tpu/index/graph.py``).

Each layer is ONE dense ``int32[n_rows, M]`` device tensor padded with
``UNUSED = -1``.  Rows are sized exactly: the JAX package's power-of-two
row buckets only bound XLA recompiles, which eager PyTorch does not have.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

UNUSED = -1


def empty_layer(n_rows: int, width: int, device="cuda") -> torch.Tensor:
    return torch.full((n_rows, width), UNUSED, dtype=torch.int32, device=device)


def grow_layer(adj: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Return adjacency with at least ``n_rows`` rows (UNUSED fill); ``adj``
    itself when it is already large enough."""
    if adj.shape[0] >= n_rows:
        return adj
    pad = empty_layer(n_rows - adj.shape[0], adj.shape[1], adj.device)
    return torch.cat([adj, pad], dim=0)


@dataclass(frozen=True)
class LayerStack:
    """A stack of adjacency tensors, top (smallest) layer first.

    ``counts`` are the true per-layer element counts; rows beyond a layer's
    count are UNUSED padding.
    """

    layers: tuple  # tuple[torch.Tensor int32[rows_l, M], ...]
    counts: tuple  # tuple[int, ...]

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def num_elements(self) -> int:
        return self.counts[-1] if self.counts else 0

    @property
    def num_neighbors(self) -> int:
        return int(self.layers[0].shape[1]) if self.layers else 0

    def layer_len(self, i: int) -> int:
        return self.counts[i]

    def get_neighbors(self, layer: int, idx: int) -> list[int]:
        row = self.layers[layer][idx].cpu().numpy()
        return [int(x) for x in row if x >= 0]

    def as_numpy(self) -> list[np.ndarray]:
        """Per-layer dense adjacency trimmed to true counts."""
        return [a[:c].cpu().numpy() for a, c in zip(self.layers, self.counts)]

    @classmethod
    def from_numpy(cls, arrays, device="cuda") -> "LayerStack":
        layers = tuple(
            torch.tensor(np.asarray(a, dtype=np.int32), device=device) for a in arrays
        )
        return cls(layers=layers, counts=tuple(int(a.shape[0]) for a in layers))
