"""Carry an index across from the JAX package.

``granne_tpu``'s ``LayerStack.as_numpy()`` and its ``AngularVectors.vectors``
(as a numpy array) become the port's objects on ``device``; the tests use
this to run the port on JAX-built graphs.  Files written by either package
load in the other (``index.io``), so this is the in-memory path only.
"""

from __future__ import annotations

import numpy as np

from .elements.angular import AngularVectors
from .index.granne import Granne
from .index.graph import LayerStack


def layers_from_numpy(layer_arrays, device="cuda") -> LayerStack:
    """Per-layer int32 adjacency arrays (trimmed to their counts) -> LayerStack."""
    return LayerStack.from_numpy(layer_arrays, device=device)


def granne_from_numpy(layer_arrays, vectors, device="cuda") -> Granne:
    """Adjacency arrays + unit-norm f32 vectors [n, d] -> Granne."""
    return Granne(
        layers=layers_from_numpy(layer_arrays, device=device),
        elements=AngularVectors.from_normalized(np.asarray(vectors, np.float32), device=device),
    )
