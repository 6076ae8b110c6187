"""Geometric layer-size schedule.

Reference parity: ``compute_num_elements_in_layer`` at
granne's ``src/index/mod.rs:633-643`` — layer ``i`` (0 = top) holds
``ceil(total / m^(floor(log_m(total)) - i))`` elements, capped at ``total``.
This module reproduces the formula exactly (tested against the reference's
analytic unit tests, incl. the 1e9-element case, ``src/index/tests.rs:305-335``).
"""

from __future__ import annotations

import math


def num_elements_in_layer(total: int, layer_multiplier: float, layer_idx: int) -> int:
    if total <= 0:
        return 0
    m = float(layer_multiplier)
    top = math.floor(math.log(total) / math.log(m)) if total > 1 else 0
    ideal = math.ceil(total / (m ** (top - layer_idx)))
    return min(ideal, total)


def num_layers(total: int, layer_multiplier: float) -> int:
    """Number of layers a fully built index of ``total`` elements has."""
    if total <= 0:
        return 0
    if total == 1:
        return 1
    m = float(layer_multiplier)
    return math.floor(math.log(total) / math.log(m)) + 1


def layer_counts(total: int, layer_multiplier: float) -> list[int]:
    """Element counts per layer, top first; last entry == total."""
    return [
        num_elements_in_layer(total, layer_multiplier, i)
        for i in range(num_layers(total, layer_multiplier))
    ]
