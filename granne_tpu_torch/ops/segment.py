"""Sort-and-segment grouping (port of ``granne_tpu/ops/segment.py``).

Used by the IVF cluster-centric scorer: (query, cluster) pairs are grouped
by cluster into fixed-capacity slot buffers; a segment longer than ``cap``
spills into further slots for the same key, so hot keys degrade gracefully
instead of dropping items.  Integer-exact: the outputs equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import torch

_BIG = torch.iinfo(torch.int32).max


def group_pairs(keys: torch.Tensor, values: torch.Tensor, *, cap: int, num_slots: int):
    """Group ``values`` by ``keys`` into [num_slots, cap] buffers.

    keys/values: int32[P]; invalid items have key < 0.

    Returns:
      slot_keys: int32[num_slots] key of each slot (-1 unused)
      slot_values: int32[num_slots, cap] (-1 padding)
      item_slot, item_pos: int32[P] location of each *sorted* item (-1 dropped)
      sorted_values, sorted_keys: int32[P] the sorted items (key sentinel for
        invalid items is INT32_MAX)

    Items past the last slot are dropped: their writes land in a spare row
    ``num_slots`` that is cut off, so no index wraps or raises.
    """
    P = keys.shape[0]
    dev = keys.device
    k = torch.where(keys >= 0, keys.to(torch.int32), _BIG)
    sk, order = torch.sort(k, stable=True)
    sv = values.to(torch.int32)[order]
    valid = sk != _BIG
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    seg_head = torch.cat([valid[:1], (sk[1:] != sk[:-1]) & valid[1:]])
    seg_start = torch.cummax(torch.where(seg_head, pos, -1), dim=0).values
    seg_rank = pos - seg_start
    head = valid & (seg_head | (seg_rank % cap == 0))
    slot = torch.cumsum(head.to(torch.int32), dim=0, dtype=torch.int32) - 1
    in_slot = seg_rank % cap

    ok = valid & (slot < num_slots)
    row = torch.where(ok, slot, num_slots).long()
    col = torch.where(ok, in_slot, 0).long()
    slot_keys = torch.full((num_slots + 1,), -1, dtype=torch.int32, device=dev)
    slot_keys[torch.where(head & ok, slot, num_slots).long()] = sk
    slot_values = torch.full((num_slots + 1, cap), -1, dtype=torch.int32, device=dev)
    slot_values[row, col] = sv
    item_slot = torch.where(ok, slot, -1)
    return slot_keys[:num_slots], slot_values[:num_slots], item_slot, in_slot, sv, sk
