"""The grouped IVF search's score rows composed from K3/K4's scores and a
torch epilogue, step by step: the oracle that the pair store
(``ops/kernels/ivf_score.py::ivf_score_pairs``) is held to, bit for bit.
Plain PyTorch on any device, no JAX."""

import torch


def composed_pair_rows(scores, block_ids, block_scales, slots, P):
    """The [P, L] rows of the merge from K3/K4's scores [S, cap, L] and
    ``index/ivf.py::slot_groups``'s ``slots``: the scale, the mask, each
    (slot, place) row gathered to its sorted item and scattered to its pair,
    -inf for pairs no slot holds."""
    keys, _, slot_pairs, item_slot, item_pos, sorted_pairs = slots
    S, cap, L = scores.shape
    ids_g = block_ids[keys.long()]
    scores = scores * block_scales[keys.long()][:, None, :]
    scores = torch.where((slot_pairs >= 0)[:, :, None] & (ids_g >= 0)[:, None, :], scores, -torch.inf)
    lin = torch.where(item_slot >= 0, item_slot * cap + item_pos, 0).long()
    rows = torch.where((item_slot < 0)[:, None], -torch.inf, scores.reshape(S * cap, L)[lin])
    out = torch.full((P, L), -torch.inf, dtype=torch.float32, device=scores.device)
    out[sorted_pairs.long()] = rows
    return out
