"""Sparse token dispatch (encode) and combine (decode), forward only
(counterpart: tutel_tpu/ops/dispatch.py:39-222).

  * `fast_encode`:  [S, M] tokens -> [E, C, M] per-expert buffers
  * `fast_decode`:  [E, C, M] expert outputs -> [S, M] weighted combine

Dropped tokens (location >= capacity) and masked tokens (location -1) take
no slot; unused slots read as zero rows, as the JAX `_take_rows` fill does.
`is_postscore=True` multiplies the gates at decode, False at encode.
The backward passes belong to the training slice.
"""

import torch

from .routing import RoutingResult


def _flat_slot(crit: RoutingResult):
    """[K, S] flat slot index e*C + loc and its validity mask."""
    valid = (crit.locations >= 0) & (crit.locations < crit.capacity)
    flat = crit.indices * crit.capacity + crit.locations
    return flat, valid


def fast_encode(data, crit: RoutingResult, is_postscore=True):
    """Dispatch [S, M] tokens into an [E, C, M] buffer (zeros at unused
    slots). With is_postscore=False each row is scaled by its gate here."""
    s, m = data.shape
    e, c = crit.num_global_experts, crit.capacity
    flat, valid = _flat_slot(crit)
    k = flat.shape[0]
    src = data.unsqueeze(0).expand(k, s, m)
    if not is_postscore:
        src = src * crit.gates.to(data.dtype)[:, :, None]
    # valid slots are unique by construction; the rest land on a spare row
    slot = torch.where(valid, flat, torch.full_like(flat, e * c))
    out = torch.zeros(e * c + 1, m, dtype=data.dtype, device=data.device)
    out[slot.reshape(-1)] = src.reshape(k * s, m)
    return out[:e * c].reshape(e, c, m)


def fast_decode(data, crit: RoutingResult, is_postscore=True):
    """Gather [E, C, M] expert outputs back to token order and sum over k.
    With is_postscore=True each row is scaled by its gate here."""
    e, c, m = data.shape
    if e != crit.num_global_experts or c != crit.capacity:
        raise ValueError(f"buffer {tuple(data.shape)} does not match the "
                         f"routing ({crit.num_global_experts}, "
                         f"{crit.capacity})")
    flat, valid = _flat_slot(crit)
    k, s = flat.shape
    idx = torch.where(valid, flat, torch.zeros_like(flat)).reshape(-1)
    rows = data.reshape(e * c, m).index_select(0, idx).reshape(k, s, m)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    if is_postscore:
        rows = rows * crit.gates.to(rows.dtype)[:, :, None]
    return torch.sum(rows, dim=0)
