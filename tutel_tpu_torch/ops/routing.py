"""Top-k token routing for sparse MoE: `extract_critical` and the capacity
math (counterpart: tutel_tpu/ops/routing.py:31-200).

Same decisions as the JAX module: top-k over softmax scores, slot locations
by an exclusive cumsum over the k-major (K*S, E) one-hot stream, optional
batch-prioritized order, gate normalization for k > 1, `token_mask` for
padding rows, and the padded / dropless / capped capacity helpers.

The top-k is a stable descending sort, so tied scores go to the lower
expert index first, as `jax.lax.top_k` orders them (`torch.topk` leaves
the order of ties open); a row of equal scores (a zero padding row: the
LM's expert-parallel padding, an idle serving slot) routes as in JAX.
"""

from typing import NamedTuple, Optional

import torch

from . import losses


class RoutingResult(NamedTuple):
    """Routing decision for one MoE invocation."""
    num_global_experts: int          # E
    indices: torch.Tensor            # [K, S] int64 expert id per (k, token)
    locations: torch.Tensor          # [K, S] int64 row within the expert
    gates: torch.Tensor              # [K, S] gate weight per (k, token)
    capacity: int                    # C
    dispatch_count: torch.Tensor     # [E] int32 tokens routed per expert

    @property
    def top_k(self):
        return self.indices.shape[0]


def cumsum_sub_one(mask, dim=0):
    """Inclusive cumsum minus one."""
    return torch.cumsum(mask, dim=dim) - 1


def compute_locations(masks_kse, importance_order: Optional[torch.Tensor] = None):
    """Per-(k, token) slot index inside its expert's buffer.

    masks_kse: [K, S, E] one-hot assignment masks; importance_order: an
    optional [S] permutation that ranks tokens within every k before the
    cumsum (batch-prioritized routing).
    Returns locations [K, S] int64 and per-expert totals [E] int32.
    """
    k, s, e = masks_kse.shape
    flat = masks_kse.reshape(k * s, e).long()
    if importance_order is not None:
        offsets = (torch.arange(k, device=flat.device) * s)[:, None]
        perm = (importance_order[None, :].long() + offsets).reshape(-1)
        csum = torch.empty_like(flat)
        csum[perm] = cumsum_sub_one(flat[perm], dim=0)
    else:
        csum = cumsum_sub_one(flat, dim=0)
    locations = torch.sum(csum * flat, dim=1).reshape(k, s)
    counts = torch.sum(flat, dim=0).to(torch.int32)
    return locations, counts


def align_capacity(capacity, alignment):
    """Round capacity up to a multiple of `alignment`."""
    remainder = capacity % alignment
    if remainder > 0:
        capacity = capacity + alignment - remainder
    return int(capacity)


def compute_static_capacity(num_samples, num_global_experts, top_k,
                            capacity_factor, alignment=1):
    """Padded-mode capacity (capacity_factor > 0), from Python numbers."""
    if not capacity_factor > 0:
        raise ValueError("static capacity needs capacity_factor > 0")
    samples_per_expert = (num_samples + num_global_experts - 1) // num_global_experts
    capacity = top_k * int(capacity_factor * samples_per_expert)
    return align_capacity(capacity, alignment)


def capped_capacity_limit(num_samples, num_global_experts, top_k,
                          capacity_factor):
    """Upper bound for the capped-dropless mode (capacity_factor < 0)."""
    samples_per_expert = (num_samples + num_global_experts - 1) // num_global_experts
    return top_k * int(-capacity_factor * samples_per_expert)


def extract_critical(scores, top_k, capacity, loss_fn=losses.gshard_loss,
                     batch_prioritized_routing=False, normalize_gate=True,
                     token_mask=None):
    """Route tokens to experts with capacity C.

    scores: [S, E] softmax gate scores; token_mask: optional [S] bool,
    False rows are padding that take no slot and get location -1.
    Returns (RoutingResult, l_aux). Tokens whose location >= capacity are
    dropped at dispatch time.
    """
    num_samples, num_global_experts = scores.shape
    top_k = min(int(top_k), num_global_experts)
    if int(capacity) < 1:
        raise ValueError(
            f"capacity must be >= 1, got {capacity}; raise capacity_factor "
            "or alignment (a zero-size expert buffer cannot be dispatched)")

    topk_gates, topk_indices = torch.sort(scores, dim=1, descending=True,
                                          stable=True)
    topk_gates, topk_indices = topk_gates[:, :top_k], topk_indices[:, :top_k]
    indices_ks = topk_indices.t()                                  # [K, S]
    gates_ks = topk_gates.t()
    experts = torch.arange(num_global_experts, device=scores.device)
    # compare, not F.one_hot: on CUDA one_hot checks its range with a sync
    masks_kse = (indices_ks[:, :, None] == experts).long()
    if token_mask is not None:
        tm = token_mask.to(torch.bool)
        masks_kse = masks_kse * tm[None, :, None]
        gates_ks = gates_ks * tm.to(gates_ks.dtype)[None, :]

    l_aux = loss_fn(scores, topk_indices) if loss_fn is not None else None

    order = None
    if batch_prioritized_routing:
        importance = -torch.max(scores, dim=1).values
        order = torch.argsort(importance, stable=True)
    locations_ks, counts = compute_locations(masks_kse, order)
    if token_mask is not None:
        locations_ks = torch.where(tm[None, :], locations_ks,
                                   torch.full_like(locations_ks, -1))

    if top_k > 1 and normalize_gate:
        denom = torch.clamp(torch.sum(gates_ks, dim=0),
                            min=torch.finfo(gates_ks.dtype).eps)
        gates_ks = gates_ks / denom

    result = RoutingResult(
        num_global_experts=num_global_experts,
        indices=indices_ks,
        locations=locations_ks,
        gates=gates_ks,
        capacity=int(capacity),
        dispatch_count=counts,
    )
    return result, l_aux


def required_capacity(dispatch_count):
    """Tensor scalar: the most tokens any expert received (the dropless
    capacity). No host sync; the caller decides when to read it."""
    return torch.max(dispatch_count)
