"""Dropless sorted-ragged token layout (counterpart: tutel_tpu/ops/ragged.py).

The (k, token) pairs of a routing decision are sorted by expert id so
each expert's rows are contiguous (a stable sort keeps (k, token) order
within an expert); a grouped GEMM (`ops.grouped_gemm`) runs over the
ragged groups, and `decode_ragged` unsorts and combines. `encode_ragged`
and `decode_ragged` are exact inverses and agree with `fast_encode` /
`fast_decode` at a capacity at or above the largest count.
"""

from typing import NamedTuple

import torch

from .routing import RoutingResult


class RaggedDispatch(NamedTuple):
    """Sorted-ragged routing layout for one MoE invocation."""
    num_global_experts: int       # E
    sort_order: torch.Tensor      # [T] int64: positions into the flat (k, s)
    inverse_order: torch.Tensor   # [T] int64: scatter-back permutation
    group_sizes: torch.Tensor     # [E] int32 tokens per expert
    gates: torch.Tensor           # [K, S]
    top_k: int                    # K


def make_ragged(crit: RoutingResult) -> RaggedDispatch:
    """The sorted-ragged layout of a routing decision: T = K * S rows, row
    t holding the sort_order[t]-th (k, s) pair of the k-major flat order."""
    k = crit.indices.shape[0]
    order = torch.argsort(crit.indices.reshape(-1), stable=True)
    return RaggedDispatch(
        num_global_experts=crit.num_global_experts,
        sort_order=order,
        inverse_order=torch.argsort(order),
        group_sizes=crit.dispatch_count,
        gates=crit.gates,
        top_k=k)


def encode_ragged(data, rd: RaggedDispatch, is_postscore=True):
    """[S, M] tokens -> [T, M] rows sorted by expert id (T = K * S)."""
    rows = data.index_select(0, rd.sort_order % data.shape[0])
    if not is_postscore:
        g = rd.gates.reshape(-1).index_select(0, rd.sort_order)
        rows = rows * g.to(data.dtype)[:, None]
    return rows


def decode_ragged(rows, rd: RaggedDispatch, is_postscore=True):
    """[T, M] expert outputs in the sorted layout -> [S, M] combined
    tokens."""
    t, m = rows.shape
    k = rd.top_k
    unsorted = rows.index_select(0, rd.inverse_order).reshape(k, t // k, m)
    if is_postscore:
        unsorted = unsorted * rd.gates.to(rows.dtype)[:, :, None]
    return torch.sum(unsorted, dim=0)
