"""Dropless sorted-ragged token layout (counterpart: tutel_tpu/ops/ragged.py).

The (k, token) pairs of a routing decision are sorted by expert id so
each expert's rows are contiguous (a stable sort keeps (k, token) order
within an expert); a grouped GEMM (`ops.grouped_gemm`) runs over the
ragged groups, and `decode_ragged` unsorts and combines. `encode_ragged`
and `decode_ragged` are exact inverses and agree with `fast_encode` /
`fast_decode` at a capacity at or above the largest count.

`ragged_to_dense` / `dense_to_ragged` move rows grouped by expert into the
dense [E, c_max, K] view the quantized kernels take and back
(counterpart: tutel_tpu/ops/grouped_gemm_pallas.py:229-259); they are
gathers, as the JAX functions are XLA gathers.
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


def ragged_starts(group_sizes):
    """(sizes, first rows) of groups of contiguous rows, int64."""
    gs = group_sizes.to(torch.int64)
    return gs, torch.cumsum(gs, 0) - gs


def ragged_to_dense(rows, gs, starts, c_max):
    """rows [N, K] grouped by expert -> the dense [E, c_max, K] view:
    dense[e, c] = rows[starts[e] + c] for c < gs[e] and inside rows, else
    zero."""
    n, e = rows.shape[0], gs.shape[0]
    c = torch.arange(c_max, device=rows.device)[None, :]
    src = torch.where(c < gs[:, None], starts[:, None] + c,
                      torch.full_like(c, n)).clamp(max=n)
    padded = torch.cat([rows, rows.new_zeros((1,) + tuple(rows.shape[1:]))])
    return padded.index_select(0, src.reshape(-1)).reshape(
        e, c_max, *rows.shape[1:])


def dense_to_ragged(y, gs, starts, c_max, n):
    """The dense [E, c_max, M] view -> ragged rows [n, M] (the inverse of
    `ragged_to_dense`); rows past sum(gs), or past a group's c_max, are
    zero."""
    e = gs.shape[0]
    rid = torch.arange(n, device=y.device)
    gid = torch.searchsorted(torch.cumsum(gs, 0), rid, right=True)
    gid = gid.clamp(0, e - 1)
    within = rid - starts[gid]
    live = (rid < gs.sum()) & (within < c_max)
    src = torch.where(live, gid * c_max + within,
                      torch.full_like(rid, e * c_max))
    flat = y.reshape(e * c_max, -1)
    padded = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    return padded.index_select(0, src)
