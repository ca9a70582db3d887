"""True-dropless expert parallelism over variable-length exchanges
(counterpart: tutel_tpu/ops/ragged_ep.py).

The padded path ships [E_global, C, M] capacity buffers through the
all-to-all even where most slots are empty. This one sends only the routed
rows:

  local routing -> expert-sorted ragged rows (`ops.ragged`) ->
  `net.batch_all_to_all_v` (rows grouped by destination rank) -> a stable
  re-sort by local expert -> the experts' grouped flavour
  (`apply_grouped`: `ops.grouped_gemm`, or K1 / K2 over the dense view for
  quantized weights) -> un-sort -> the return exchange -> the ragged
  combine.

The receive buffer holds `max_recv` rows (a bound the caller picks, as the
MoE layer's probe does); rows past it are dropped and come back as zeros.
Every step is differentiable: the exchanges' backward is the reverse
exchange (`net`'s autograd Function for the flat one, `_RaggedA2A2dh` for
the two-level one), and a permutation gather's is the inverse gather
(`_PermTake`), so the backward runs gathers only, no atomic scatter-add.
"""

import torch

from .. import net
from . import ragged as ragged_ops


def _ragged_a2a(t, send_counts, group, output_size):
    """The flat variable-length exchange into `output_size` rows."""
    out, _ = net.batch_all_to_all_v(t, send_counts, group,
                                    output_size=output_size)
    return out


class _RaggedA2A2dh(torch.autograd.Function):
    """The two-level exchange (`net.batch_all_to_all_v_2dh`); its backward
    is the reverse two-level exchange with the counts swapped."""

    @staticmethod
    def forward(ctx, t, send_counts, recv_counts, outer, inner, output_size):
        ctx.meta = (send_counts, recv_counts, outer, inner, t.shape[0])
        out, _ = net.batch_all_to_all_v_2dh(t, send_counts, outer, inner,
                                            output_size=output_size)
        return out

    @staticmethod
    def backward(ctx, g):
        send_counts, recv_counts, outer, inner, n_in = ctx.meta
        total = int(recv_counts.sum())
        if g.shape[0] < total:            # rows the forward dropped: zeros
            g = torch.cat([g, g.new_zeros((total - g.shape[0],)
                                          + tuple(g.shape[1:]))])
        back, _ = net.batch_all_to_all_v_2dh(g, recv_counts, outer, inner,
                                             output_size=n_in)
        return back, None, None, None, None, None


class _PermTake(torch.autograd.Function):
    """x[order] for a permutation `order`; the backward is the gather by
    its inverse."""

    @staticmethod
    def forward(ctx, x, order, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        inverse, = ctx.saved_tensors
        return g.index_select(0, inverse), None, None


def _expert_ids_from_counts(per_src_expert_counts, recv_starts, n_rows):
    """[n_rows] local expert id of each received row (E_l for the rows
    past the total), and the total. Received rows are source-major blocks;
    inside block s the rows are expert-sorted, per_src_expert_counts[s, e]
    rows an expert."""
    w, e_l = per_src_expert_counts.shape
    rows = torch.arange(n_rows, device=per_src_expert_counts.device)
    src = (rows[:, None] >= recv_starts[None, :]).sum(1) - 1
    src = src.clamp(0, w - 1)
    within = rows - recv_starts[src]
    csum = torch.cumsum(per_src_expert_counts, 1)                # [W, E_l]
    eid = (within[:, None] >= csum[src, :]).sum(1)
    total = recv_starts[-1] + per_src_expert_counts[-1].sum()
    return torch.where(rows < total, eid.clamp(0, e_l - 1),
                       torch.full_like(eid, e_l)), total


def ragged_ep_forward(x_local, crit, expert_params, expert_apply, group,
                      max_recv, is_postscore=True, ctx=None, hier=None):
    """The dropless expert-parallel forward over variable-length exchanges.

    x_local: [S, M] this rank's tokens; crit: their routing over
    E_global experts (`ops.routing.RoutingResult`); expert_params: this
    rank's experts ([E_l, ...]); expert_apply: fn(params, rows [N, M],
    group_sizes [E_l], ctx) -> [N, O], the experts' grouped flavour;
    group: the expert-parallel process group (ranks in expert order);
    max_recv: rows of the receive buffer; hier: None, or the (outer,
    inner) groups of the two-level exchange (the same rows land in the
    same order). Returns [S, O].
    """
    if hier is not None:
        w = net.get_world_size(hier[0]) * net.get_world_size(hier[1])
    else:
        w = net.get_world_size(group)
    e_g = crit.num_global_experts
    if e_g % w:
        raise ValueError(f"{e_g} experts do not split over {w} ranks")
    e_l = e_g // w

    rd = ragged_ops.make_ragged(crit)
    rows = ragged_ops.encode_ragged(x_local, rd, is_postscore=is_postscore)
    t = rows.shape[0]                                     # K * S
    # rows for each destination rank (its experts are contiguous), and each
    # source's counts for this rank's experts
    gs = rd.group_sizes.to(torch.int64).reshape(w, e_l)
    send_counts = gs.sum(1)
    counts_matrix = net.simple_all_to_all(gs, group)      # [W, E_l]
    recv_counts = counts_matrix.sum(1)

    if hier is not None:
        recv_rows = _RaggedA2A2dh.apply(rows, send_counts, recv_counts,
                                        hier[0], hier[1], max_recv)
    else:
        recv_rows = _ragged_a2a(rows, send_counts, group, max_recv)

    recv_starts = torch.cumsum(recv_counts, 0) - recv_counts
    eid, _ = _expert_ids_from_counts(counts_matrix, recv_starts, max_recv)
    # a stable sort by expert groups the rows for the grouped GEMM
    order = torch.argsort(eid, stable=True)
    inverse = torch.argsort(order)
    grouped = _PermTake.apply(recv_rows, order, inverse)
    group_sizes = counts_matrix.sum(0).to(torch.int32)   # [E_l]

    y = expert_apply(expert_params, grouped, group_sizes, ctx)

    y = _PermTake.apply(y, inverse, order)                # source-major
    if hier is not None:
        back_rows = _RaggedA2A2dh.apply(y, recv_counts, send_counts,
                                        hier[0], hier[1], t)
    else:
        back_rows = _ragged_a2a(y, recv_counts, group, t)
    return ragged_ops.decode_ragged(back_rows, rd, is_postscore=is_postscore)
