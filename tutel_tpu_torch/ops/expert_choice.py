"""Expert-choice routing (Zhou et al., 2022): experts pick tokens
(counterpart: tutel_tpu/ops/expert_choice.py).

Each expert selects its own top-`capacity` tokens by router score, so
every expert processes exactly C rows: no overflow, no dropped-token
asymmetry. A token may be picked by several experts (their outputs sum,
weighted by the gate) or by none (output zero). The auxiliary is the
router z-loss.

The selection is a stable descending sort over the token axis per expert,
whose first C entries are `lax.top_k`'s (tied scores: the lower token
index first; masked tokens score -inf). Encode is a row gather by the
[E, C] token ids, decode a segment sum of the [E, C] rows by token
(`combine_rows`): on the CPU a scatter-add, as JAX's CPU path; on the
card the inverse-map gather (`_combine_fanin`), which sums each token's
rows in a fixed order with no atomic add, so two calls give equal bits.

Expert parallelism (`ec_ep_plan`, `ec_ep_dispatch`, `ec_ep_combine`):
every rank all-gathers the [s, E] scores, runs the replicated top-C, and
moves only the selected rows through the ragged exchange of
`ops.ragged_ep` (its receive side is exactly E_local * C rows); the
combine is the reverse exchange and the segment sum on each token's
owner.
"""

from typing import NamedTuple

import torch

from .. import net
from .ragged_ep import _PermTake, _RaggedA2A2dh


class ECRouting(NamedTuple):
    """indices[e, c] = token id chosen by expert e for its slot c."""
    indices: torch.Tensor            # [E, C] int64
    gates: torch.Tensor              # [E, C] score weight (post-softmax)
    capacity: int                    # C


def expert_choice_routing(scores, capacity, token_mask=None):
    """Each expert's top-`capacity` tokens of scores [S, E] (softmax over
    experts; a chosen pair's gate is its score). C = min(capacity, S).
    token_mask: optional [S] bool; masked tokens score -inf and get gate
    0. Returns ECRouting."""
    s = scores.shape[0]
    capacity = int(min(capacity, s))
    ranked = scores.t()                                  # [E, S]
    if token_mask is not None:
        ranked = torch.where(token_mask.to(torch.bool)[None, :], ranked,
                             torch.full_like(ranked, float("-inf")))
    top_vals, top_idx = torch.sort(ranked, dim=1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :capacity], top_idx[:, :capacity]
    gates = torch.where(torch.isfinite(top_vals), top_vals,
                        torch.zeros_like(top_vals))
    return ECRouting(indices=top_idx, gates=gates.to(scores.dtype),
                     capacity=capacity)


def ec_encode(x, ec: ECRouting, is_postscore=True):
    """[S, M] tokens -> [E, C, M] expert buffers (row gather)."""
    y = x.index_select(0, ec.indices.reshape(-1))
    y = y.reshape(*ec.indices.shape, x.shape[-1])
    if not is_postscore:
        y = y * ec.gates[..., None].to(y.dtype)
    return y


def _combine_scatter(rows, ids, s):
    """out[t] = sum of rows[l] with ids[l] == t; ids outside [0, s) drop
    (JAX's `out.at[ids].add(rows, mode="drop")`)."""
    ids = torch.where((ids >= 0) & (ids < s), ids, torch.full_like(ids, s))
    out = rows.new_zeros((s + 1, rows.shape[-1]))
    return out.index_add(0, ids, rows)[:s]


def _combine_onehot(rows, ids, s):
    """out = onehot(ids) @ rows, accumulated in float32: the selection
    matrix [S, L] as a product."""
    onehot = (ids[None, :] == torch.arange(s, device=ids.device)[:, None])
    return (onehot.float() @ rows.float()).to(rows.dtype)


def _combine_fanin(rows, ids, s, j_slots=8):
    """The inverse-map gather: sort the (id, row) pairs stably, rank each
    row within its token's run, write the row indices into an [S, J]
    inverse map, then gather and sum J rows a token in float32, in the
    order of the rows. Exact whenever no token has more than J rows.
    Returns (out, overflow): overflow is a device bool, true when some
    token had more than J rows (those past the J-th are left out)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    first = torch.searchsorted(sid, sid, side="left")
    rank = torch.arange(n, device=ids.device) - first
    valid = (sid >= 0) & (sid < s) & (rank < j_slots)
    flat = torch.where(valid, sid * j_slots + rank,
                       torch.full_like(sid, s * j_slots))
    inv = torch.full((s * j_slots + 1,), n, dtype=torch.long,
                     device=ids.device)
    inv[flat] = order                     # unique targets, but the sentinel
    inv = inv[:s * j_slots]
    rows_ext = torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])
    picked = rows_ext.index_select(0, inv).reshape(s, j_slots, -1)
    out = torch.sum(picked, dim=1, dtype=torch.float32)
    overflow = torch.any((rank >= j_slots) & (sid >= 0) & (sid < s))
    return out.to(rows.dtype), overflow


def combine_rows(rows, ids, num_tokens, native=None, max_fanin=None):
    """sum_{l: ids[l] == t} rows[l] -> [num_tokens, M]; out-of-range ids
    drop. native=None picks by the rows' device: on the card the
    inverse-map gather (`_combine_fanin`) with J = `max_fanin` slots (a
    bound on the rows any token can get, which the callers know: the
    number of expert slices that can pick it), summing in a fixed order;
    on the CPU the scatter-add, as JAX's CPU path (:160-164)."""
    if native is None:
        native = rows.is_cuda
    s = int(num_tokens)
    if not native:
        return _combine_scatter(rows, ids, s)
    j = min(rows.shape[0], int(max_fanin or rows.shape[0]))
    return _combine_fanin(rows, ids, s, max(j, 1))[0]


def ec_decode(y, ec: ECRouting, num_tokens, is_postscore=True, native=None):
    """[E, C, M] expert outputs -> [S, M] combined (segment sum by token
    owner)."""
    if is_postscore:
        y = y * ec.gates[..., None].to(y.dtype)
    else:
        # prescore zeroed the input rows of dead slots (gate 0: masked
        # tokens, or softmax underflow), but a biased expert maps a zero
        # row to a nonzero one: mask their contribution
        y = y * (ec.gates[..., None] != 0).to(y.dtype)
    return combine_rows(y.reshape(-1, y.shape[-1]), ec.indices.reshape(-1),
                        num_tokens, native=native,
                        max_fanin=ec.indices.shape[0])


def router_z_loss(logits, token_mask=None):
    """z-loss = mean_s (logsumexp_e logits)^2 (ST-MoE)."""
    zsum, cnt = router_z_loss_parts(logits, token_mask)
    return zsum / torch.clamp(cnt, min=1)


def router_z_loss_parts(logits, token_mask=None):
    """(sum, valid count) of the z-loss, so ranks can all-reduce both and
    divide (a mean of the ranks' means would mis-weight unequal masks)."""
    z = torch.logsumexp(logits.float(), dim=-1) ** 2
    if token_mask is not None:
        tm = token_mask.to(torch.bool)
        return (torch.sum(torch.where(tm, z, torch.zeros_like(z))),
                torch.sum(tm).to(z.dtype))
    return torch.sum(z), torch.tensor(float(z.shape[0]), device=z.device)


# ---------------------------------------------------------------------------
# Expert parallelism: the exchange of the selected rows only
# ---------------------------------------------------------------------------

class ECPlan(NamedTuple):
    """The exchange plan of one routing, the same on every rank (it derives
    from the replicated global indices)."""
    send_ids: torch.Tensor    # [E*C] my local token id per send row
    #                           (sentinel s for the pad rows past the total)
    send_counts: torch.Tensor  # [W] rows I send to each rank
    recv_counts: torch.Tensor  # [W] rows I receive from each owner
    perm: torch.Tensor        # [L] slot order -> receive order
    inv_perm: torch.Tensor    # [L] receive order -> slot order


def ec_ep_plan(indices, my_idx, num_local_tokens, world, replicas=1):
    """The ragged-exchange plan from the global indices [E, C] (every rank
    holds them alike). my_idx: this rank's index in the world; s =
    num_local_tokens rows a rank (global token id = rank * s + row);
    replicas: the ranks that hold slices of the same experts (expert
    slicing: `sharded_count` consecutive ranks), each of which receives
    the same selected rows."""
    e, c = indices.shape
    s = num_local_tokens
    e_local = e * replicas // world
    l = e_local * c
    dev = indices.device
    ids_by_d = indices.reshape(world // replicas, l).repeat_interleave(
        replicas, dim=0)                                     # [W, L]
    mine = (ids_by_d // s) == my_idx
    send_counts = mine.sum(dim=1)
    # within each destination: my rows to the front, stably, keeping the
    # destination's slot order (the order its owner-sorted slots expect)
    order = torch.argsort((~mine).to(torch.int8), dim=1, stable=True)
    local = torch.where(mine, ids_by_d - my_idx * s,
                        torch.full_like(ids_by_d, s))
    local_sorted = local.gather(1, order)
    # destination chunks packed one after another
    start = torch.cumsum(send_counts, 0) - send_counts
    cols = torch.arange(l, device=dev)
    valid = cols[None, :] < send_counts[:, None]
    pos = torch.where(valid, start[:, None] + cols[None, :],
                      torch.full_like(local_sorted, world * l))
    send_ids = torch.full((world * l + 1,), s, dtype=torch.long, device=dev)
    send_ids[pos.reshape(-1)] = torch.where(
        valid, local_sorted, torch.full_like(local_sorted, s)).reshape(-1)
    send_ids = send_ids[:world * l]
    # my receive side: the slots of my experts, grouped by owner
    owner_me = ids_by_d[my_idx] // s
    recv_counts = (owner_me[None, :] == torch.arange(
        world, device=dev)[:, None]).sum(dim=1)
    perm = torch.argsort(owner_me, stable=True)
    inv_perm = torch.argsort(perm)
    return ECPlan(send_ids=send_ids, send_counts=send_counts,
                  recv_counts=recv_counts, perm=perm, inv_perm=inv_perm)


def _exchange(t, send_counts, recv_counts, group, output_size, hier):
    """The variable-length exchange whose counts both sides know: flat, or
    the two-level one over hier's (outer, inner) groups."""
    if hier is not None:
        return _RaggedA2A2dh.apply(t, send_counts, recv_counts, hier[0],
                                   hier[1], output_size)
    return net.batch_all_to_all_v(t, send_counts, group,
                                  output_size=output_size,
                                  recv_counts=recv_counts)[0]


def ec_ep_dispatch(x_local, plan: ECPlan, group, e_local, capacity,
                   hier=None):
    """[s, M] local tokens -> [E_local, C, M] expert buffers through the
    ragged exchange (only the selected rows travel). Differentiable: the
    exchange's backward is the reverse exchange, the permutations'
    backward the inverse gathers. hier: None, or the (outer, inner)
    groups of the two-level exchange."""
    l = e_local * capacity
    x_ext = torch.cat([x_local, x_local.new_zeros((1, x_local.shape[-1]))])
    send_buf = x_ext.index_select(0, plan.send_ids)        # [E*C, M]
    recv = _exchange(send_buf, plan.send_counts, plan.recv_counts, group, l,
                     hier)
    slot_rows = _PermTake.apply(recv, plan.inv_perm, plan.perm)
    return slot_rows.reshape(e_local, capacity, x_local.shape[-1])


def ec_ep_combine(y, plan: ECPlan, num_local_tokens, group, hier=None,
                  native=None):
    """[E_local, C, M] gated expert outputs -> [s, M] on each token's
    owner: the exchange back and the segment sum (tokens picked by several
    experts, or by several slices of one, sum their rows)."""
    l, m = y.shape[0] * y.shape[1], y.shape[-1]
    back_send = _PermTake.apply(y.reshape(l, m), plan.perm, plan.inv_perm)
    back = _exchange(back_send, plan.recv_counts, plan.send_counts, group,
                     plan.send_ids.shape[0], hier)
    # a rank's rows for a token come from at most W * E_local slices
    world = plan.send_counts.shape[0]
    return combine_rows(back, plan.send_ids, num_local_tokens, native=native,
                        max_fanin=world * y.shape[0])


def expert_choice_forward(scores, logits, x, expert_fn, capacity,
                          is_postscore=True, token_mask=None):
    """The whole EC flow on one rank: route, gather, expert_fn([E, C, M]),
    combine. Returns ([S, M], z_loss)."""
    ec = expert_choice_routing(scores, capacity, token_mask)
    y = expert_fn(ec_encode(x, ec, is_postscore))
    out = ec_decode(y, ec, x.shape[0], is_postscore)
    return out, router_z_loss(logits, token_mask)
