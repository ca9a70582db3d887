"""Collectives over process groups (counterpart: tutel_tpu/net.py).

The JAX functions run inside `shard_map` over a mesh axis; these run in
every rank of a `torch.distributed` group (`group=None`: the default
group) with the same calling conventions: the dim-to-dim `all_to_all`,
the two-level `all_to_all_2dh`, the variable-length exchanges with an
`output_size`, the ZeRO flatten-pad helpers and `ZeroOptimizer`. Without
an initialized process group the world is one rank and each collective is
the identity.

Where the JAX function has a gradient the port's is a
`torch.autograd.Function` whose backward is the transposed collective:
an all-to-all's is the reverse all-to-all, an all-gather's a
reduce-scatter (and the other way), a sum all-reduce's a sum all-reduce.
Only collective names that torch 2.11 has are used: `all_to_all_single`,
`all_gather_into_tensor`, `reduce_scatter_tensor`, `all_reduce`.
"""

import torch
import torch.distributed as dist

from .utils import tree_leaves, tree_replace


def _initialized():
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None):
    """Ranks of `group` (1 without a process group)."""
    return dist.get_world_size(group) if _initialized() else 1


def get_world_rank(group=None):
    """This process's rank in `group` (0 without a process group)."""
    return dist.get_rank(group) if _initialized() else 0


def barrier(group=None):
    """Wait for the card's outstanding work, then for every rank."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if _initialized():
        dist.barrier(group)


# ---------------------------------------------------------------------------
# The primitive exchanges, each with its transpose as the backward
# ---------------------------------------------------------------------------

def _exchange_dim0(x, group):
    """Split dim 0 into W equal chunks, send chunk j to rank j, and stack
    the chunks received in source-rank order."""
    x = x.contiguous()
    if not _initialized():
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """The dim-0 all-to-all; its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange_dim0(g, ctx.group), None


def _gather_dim0(x, group):
    x = x.contiguous()
    if not _initialized():
        return x
    out = x.new_empty((get_world_size(group) * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter_dim0(x, group):
    x = x.contiguous()
    if not _initialized():
        return x
    out = x.new_empty((x.shape[0] // get_world_size(group),) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def _reduce(x, group, op=None):
    x = x.clone()
    if _initialized():
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim0(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim0(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """Sum over ranks, and (mode) the sum, the identity or the sum in the
    backward: "both" is psum, "forward" allreduce_forward, "backward"
    allreduce_backward."""

    @staticmethod
    def forward(ctx, x, group, mode):
        ctx.group, ctx.mode = group, mode
        return x.clone() if mode == "backward" else _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "forward":
            return g, None, None
        return _reduce(g, ctx.group), None, None


# ---------------------------------------------------------------------------
# Simple collectives
# ---------------------------------------------------------------------------

def simple_all_reduce(x, group=None, op="sum"):
    """Sum (differentiable), max or min over the ranks of `group`."""
    if op == "sum":
        return _AllReduce.apply(x, group, "both")
    ops = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"unsupported reduce op: {op}")
    return _reduce(x.detach(), group, ops[op])


def simple_all_to_all(x, group=None):
    """Flat all-to-all over dim 0."""
    return _Exchange.apply(x, group)


all_to_all_single = simple_all_to_all


def simple_split(x, group=None, dim=0):
    """This rank's slice of dim."""
    size = get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {size} ranks")
    chunk = x.shape[dim] // size
    return x.narrow(dim, get_world_rank(group) * chunk, chunk)


spatial_split = simple_split


def create_standalone_group(ranks=None):
    """A process group over `ranks` (None: every rank of the world). Every
    rank of the world calls it, in one order, also the ranks outside it
    (torch's `new_group` contract); without a process group it returns
    None, the one-rank world."""
    if not _initialized():
        return None
    return dist.new_group(sorted(ranks) if ranks is not None else None)


def simple_reduce_scatter(x, group=None, dim=0):
    """Sum over ranks, each keeping its slice of dim."""
    y = _ReduceScatter.apply(x.movedim(dim, 0), group)
    return y.movedim(0, dim)


def simple_all_gather(x, group=None, dim=0):
    """Concatenate every rank's x along dim, in rank order."""
    y = _AllGather.apply(x.movedim(dim, 0), group)
    return y.movedim(0, dim)


# the differentiable names of the reference's facade (net.py:530-531)
all_gather = simple_all_gather
reduce_scatter = simple_reduce_scatter


def allreduce_forward(x, group=None):
    """Sum over ranks in the forward, the identity in the backward."""
    return _AllReduce.apply(x, group, "forward")


def allreduce_backward(x, group=None):
    """The identity in the forward, the sum over ranks in the backward:
    the gradient of a replicated input."""
    return _AllReduce.apply(x, group, "backward")


def _shift(x, shift, group):
    """Rank i of `group` sends x to rank (i + shift) % n and receives the
    tensor of rank (i - shift) % n; every rank posts its send and its
    receive in one batch."""
    n, me = get_world_size(group), get_world_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    dst, src = (me + shift) % n, (me - shift) % n
    if group is not None:
        dst = dist.get_global_rank(group, dst)
        src = dist.get_global_rank(group, src)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, dst, group),
            dist.P2POp(dist.irecv, out, src, group)]):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """`ppermute`; its backward is the same hop reversed."""

    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _shift(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.shift, ctx.group), None, None


def ppermute(x, shift=1, group=None):
    """The cyclic shift of a tensor over the ranks of `group` (JAX's
    `lax.ppermute` with the perm [(i, (i + shift) % n)]): rank i sends x to
    rank (i + shift) % n and returns what rank (i - shift) % n sent, a
    tensor of x's shape and dtype. Differentiable; on one rank (or a shift
    of a multiple of n) the identity, with no collective."""
    n = get_world_size(group)
    if n == 1 or shift % n == 0:
        return x
    return _Shift.apply(x, shift, group)


# ---------------------------------------------------------------------------
# Dim-to-dim all-to-all: scatter output_dim, gather input_dim
# ---------------------------------------------------------------------------

def all_to_all(x, input_dim, output_dim, group=None):
    """`all_to_all(y, 1, 0)` turns each rank's [E_global, C, M] into
    [E_local, W*C, M] and `(0, 1)` reverses it: dim `output_dim` is split
    into W chunks, chunk j goes to rank j, and the chunks received are
    concatenated along `input_dim` in source-rank order (JAX's
    `lax.all_to_all(split_axis=output_dim, concat_axis=input_dim,
    tiled=True)`)."""
    if input_dim == output_dim:
        return x
    w = get_world_size(group)
    shape = list(x.shape)
    if shape[output_dim] % w:
        raise ValueError(f"dim {output_dim} of {tuple(x.shape)} does not "
                         f"split over {w} ranks")
    y = x.movedim(output_dim, 0)
    y = y.reshape(w, y.shape[0] // w, *y.shape[1:])
    y = _Exchange.apply(y, group)               # [W (source), chunk, ...]
    y = y.movedim(1, output_dim + 1).movedim(0, input_dim)
    shape[output_dim] //= w
    shape[input_dim] *= w
    return y.reshape(shape)


def all_to_all_2dh(x, input_dim, output_dim, outer_group, inner_group):
    """The two-level all-to-all: element-identical to the flat one over
    the world (outer-major ranks), decomposed into a local row-block
    transpose, an exchange inside the inner group (the ranks of one host)
    and one across the outer group. Only the MoE patterns (1, 0) and
    (0, 1) are implemented; others raise NotImplementedError."""
    if input_dim == output_dim:
        return x
    outer = get_world_size(outer_group)
    inner = get_world_size(inner_group)
    w = outer * inner
    if w == 1:
        return x
    if (input_dim, output_dim) == (1, 0):
        d0 = x.shape[0]
        xs = x.reshape(outer, inner, d0 // w, *x.shape[1:])
        xs = xs.transpose(0, 1).reshape(d0, *x.shape[1:])
        y = all_to_all(xs, 1, 0, inner_group)
        return all_to_all(y, 1, 0, outer_group)
    if (input_dim, output_dim) == (0, 1):
        z = all_to_all(x, 0, 1, outer_group)
        z = all_to_all(z, 0, 1, inner_group)
        d0 = z.shape[0]
        zs = z.reshape(inner, outer, d0 // w, *z.shape[1:])
        return zs.transpose(0, 1).reshape(d0, *z.shape[1:])
    raise NotImplementedError(
        "2DH all-to-all supports (input_dim, output_dim) in "
        "{(1, 0), (0, 1)}; got (%s, %s)" % (input_dim, output_dim))


def pre_expert_permute(x, group_or_size=None):
    """Rows grouped by source rank ([W * L, D1, ...]) regrouped expert-major
    ([L, W * D1, ...]); a pure reshape. `group_or_size`: a group or an int
    world size. Inverse of `post_expert_permute`."""
    w = group_or_size if isinstance(group_or_size, int) \
        else get_world_size(group_or_size)
    if w == 1:
        return x
    y = x.reshape(w, x.shape[0] // w, *x.shape[1:]).transpose(0, 1)
    return y.reshape(y.shape[0], -1, *x.shape[2:])


def post_expert_permute(x, group_or_size=None):
    """Inverse of `pre_expert_permute`."""
    w = group_or_size if isinstance(group_or_size, int) \
        else get_world_size(group_or_size)
    if w == 1:
        return x
    y = x.reshape(x.shape[0], w, x.shape[1] // w, *x.shape[2:])
    return y.transpose(0, 1).reshape(-1, *y.shape[2:])


# ---------------------------------------------------------------------------
# ZeRO flatten-pad helpers
# ---------------------------------------------------------------------------

def zero_gather(x, group=None, full_shape=None):
    """All-gather a flat shard and reshape to the full parameter shape."""
    size = get_world_size(group)
    if full_shape is None:
        full_shape = (x.shape[0] * size,) + tuple(x.shape[1:])
    numel = 1
    for d in full_shape:
        numel *= int(d)
    flat = simple_all_gather(x.reshape(-1), group)
    return flat[:numel].reshape(full_shape)


def zero_shard_shape(full_shape, world_size):
    """Per-rank flat shard length for a parameter of `full_shape`."""
    numel = 1
    for d in full_shape:
        numel *= int(d)
    return (numel + world_size - 1) // world_size


def zero_scatter(x, group=None):
    """This rank's flat shard of x, padded to divide evenly. Returns
    (shard, full numel)."""
    size = get_world_size(group)
    flat = x.reshape(-1)
    numel = flat.shape[0]
    pad = (-numel) % size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(size, -1)[get_world_rank(group)], numel


class ZeroOptimizer:
    """ZeRO stage 1 over a process group (counterpart: tutel_tpu/net.py
    ZeroOptimizer :435-497).

    Each parameter is flattened and padded to a multiple of the world size
    W; this rank keeps the inner optimizer's state for its row of the
    [W, numel / W] view only. A step reduce-scatters the gradients (their
    SUM over the ranks, as JAX's psum_scatter: the data-parallel all-reduce
    of each rank's own loss's gradient), runs the inner optimizer on this
    rank's shard, and all-gathers the shards, trimmed and reshaped. At
    W == 1 it is the inner optimizer over the flattened parameters.

    inner: a `torch.optim.Optimizer` class, its keyword arguments after
    the group. Every rank:

        opt = net.ZeroOptimizer(torch.optim.Adam, group, lr=1e-3)
        state = opt.init(params)        # the inner optimizer over shards
        params, state = opt.step(params, grads, state)

    params and grads are trees of tensors (`utils.tree_leaves` order);
    the state is the inner optimizer, whose parameters are this rank's
    flat shards.
    """

    def __init__(self, inner, group=None, **kwargs):
        self.inner, self.group, self.kwargs = inner, group, kwargs

    def _rows(self, p):
        """p flattened and padded into [W, numel / W]."""
        w = get_world_size(self.group)
        flat = p.reshape(-1)
        pad = (-flat.shape[0]) % w
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        return flat.reshape(w, -1)

    def init(self, params):
        """The inner optimizer over this rank's flat shard of each leaf."""
        me = get_world_rank(self.group)
        shards = [self._rows(p.detach())[me].clone().requires_grad_(True)
                  for p in tree_leaves(params)]
        return self.inner(shards, **self.kwargs)

    def step(self, params, grads, state):
        """(new params, state) after one step on the summed gradients."""
        w, me = get_world_size(self.group), get_world_rank(self.group)
        leaves = tree_leaves(params)
        grads = tree_leaves(grads)
        shards = [p for g in state.param_groups for p in g["params"]]
        with torch.no_grad():
            for s, p, g in zip(shards, leaves, grads):
                s.copy_(self._rows(p)[me])
                rows = self._rows(g.to(p.dtype))
                s.grad = rows[0].clone() if w == 1 else \
                    _scatter_dim0(rows, self.group)[0]
            state.step()
            new = [_gather_dim0(s.detach()[None], self.group).reshape(-1)[
                :p.numel()].reshape(p.shape).to(p.dtype)
                for s, p in zip(shards, leaves)]
        return tree_replace(params, new), state


# ---------------------------------------------------------------------------
# Variable-length collectives
# ---------------------------------------------------------------------------

def _rows_exchange(t, send, recv, n_out, group):
    """Rows [0, sum(send)) of t, sent in blocks of `send` rows to the ranks
    in order, received in blocks of `recv` rows; placed in a zero
    [n_out, ...] buffer (rows past n_out are dropped). Rows past the end of
    t are sent as zeros: the return leg of an exchange whose receive buffer
    dropped rows, and the backward of such an exchange, send fewer rows
    than their counts."""
    src = t[:sum(send)]
    if src.shape[0] < sum(send):
        src = torch.cat([src, src.new_zeros(
            (sum(send) - src.shape[0],) + tuple(t.shape[1:]))])
    src = src.contiguous()
    buf = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
    if _initialized():
        dist.all_to_all_single(buf, src, output_split_sizes=recv,
                               input_split_sizes=send, group=group)
    else:
        buf.copy_(src)
    out = t.new_zeros((n_out,) + tuple(t.shape[1:]))
    k = min(n_out, buf.shape[0])
    out[:k] = buf[:k]
    return out


class _AllToAllV(torch.autograd.Function):
    """The variable-length exchange; its backward sends the gradient rows
    back with the splits swapped."""

    @staticmethod
    def forward(ctx, t, send, recv, n_out, group):
        ctx.meta = (send, recv, t.shape[0], group)
        return _rows_exchange(t, send, recv, n_out, group)

    @staticmethod
    def backward(ctx, g):
        send, recv, n_in, group = ctx.meta
        return _rows_exchange(g, recv, send, n_in, group), None, None, None, \
            None


def _as_list(tensors):
    single = not isinstance(tensors, (list, tuple))
    return single, ([tensors] if single else list(tensors))


def batch_all_to_all_v(tensors, send_counts, group=None, output_size=None,
                       recv_counts=None):
    """Exchange variable-length row blocks of one or more tensors.

    tensors: one tensor or a list of [N, ...] tensors sharing one row
    partitioning: rows sum(send_counts[:d]) : sum(send_counts[:d+1]) go to
    rank d. send_counts: [W] integer tensor. output_size: rows of the
    receive buffer (default N; rows past it are dropped). recv_counts: the
    [W] rows each rank sends here, where the caller knows them (else they
    are exchanged first).
    Returns (received, recv_counts [W] int32): the rows from rank p land
    contiguously in source order, zeros after sum(recv_counts). The counts
    are read on the host (one sync).
    """
    single, tensors = _as_list(tensors)
    send_counts = send_counts.reshape(-1).to(torch.int64)
    if recv_counts is None:
        recv_counts = simple_all_to_all(send_counts.reshape(-1, 1),
                                        group).reshape(-1)
    recv_counts = recv_counts.reshape(-1).to(torch.int64)
    send, recv = send_counts.tolist(), recv_counts.tolist()
    outs = [_AllToAllV.apply(t, send, recv, output_size or t.shape[0], group)
            for t in tensors]
    return (outs[0] if single else outs), recv_counts.to(torch.int32)


def _ragged_regroup(t, seg_counts, new_order):
    """Reorder the segments of a packed ragged buffer: t [N, ...] holds
    len(seg_counts) contiguous segments; output segment p is old segment
    new_order[p]. Rows past the total are zeros."""
    n, k = t.shape[0], seg_counts.shape[0]
    seg_counts = seg_counts.to(torch.int64)
    order = torch.as_tensor(new_order, dtype=torch.int64,
                            device=seg_counts.device)
    old_off = torch.cumsum(seg_counts, 0) - seg_counts
    new_counts = seg_counts[order]
    new_off = torch.cumsum(new_counts, 0) - new_counts
    rows = torch.arange(n, device=t.device)
    seg = torch.clamp(torch.searchsorted(new_off, rows, right=True) - 1,
                      0, k - 1)
    src = old_off[order[seg]] + (rows - new_off[seg])
    src = torch.where(rows < seg_counts.sum(), src, torch.full_like(src, n))
    padded = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
    return padded.index_select(0, src)


def batch_all_to_all_v_2dh(tensors, send_counts, outer_group, inner_group,
                           output_size=None, intermediate_size=None,
                           count_matrix=None):
    """The two-level variable-length exchange: element-identical to
    `batch_all_to_all_v` over the world (rows land in flat, outer-major
    source order), decomposed into an exchange inside the inner group and
    one across the outer group, with the packed buffer regrouped between
    them. send_counts [W] by flat destination (d = o * inner + i);
    intermediate_size: rows of the first phase's buffer (default outer *
    output_size); count_matrix: the [W, W] counts C[src, dst] if known,
    else all-gathered. Returns (received, recv_counts [W])."""
    single, tensors = _as_list(tensors)
    o_sz, i_sz = get_world_size(outer_group), get_world_size(inner_group)
    w = o_sz * i_sz
    send_counts = send_counts.reshape(-1).to(torch.int64)
    if count_matrix is None:
        rows = simple_all_gather(send_counts.reshape(1, -1), inner_group)
        count_matrix = simple_all_gather(rows.reshape(1, -1), outer_group)
    count_matrix = count_matrix.reshape(w, w).to(torch.int64)
    o_m, i_m = get_world_rank(outer_group), get_world_rank(inner_group)
    me = o_m * i_sz + i_m
    dev = send_counts.device
    ord_io = torch.arange(w).reshape(o_sz, i_sz).T.reshape(-1).tolist()
    cnt_a = send_counts.reshape(o_sz, i_sz).sum(0)
    if output_size is None:
        output_size = tensors[0].shape[0]
    if intermediate_size is None:
        intermediate_size = o_sz * output_size
    # m[i_s, o]: rows source (o_m, i_s) sends to (o, i_m)
    src_rows = torch.arange(i_sz, device=dev) + o_m * i_sz
    dst_cols = i_m + i_sz * torch.arange(o_sz, device=dev)
    m = count_matrix[src_rows][:, dst_cols]
    cnt_b = m.sum(0)
    ord_oi = torch.arange(i_sz * o_sz).reshape(i_sz, o_sz).T.reshape(
        -1).tolist()
    outs = []
    for t in tensors:
        ta = _ragged_regroup(t, send_counts, ord_io)
        ra, _ = batch_all_to_all_v(ta, cnt_a, inner_group,
                                   output_size=intermediate_size)
        tb = _ragged_regroup(ra, m.reshape(-1), ord_oi)
        rb, _ = batch_all_to_all_v(tb, cnt_b, outer_group,
                                   output_size=output_size)
        outs.append(rb)
    return (outs[0] if single else outs), \
        count_matrix[:, me].to(torch.int32)


def batch_all_gather_v(tensors, count, group=None, output_size=None):
    """All-gather variable-length row blocks: each rank's first `count`
    rows of [N, ...], packed in rank order into output_size rows (default
    N * W; zeros after the total). Returns (gathered, counts [W] int32)."""
    single, tensors = _as_list(tensors)
    count = torch.as_tensor(count, device=tensors[0].device).reshape(1).to(
        torch.int64)
    counts = simple_all_gather(count, group)
    w = counts.shape[0]
    starts = torch.cumsum(counts, 0) - counts
    outs = []
    for t in tensors:
        n = output_size or t.shape[0] * w
        n_local = t.shape[0]
        g = simple_all_gather(t, group)              # [W * N, ...]
        k = torch.arange(n, device=counts.device)
        src_dev = torch.clamp(torch.searchsorted(starts, k, right=True) - 1,
                              0, w - 1)
        j = k - starts[src_dev]
        src = torch.where(j < counts[src_dev], src_dev * n_local + j,
                          torch.full_like(j, w * n_local))
        padded = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        outs.append(padded.index_select(0, src))
    return (outs[0] if single else outs), counts.to(torch.int32)
