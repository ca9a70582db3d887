"""Sparse token dispatch (encode) and combine (decode), with their backward
passes (counterpart: tutel_tpu/ops/dispatch.py:39-377).

  * `fast_encode`:  [S, M] tokens -> [E, C, M] per-expert buffers
  * `fast_decode`:  [E, C, M] expert outputs -> [S, M] weighted combine

Dropped tokens (location >= capacity) and masked tokens (location -1) take
no slot; unused slots read as zero rows, as the JAX `_take_rows` fill does.
`is_postscore=True` multiplies the gates at decode, False at encode.

Under autograd both go through a `torch.autograd.Function` whose backward
computes what the JAX custom VJPs compute (`_encode_vjp_bwd`,
`_decode_vjp_bwd`), with the same symmetry:
  encode bwd_data == a gather by the token -> slot map (decode-shaped),
  decode bwd_data == a gather by the inverted slot -> token map
                     (encode-shaped),
  bwd_gate        == per-(k, token) dot products accumulated in float32,
                     zero where the gates are not applied on that side.
Every backward step is a gather or a fixed-order reduction (no index_add_
or scatter-add), so two backward calls on a GPU give equal bits. Without
a tensor that needs a gradient the forward runs alone (the serving path).

Also here: the dense top_k == E dispatch (`dense_gates`, `dense_encode`,
`dense_decode`), the forward oracles (`fast_encode_scatter`,
`fast_decode_gather`, `fast_encode_onehot`) and `TutelMoeFastDispatcher`.
"""

import torch

from .routing import RoutingResult


def _flat_slot(crit: RoutingResult):
    """[K, S] flat slot index e*C + loc, invalid entries (dropped or
    masked) clamped to E*C, one past the end; and the validity mask."""
    valid = (crit.locations >= 0) & (crit.locations < crit.capacity)
    flat = crit.indices * crit.capacity + crit.locations
    flat = torch.where(valid, flat, torch.full_like(
        flat, crit.num_global_experts * crit.capacity))
    return flat, valid


def _inverse_slot(flat, e_times_c):
    """[E*C] slot -> flat (k-major) row id k*S + s; empty slots get the
    sentinel K*S. One small integer scatter: the valid slots are unique by
    construction, and the invalid ones land on a spare entry cut off
    after."""
    n = flat.numel()
    inv = torch.full((e_times_c + 1,), n, dtype=flat.dtype,
                     device=flat.device)
    inv[flat.reshape(-1)] = torch.arange(n, dtype=flat.dtype,
                                         device=flat.device)
    return inv[:e_times_c]


def _take_rows(data, idx):
    """data[idx] along dim 0, with rows for idx >= len(data) filled with
    zeros (the dropped-token guard)."""
    n = data.shape[0]
    rows = data.index_select(0, idx.reshape(-1).clamp(max=n - 1)).reshape(
        idx.shape + data.shape[1:])
    keep = (idx < n).reshape(idx.shape + (1,) * (data.ndim - 1))
    return torch.where(keep, rows, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _encode_fwd(data, gates, flat, e, c, prescore):
    s, m = data.shape
    k = flat.shape[0]
    src = data.unsqueeze(0).expand(k, s, m)
    if prescore:
        src = src * gates.to(data.dtype)[:, :, None]
    # valid slots are unique by construction; the rest land on a spare row
    out = torch.zeros(e * c + 1, m, dtype=data.dtype, device=data.device)
    out[flat.reshape(-1)] = src.reshape(k * s, m)
    return out[:e * c].reshape(e, c, m)


class _Encode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, gates, flat, e, c, prescore):
        # data is read again only by bwd_gate
        ctx.save_for_backward(data if prescore else None, gates, flat)
        ctx.prescore = prescore
        ctx.data_dtype = data.dtype
        return _encode_fwd(data, gates, flat, e, c, prescore)

    @staticmethod
    def backward(ctx, g_out):
        data, gates, flat = ctx.saved_tensors
        k, s = flat.shape
        m = g_out.shape[-1]
        # bwd_data: the decode-shaped gather of the buffer's grads
        rows = _take_rows(g_out.reshape(-1, m), flat.reshape(-1)).reshape(
            k, s, m)
        if ctx.prescore:
            d_data = torch.sum(rows * gates.to(g_out.dtype)[:, :, None],
                               dim=0)
            # bwd_gate: per-(k, token) dot, float32 accumulation
            d_gates = torch.sum(rows.float() * data.to(g_out.dtype).float(),
                                dim=-1).to(gates.dtype)
        else:
            d_data = torch.sum(rows, dim=0)
            d_gates = torch.zeros_like(gates)
        return d_data.to(ctx.data_dtype), d_gates, None, None, None, None


def fast_encode(data, crit: RoutingResult, is_postscore=True):
    """Dispatch [S, M] tokens into an [E, C, M] buffer (zeros at unused
    slots). With is_postscore=False each row is scaled by its gate here."""
    e, c = crit.num_global_experts, crit.capacity
    flat, _ = _flat_slot(crit)
    if _needs_grad(data, crit.gates):
        return _Encode.apply(data, crit.gates, flat, e, c, not is_postscore)
    return _encode_fwd(data, crit.gates, flat, e, c, not is_postscore)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_fwd(data, gates, flat, valid, postscore):
    e, c, m = data.shape
    k, s = flat.shape
    idx = torch.where(valid, flat, torch.zeros_like(flat)).reshape(-1)
    rows = data.reshape(e * c, m).index_select(0, idx).reshape(k, s, m)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    if postscore:
        rows = rows * gates.to(rows.dtype)[:, :, None]
    return torch.sum(rows, dim=0)


class _Decode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, gates, flat, valid, postscore):
        # data is read again only by bwd_gate
        ctx.save_for_backward(data if postscore else None, gates, flat)
        ctx.postscore = postscore
        ctx.data_shape, ctx.data_dtype = data.shape, data.dtype
        return _decode_fwd(data, gates, flat, valid, postscore)

    @staticmethod
    def backward(ctx, g):
        data, gates, flat = ctx.saved_tensors
        e, c, m = ctx.data_shape
        k, s = flat.shape
        inv = _inverse_slot(flat, e * c)
        # bwd_data: the encode-shaped gather of the token grads into slot
        # order (the decode-fwd == encode-bwd symmetry)
        token = torch.where(inv < k * s, inv % s, torch.full_like(inv, s))
        d_data = _take_rows(g, token)                           # [E*C, M]
        if ctx.postscore:
            gd = _take_rows(gates.reshape(-1, 1), inv).to(g.dtype)
            d_data = d_data * gd
            # bwd_gate: d_gates[k, s] = <g[s], data[slot(k, s)]>, float32
            rows = _take_rows(data.reshape(e * c, m),
                              flat.reshape(-1)).reshape(k, s, m)
            d_gates = torch.sum(rows.float() * g.float(), dim=-1).to(
                gates.dtype)
        else:
            d_gates = torch.zeros_like(gates)
        return (d_data.reshape(e, c, m).to(ctx.data_dtype), d_gates, None,
                None, None)


def fast_decode(data, crit: RoutingResult, is_postscore=True):
    """Gather [E, C, M] expert outputs back to token order and sum over k.
    With is_postscore=True each row is scaled by its gate here."""
    e, c, _ = data.shape
    if e != crit.num_global_experts or c != crit.capacity:
        raise ValueError(f"buffer {tuple(data.shape)} does not match the "
                         f"routing ({crit.num_global_experts}, "
                         f"{crit.capacity})")
    flat, valid = _flat_slot(crit)
    if _needs_grad(data, crit.gates):
        return _Decode.apply(data, crit.gates, flat, valid, is_postscore)
    return _decode_fwd(data, crit.gates, flat, valid, is_postscore)


# ---------------------------------------------------------------------------
# Dense dispatch: the top_k == num_global_experts case
# ---------------------------------------------------------------------------

def dense_gates(crit: RoutingResult):
    """[S, E] gate weight of token s at expert e (0 where unrouted)."""
    experts = torch.arange(crit.num_global_experts,
                           device=crit.indices.device)
    oh = (crit.indices[:, :, None] == experts).to(crit.gates.dtype)
    return torch.sum(oh * crit.gates[:, :, None], dim=0)


def dense_encode(data, crit: RoutingResult, is_postscore=True):
    """Dispatch when top_k == E and capacity >= S: every expert sees every
    token in token order, [E, S, M]. With no drops the sparse path's slot
    layout is only a per-expert permutation of the same rows, so
    dense_decode(expert(dense_encode(x))) equals the sparse path for any
    row-wise expert. The result is a contiguous buffer, as the expert
    kernels (K1-K5) take only contiguous rows."""
    s, m = data.shape
    e = crit.num_global_experts
    if is_postscore:
        out = data.unsqueeze(0).expand(e, s, m)
    else:
        out = dense_gates(crit).to(data.dtype).t()[:, :, None] * data[None]
    return out.contiguous()


def dense_decode(data, crit: RoutingResult, is_postscore=True):
    """Combine for the dense path: data [E, S, M] -> [S, M]."""
    if is_postscore:
        g_es = dense_gates(crit).to(data.dtype)
        return torch.einsum("se,esm->sm", g_es, data)
    return torch.sum(data, dim=0)


# ---------------------------------------------------------------------------
# Oracles: direct scatter / gather / one-hot forms of the same functions
# ---------------------------------------------------------------------------

def fast_encode_scatter(data, crit: RoutingResult, is_postscore=True):
    """Direct scatter-add encode: the numerics oracle for `fast_encode`."""
    s, m = data.shape
    e, c = crit.num_global_experts, crit.capacity
    flat, _ = _flat_slot(crit)
    if is_postscore:
        src = data.unsqueeze(0).expand(crit.top_k, s, m)
    else:
        src = crit.gates.to(data.dtype)[:, :, None] * data[None]
    out = torch.zeros(e * c + 1, m, dtype=data.dtype, device=data.device)
    out = out.index_add(0, flat.reshape(-1), src.reshape(-1, m))
    return out[:e * c].reshape(e, c, m)


def fast_decode_gather(data, crit: RoutingResult, is_postscore=True):
    """Direct gather decode: the numerics oracle for `fast_decode`."""
    e, c, m = data.shape
    flat, valid = _flat_slot(crit)
    rows = _take_rows(data.reshape(e * c, m), flat)
    if is_postscore:
        gates = torch.where(valid, crit.gates, torch.zeros_like(crit.gates))
        rows = gates.to(data.dtype)[:, :, None] * rows
    else:
        rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return torch.sum(rows, dim=0)


def fast_encode_onehot(data, crit: RoutingResult, is_postscore=True):
    """Encode as a one-hot product, accumulated in float32:
    out[e*C+c] = sum_s onehot[s, e*C+c] * data[s]."""
    s, m = data.shape
    e, c = crit.num_global_experts, crit.capacity
    flat, valid = _flat_slot(crit)
    scale = (valid.to(data.dtype) if is_postscore else torch.where(
        valid, crit.gates, torch.zeros_like(crit.gates)).to(data.dtype))
    slots = torch.arange(e * c, device=data.device)
    oh = (flat[:, :, None] == slots).to(data.dtype) * scale[:, :, None]
    oh = torch.sum(oh, dim=0)                                  # [S, E*C]
    out = oh.float().t() @ data.float()
    return out.to(data.dtype).reshape(e, c, m)


class TutelMoeFastDispatcher:
    """Reusable dispatcher: `update(...)` installs a routing decision, then
    `encode` / `decode` apply it. The object only carries the
    RoutingResult."""

    def __init__(self, num_global_experts, capacity, model_dim,
                 dispatch_dtype=None):
        self.num_global_experts = int(num_global_experts)
        self.capacity = int(capacity)
        self.model_dim = int(model_dim)
        self.dtype = dispatch_dtype
        self._crit = None
        self.is_postscore = True
        self._original_dtype = None

    def update(self, indices_, locations_, gates_, capacity=None,
               is_postscore=True):
        if capacity is not None:
            self.capacity = int(capacity)
        self.is_postscore = is_postscore

        def as_ks(t):
            t = torch.as_tensor(t)
            return t[None] if t.ndim == 1 else t

        ind = as_ks(indices_).long()
        loc = as_ks(locations_).long()
        g = as_ks(gates_)
        experts = torch.arange(self.num_global_experts, device=ind.device)
        counts = torch.sum(ind.reshape(-1, 1) == experts, dim=0).to(
            torch.int32)
        self._crit = RoutingResult(
            num_global_experts=self.num_global_experts, indices=ind,
            locations=loc, gates=g, capacity=self.capacity,
            dispatch_count=counts)

    def _routing(self):
        if self._crit is None:
            raise RuntimeError("call update() first")
        return self._crit

    def encode(self, data):
        crit = self._routing()
        self._original_dtype = data.dtype
        d = data if self.dtype is None else data.to(self.dtype)
        return fast_encode(d, crit, self.is_postscore)

    def decode(self, data):
        out = fast_decode(data, self._routing(), self.is_postscore)
        # back to the caller's dtype where dispatch_dtype compressed it
        if self.dtype is not None and self._original_dtype is not None:
            out = out.to(self._original_dtype)
        return out


fast_dispatcher = TutelMoeFastDispatcher
