"""Grouped (per-expert) GEMM for dropless MoE and the float megablocks FFN
(counterpart: tutel_tpu/ops/grouped_gemm.py).

`grouped_gemm(lhs, rhs, group_sizes)` multiplies each group of
contiguous rows of lhs [T, K] by its expert's rhs [E, K, N]; rows past
sum(group_sizes) are zeros. The JAX function is `lax.ragged_dot`, an XLA
product and no Pallas kernel, so the port computes it with library GEMMs:
bfloat16 CUDA tensors (K and N multiples of 8) take one
`torch._grouped_mm` call over the groups' end offsets, with no host sync;
every other case (the CPU, float32 on the card) one `torch.mm` a non-empty
group, accumulated in float32 as JAX's `preferred_element_type`, after
one host sync for the sizes. The device of the tensors chooses.

`megablocks_ffn` is the float experts' dropless branch: each expert's
count is rounded up to `ctx.megablocks_size` and clipped to C, its first
count rows of the dense [E, C, M] buffer are gathered into ragged rows,
two grouped GEMMs with per-group bias run over them, and the result is
scattered back into a zero [E, C, O] buffer, so rows past the rounded
count are 0 (the padded bmm leaves bias-only rows there; `fast_decode`
reads neither).
"""

import torch

from ..utils import matmul_f32


def _group_ids(ends, rows):
    """Group of each row index (a row at or past the last end clips to the
    last group): the number of group ends at or before it."""
    gid = torch.searchsorted(ends, rows, right=True)
    return torch.clamp(gid, max=ends.shape[0] - 1)


def grouped_gemm(lhs, rhs, group_sizes):
    """out[t] = lhs[t] @ rhs[g(t)] over [T, K] rows grouped contiguously by
    expert (group_sizes [E]); rows past the sum are zeros. A sum past T (a
    truncating exchange dropped rows) cuts the groups at row T: each row
    keeps its group, as in JAX. Returns [T, N] in lhs's dtype."""
    t, k = lhs.shape
    n = rhs.shape[-1]
    rhs = rhs.to(lhs.dtype)
    if lhs.is_cuda and lhs.dtype == torch.bfloat16 and k % 8 == 0 \
            and n % 8 == 0:
        # offsets past T would make the GEMM read and write past the rows
        ends = torch.cumsum(group_sizes, 0).clamp(max=t).to(torch.int32)
        out = torch._grouped_mm(lhs.contiguous(), rhs.contiguous(),
                                offs=ends)
        live = torch.arange(t, device=lhs.device) < ends[-1]
        return torch.where(live[:, None], out, torch.zeros_like(out))
    out = lhs.new_zeros((t, n))
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size:
            rows = slice(start, start + size)
            out[rows] = matmul_f32(lhs[rows], rhs[g]).to(lhs.dtype)
        start += size
    return out


def grouped_bias_add(rows, bias, group_sizes):
    """rows[t] + bias[g(t)]; rows past the groups take the last expert's
    bias, as in JAX (the megablocks scatter drops them)."""
    ends = torch.cumsum(group_sizes, 0)
    gid = _group_ids(ends, torch.arange(rows.shape[0], device=rows.device,
                                        dtype=ends.dtype))
    return rows + bias.index_select(0, gid).to(rows.dtype)


def megablocks_ffn(x, params, ctx, activation_fn, output_dim):
    """Dropless two-layer FFN over the dense [E, C, M] buffer, computing
    only each expert's count rows rounded up to ctx.megablocks_size (see
    module doc). Returns [E, C, output_dim], zeros past the rounded
    counts."""
    e, c, m = x.shape
    counts = getattr(ctx, "dispatch_count", None)
    mega = max(int(getattr(ctx, "megablocks_size", 1)), 1)
    if counts is None:
        counts = torch.full((e,), c, dtype=torch.int32, device=x.device)
    counts = torch.clamp((counts.long() + mega - 1) // mega * mega,
                         max=c).to(torch.int32)

    ends = torch.cumsum(counts, 0)
    rows = torch.arange(e * c, device=x.device, dtype=ends.dtype)
    gid = _group_ids(ends, rows)
    within = rows - (ends - counts).index_select(0, gid)
    live = rows < ends[-1]
    src = gid * c + torch.where(live, within, torch.zeros_like(within))
    y = x.reshape(e * c, m).index_select(0, src)

    y = grouped_gemm(y, params["fc1_w"], counts)
    if params.get("fc1_b") is not None:
        y = grouped_bias_add(y, params["fc1_b"], counts)
    y = activation_fn(y)
    y = grouped_gemm(y, params["fc2_w"], counts)
    if params.get("fc2_b") is not None:
        bias = params["fc2_b"]
        if bias.shape[-1] != output_dim:
            bias = torch.nn.functional.pad(
                bias, (0, output_dim - bias.shape[-1]))
        y = grouped_bias_add(y, bias, counts)

    # scatter back; the rows past the total go to a dropped extra row
    dst = torch.where(live, gid * c + within, torch.full_like(within, e * c))
    out = y.new_zeros((e * c + 1, output_dim))
    out[dst.long()] = y
    return out[:e * c].reshape(e, c, output_dim)
