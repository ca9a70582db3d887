"""Grouped GEMM with fused INT8/INT4 weight dequantization, and the
quantized two-layer expert FFN (counterpart: tutel_tpu/ops/
grouped_gemm_pallas.py:34-226).

`grouped_gemm_quant` launches the CUDA kernel K1 (`csrc/grouped_gemm_quant.cu`)
for CUDA tensors and runs its plain PyTorch twin,
`grouped_gemm_quant_reference`, for CPU tensors. Rows at or past
counts[e] are zeros. Inference only, as in the JAX package.

K1 runs bfloat16 x on the tensor cores (mma.sync with the weights as the
M operand) and float32 x on the CUDA cores. The `tc_*` functions below are
the tensor-core body's fragment mapping and tile walk, mirrored by
`csrc/gemm_tc.cuh` and the kernel, so that the CPU tests can assemble its
products lane by lane.

`grouped_gemm_quant_ragged` runs K1 over rows grouped contiguously by
expert (the ragged layout of expert parallelism's exchange): a gather
into the dense [E, c_max, K] view, one K1 call, a gather back. It is the
JAX function's counterpart; the experts' `apply_grouped` makes the dense
view once for both layers and calls `quantized_ffn`.

`quantized_ffn` takes the fused kernel K2 (`ops/fused_ffn.py`) whenever the
expert params carry a fused stream that covers the output width, and runs
K1 twice otherwise. The JAX package's VMEM ladders (`vmem_bytes`, the chunk
loop and the `bn` budget) were TPU devices and are gone.
"""

import math

import numpy as np
import torch

from ..csrc import build
from .fused_ffn import (DTYPE_CODES, check_cuda, counts_i32, fused_ffn_quant,
                        live_rows)
from .quant import QuantizedWeight, unpack
from .ragged import dense_to_ragged, ragged_starts, ragged_to_dense


def grouped_gemm_quant_reference(x, qw: QuantizedWeight, counts=None):
    """Plain PyTorch twin of K1: dequantize, einsum in float32, scale.
    Rows at or past counts[e] are zeros."""
    acc = torch.bmm(x.float(), unpack(qw).float()) * qw.scales
    if counts is not None:
        acc = torch.where(live_rows(x.shape[1], counts, x.device), acc,
                          torch.zeros_like(acc))
    return acc.to(x.dtype)


# K1's tensor-core fragments (csrc/gemm_tc.cuh): lane = 4 g + t loads VEC
# bytes of a packed row at columns [VEC g, VEC g + VEC) of the warp's strip


def tc_step_rows(bits):
    """Packed rows of one k-step (16 logical k of an m16n8k16 mma)."""
    return 8 if bits == 4 else 16


def tc_load_row(bits, t, load):
    """Packed row, within the k-step, of a lane's load (2 at INT4, 4 at
    INT8): INT4 rows t, t + 4; INT8 rows 2t, 2t + 1, 2t + 8, 2t + 9."""
    if bits == 4:
        return t + 4 * load
    return 2 * t + (load & 1) + 8 * (load >> 1)


def tc_a_col(vec, g, i, h):
    """Column, within the warp's strip, of mma i's M row g + 8h."""
    return vec * g + 2 * i + h


def tc_b_pair(t, r):
    """The staged x pair, within the k-step's 8, of B register r."""
    return t + 4 * r


def tc_pair_k(bits, q, kb):
    """The two logical rows of x that staged pair q meets (k 2j and 2j + 1
    of its mma): at INT4 the low and the high nibble of packed row q in its
    split-half block of kb packed rows, at INT8 rows 2q and 2q + 1."""
    if bits == 4:
        b, i = divmod(q, kb)
        return 2 * b * kb + i, 2 * b * kb + kb + i
    return 2 * q, 2 * q + 1


def _bf16_bits_to_float(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def tc_widen_int4(word, j):
    """Byte j of the uint32 `word` widened as `widen_int4` does it: a byte
    permute (w.j, w.j, (w >> 4).j, (w >> 4).j), a lop3 that puts each
    nibble, xor 8, under the exponent of 128, and one bf16x2 subtraction of
    136. Returns the float32 values of the low and the high half."""
    word = np.asarray(word, np.uint32)
    lo, hi = (word >> (8 * j)) & 0xFF, ((word >> 4) >> (8 * j)) & 0xFF
    r = lo | (lo << 8) | (hi << 16) | (hi << 24)
    v = (r & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    return (_bf16_bits_to_float(v & 0xFFFF) - np.float32(136),
            _bf16_bits_to_float(v >> 16) - np.float32(136))


# K1's tensor-core body (csrc/grouped_gemm_quant.cu): warps a block, the
# most k-steps of x pairs a warp stages at a time, words after a staged row
TC_WARPS = 4
TC_CHUNK_STEPS = 32
TC_PAIR_PAD = 4


def warp_chunk_steps(nsteps):
    """k-steps a warp of K1 or K5 stages at a time (gemm_tc.cuh
    `chunk_steps`): its share of the nsteps k-steps rounded up to whole
    loop turns (4 k-steps), at most TC_CHUNK_STEPS."""
    per_warp = -(-nsteps // TC_WARPS)
    return min(TC_CHUNK_STEPS, -(-per_warp // 4) * 4)


def tc_chunk_steps(bits, k):
    """k-steps of x pairs a warp of K1 stages at a time."""
    kp = k // 2 if bits == 4 else k
    return warp_chunk_steps(-(-kp // tc_step_rows(bits)))


def tc_warp_chunks(nsteps, chunk, warp):
    """[(first, end)] k-steps of each x chunk warp `warp` stages in turn:
    its share [warp * nsteps / 4, (warp + 1) * nsteps / 4) in runs of
    `chunk`."""
    s0, s1 = warp * nsteps // TC_WARPS, (warp + 1) * nsteps // TC_WARPS
    return [(c, min(c + chunk, s1)) for c in range(s0, s1, chunk)]


def tc_smem(bits, vec, rows, k):
    """Shared memory of a block of `rows`-row tiles: each warp's staged x
    chunk, or the warps' partials, whichever is larger; it does not grow
    with K."""
    pairs = TC_WARPS * rows * (8 * tc_chunk_steps(bits, k) + TC_PAIR_PAD) * 4
    return max(pairs, TC_WARPS * rows * (8 * vec + 4) * 4)


def tc_plan(e, c, routed=None, tile_rows=None):
    """(tile rows, row-tile groups) of K1's tensor-core body.

    The tile is 8 or 16 rows (one or two n-blocks of the mma; the launch's
    registers and shared memory follow it): 8 where every row fits (C <= 8)
    or the experts are expected to hold at most 4 live rows each (`routed`
    rows over e experts, a decode step), else 16; `tile_rows` pins it. The
    groups are blocks side by side on one strip of columns, each taking
    every groups-th row tile of the expert: as many as the expected rows
    fill tiles, at most 4 (they share the strip's weights in L2).
    routed=None: every row may be live."""
    expected = c if routed is None else min(c, routed / e)
    rows = tile_rows or (8 if c <= 8 or expected <= 4 else 16)
    return rows, min(4, max(1, math.ceil(expected / rows)))


def tc_row_tiles(count, tile_rows):
    """The tensor-core body's row tiles of an expert with `count` live rows
    (group z of the plan takes tiles z, z + groups, ...): [(first row, live
    rows, n-blocks)], one n-block where a tile has at most 8 live rows."""
    out = []
    for r0 in range(0, count, tile_rows):
        live = min(tile_rows, count - r0)
        out.append((r0, live, 1 if live <= 8 else tile_rows // 8))
    return out


def grouped_gemm_quant(x, qw: QuantizedWeight, counts=None, *, routed=None):
    """out[e] = x[e] @ dequant(qw[e]); rows >= counts[e] are zeros.

    x: [E, C, K] float32/bfloat16; qw: QuantizedWeight of logical shape
    [E, K, N]; counts: [E] live rows per expert (None = all C rows).
    Returns [E, C, N] in x.dtype. CPU tensors run the plain twin; CUDA
    tensors run kernel K1, and anything the kernel does not take raises.
    `routed`: the rows routed to the experts, known on the host (the MoE
    layer's tokens x top-k; None: all E x C), from which `tc_plan` picks
    the bfloat16 body's row tile and groups.
    """
    e, c, k = x.shape
    ew, kw, n = qw.shape
    if (e, k) != (ew, kw):
        raise ValueError(f"x {tuple(x.shape)} does not match weight "
                         f"{qw.shape}")
    if x.device.type == "cpu":
        return grouped_gemm_quant_reference(x, qw, counts)
    return _launch(x, qw, counts, tc_plan(e, c, routed))


def _launch(x, qw: QuantizedWeight, counts, plan):
    """Kernel K1 on CUDA tensors with the tensor-core body's (tile rows,
    groups) given; `grouped_gemm_quant` passes `tc_plan`'s, and
    tools/gemm_tc_sweep.py compares the tiles through here."""
    rows, groups = plan
    if rows not in (8, 16) or groups < 1:
        raise ValueError(f"K1 takes tile_rows 8 or 16 and groups >= 1, got "
                         f"{plan}")
    e, c, k = x.shape
    n = qw.shape[2]
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm_quant runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_cuda("x", x, x.device, x.dtype)
    check_cuda("qw.values", qw.values, x.device, torch.int8)
    check_cuda("qw.scales", qw.scales, x.device, torch.float32)
    kp = qw.values.shape[1]
    if n % 4 or kp % qw.blocks or tuple(qw.scales.shape) != (e, 1, n):
        raise ValueError(f"K1 needs N % 4 == 0, packed K % blocks == 0 and "
                         f"scales [E, 1, N]; got N={n}, packed K={kp}, "
                         f"blocks={qw.blocks}, scales "
                         f"{tuple(qw.scales.shape)}")
    cnt = counts_i32(counts, e, c, x.device)
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("grouped_gemm_quant")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_gemm_quant_launch(
        x.data_ptr(), qw.values.data_ptr(), qw.scales.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), e, c, k, n, qw.bits, qw.blocks,
        DTYPE_CODES[x.dtype], rows, groups, x.device.index or 0, stream)
    build.check(lib, rc, "grouped_gemm_quant")
    grouped_gemm_quant.launches += 1
    return out


grouped_gemm_quant.launches = 0


def grouped_gemm_quant_ragged(rows, qw: QuantizedWeight, group_sizes, c_max):
    """K1 over a ragged row layout (counterpart: tutel_tpu/ops/
    grouped_gemm_pallas.py:264): rows [N, K] grouped contiguously by expert
    (group_sizes [E]) -> [N, N_out]. Rows past c_max of a group are
    dropped (zeros), as are the rows past sum(group_sizes). The kernel
    plans from N routed rows."""
    n = rows.shape[0]
    gs, starts = ragged_starts(group_sizes)
    dense = ragged_to_dense(rows, gs, starts, c_max)
    y = grouped_gemm_quant(dense, qw, torch.clamp(gs, max=c_max), routed=n)
    return dense_to_ragged(y, gs, starts, c_max, n)


def quantized_ffn(x, params, ctx, activation_fn, output_dim):
    """Two-layer FFN over dense [E, C, M] buffers with quantized weights,
    narrowed to the rows routed to each expert (ctx.dispatch_count, rounded
    up to ctx.megablocks_size and clipped to C)."""
    e, c, m = x.shape
    counts = getattr(ctx, "dispatch_count", None)
    if counts is not None:
        mega = max(int(getattr(ctx, "megablocks_size", 1)), 1)
        counts = torch.clamp((counts + mega - 1) // mega * mega, max=c)

    stream = params.get("fused_stream")
    if stream is not None and stream.n >= output_dim:
        out = fused_ffn_quant(x, stream, counts, activation_fn=activation_fn,
                              routed=getattr(ctx, "routed", None))
        return out[..., :output_dim]
    return two_call_ffn(grouped_gemm_quant, x, params, counts, activation_fn,
                        output_dim, routed=getattr(ctx, "routed", None))


def two_call_ffn(gemm, x, params, counts, activation_fn, output_dim, **kw):
    """fc2(act(fc1(x) + b1)) + b2 with one grouped GEMM per layer (K1 or
    K5, each given `kw`); bias and activation in x's dtype between the
    calls."""
    fc1_b, fc2_b = params.get("fc1_b"), params.get("fc2_b")
    y = gemm(x, params["fc1_w"], counts, **kw)
    if fc1_b is not None:
        y = y + fc1_b.to(y.dtype)[:, None, :]
    y = activation_fn(y)
    y = gemm(y, params["fc2_w"], counts, **kw)
    if fc2_b is not None:
        bias = fc2_b.to(y.dtype)[:, None, :]
        if bias.shape[-1] != output_dim:
            bias = torch.nn.functional.pad(
                bias, (0, output_dim - bias.shape[-1]))
        y = y + bias
    return y
