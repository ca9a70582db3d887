"""Integer-domain grouped GEMM, INT8 activations x INT8/INT4 weights
(W8A8, W4A8), and the two-layer expert FFN built on it
(counterpart: tutel_tpu/ops/w8a8_pallas.py:38-207).

Activations are quantized per row (`quantize_activations`: symmetric
absmax -> int8 and an f32 row scale, bit for bit the JAX function). The
products are int8 x int8 summed in int32, which is exact, and the result is
rescaled by the row scale, then the weight's column scale:
out = (float)acc * sx * sw.

`grouped_gemm_w8a8` launches the CUDA kernel K5 (`csrc/grouped_gemm_w8a8.cu`)
for CUDA tensors and runs its plain PyTorch twin,
`grouped_gemm_w8a8_reference`, for CPU tensors. K5 takes x as it is and
quantizes the live rows itself, so a call is one launch, equal to the
twin bit for bit where x is finite (not in a row holding NaN: the
kernel's absmax skips it, the twin's keeps it). Rows at or past
counts[e] are zeros (the JAX kernel zeroes whole 256-row blocks past the
count and computes the rest). INT4 weights with blocks == 1 unpack in the
kernel; block-packed INT4 unpacks outside and runs as INT8, as in JAX.

K5 runs K1's grid (`grouped_gemm_quant.tc_plan`, from the routed rows;
`k5_plan` adds strips a block) over K3's int8 tensor-core fragments
(`fused_ffn.w8a8_*`); the `k5_*` functions below are its plan, k-steps,
staging of the quantized x and shared memory, mirrored by the kernel, so
that the CPU tests can assemble its products lane by lane.

`w8a8_ffn` takes the fused kernel K3 (`ops.fused_ffn.fused_ffn_w8a8`)
when the params carry a stream covering the output width and runs K5
twice otherwise. It narrows by ctx.dispatch_count as JAX does, unrounded.
The JAX package's VMEM ladders (the `bn` budget, the chunk loop of the
fused path) were TPU devices and are gone. Inference only.
"""

import torch

from ..csrc import build
from .fused_ffn import (DTYPE_CODES, check_cuda, counts_i32, fused_ffn_w8a8,
                        live_rows, sm_count, w8a8_step_rows)
from .grouped_gemm_quant import tc_plan, two_call_ffn, warp_chunk_steps
from .quant import QuantizedWeight, int_bmm, quantize_activations, unpack_int4


def _kernel_weight(qw: QuantizedWeight):
    """(values, bits) as the kernel takes them: INT8, or INT4 with one
    packing block; block-packed INT4 is unpacked to INT8 here."""
    if qw.bits == 4 and qw.blocks != 1:
        return unpack_int4(qw.values, qw.blocks), 8
    return qw.values, qw.bits


def grouped_gemm_w8a8_reference(x, qw: QuantizedWeight, counts=None):
    """Plain PyTorch twin of K5: quantize x per row, exact integer product,
    then (float)acc * sx * sw. Rows at or past counts[e] are zeros."""
    xq, sx = quantize_activations(x)
    vals, bits = _kernel_weight(qw)
    q = vals if bits == 8 else unpack_int4(vals)
    out = int_bmm(xq, q) * sx * qw.scales.float()
    if counts is not None:
        out = torch.where(live_rows(x.shape[1], counts, x.device), out,
                          torch.zeros_like(out))
    return out.to(x.dtype)


# K5's body (csrc/grouped_gemm_w8a8.cu): bytes after each staged int8 row,
# k-steps of a lane's load group (a warp loads one group ahead of the one
# it multiplies)
K5_X_PAD = 16
K5_DEPTH = 1
# the most strips of columns a block takes where it quantizes its rows
# once for all of them, the blocks of 16-row tiles an SM holds by their
# registers (the kernel's launch bounds), and the shared memory an SM has
# and a block takes besides its dynamic bytes (the runtime's 1 KB and the
# row scales; k5_plan)
K5_STRIPS = 4
K5_BLOCKS_PER_SM = 3
SM_SMEM_BYTES = 233472
K5_BLOCK_SMEM = 1024 + 64


def k5_steps(bits, k):
    """k-steps (32 k of an m16n8k32 mma) over the packed rows of K."""
    return -(-(k // 2 if bits == 4 else k) // w8a8_step_rows(bits))


def k5_chunk_steps(bits, k):
    """k-steps of x a warp quantizes into shared memory at a time."""
    return warp_chunk_steps(k5_steps(bits, k))


def k5_smem(bits, vec, rows, k, strips=1):
    """Shared memory of a block of `rows`-row tiles: each warp's staged int8
    x chunk, and the warps' int32 partials after it, or over it where the
    block takes one strip; it does not grow with K."""
    xs = 4 * rows * (32 * k5_chunk_steps(bits, k) + K5_X_PAD)
    red = 4 * rows * (8 * vec + 4) * 4
    return xs + red if strips > 1 else max(xs, red)


def k5_plan(e, c, k, n, bits, sms, routed=None):
    """(tile rows, row-tile groups, strips a block) of K5 on a card of
    `sms` SMs: `tc_plan`'s tile and groups, and several strips of columns
    a block where the tile is 16 rows (the experts are expected to fill
    it) and each warp's x fits one chunk, so the block quantizes its rows
    once for all its strips: the most, up to K5_STRIPS, whose blocks still
    fill two waves of the blocks an SM holds (by registers and by shared
    memory, which holds the partials beside x); else one."""
    rows, groups = tc_plan(e, c, routed)
    strips = 1
    if rows == 16 and -(-k5_steps(bits, k) // 4) <= k5_chunk_steps(bits, k):
        vec = 16 if n % 16 == 0 else 4
        columns = -(-n // (8 * vec))
        per_sm = min(K5_BLOCKS_PER_SM, SM_SMEM_BYTES // (
            k5_smem(bits, vec, rows, k, 2) + K5_BLOCK_SMEM))
        while strips < K5_STRIPS and groups * e * -(
                -columns // (2 * strips)) >= 2 * per_sm * sms:
            strips *= 2
    return rows, groups, strips


def k5_stage_words(bits, c, n, chunk, k):
    """[(x index, staged byte)] of the 4-byte words a warp stages for its
    k-steps [c, c + n) (a chunk of at most `chunk`), 8 n a row, each the
    int8 x at x index .. + 3: at INT4 the x of the low nibbles of packed
    rows 16c .. from byte 0, that of the high nibbles (K/2 further on) from
    byte 16 chunk; at INT8 x[32c ..) from byte 0. x index None: past the
    packed rows (INT4) or K (INT8), staged as zeros."""
    kp = k // 2 if bits == 4 else k
    out = []
    for j in range(8 * n):
        if bits == 4:
            hi = j >= 4 * n
            p = 16 * c + 4 * (j - 4 * n if hi else j)
            src = (kp + p if hi else p) if p < kp else None
            out.append((src, p - 16 * c + (16 * chunk if hi else 0)))
        else:
            src = 32 * c + 4 * j
            out.append((src if src < k else None, 4 * j))
    return out


def grouped_gemm_w8a8(x, qw: QuantizedWeight, counts=None, *, routed=None):
    """out[e] = x[e] @ dequant(qw[e]) with the contraction in int8.

    x: [E, C, K] float32/bfloat16 (quantized per row); qw: INT8 or INT4
    QuantizedWeight of logical shape [E, K, N]; counts: [E] live rows per
    expert (None = all C). Returns [E, C, N] in x.dtype; rows >= counts[e]
    are zeros. CPU tensors run the plain twin; CUDA tensors run kernel K5,
    and anything the kernel does not take raises. `routed`: the rows
    routed to the experts, known on the host (the MoE layer's tokens x
    top-k; None: all E x C), from which `k5_plan` picks the row tile,
    groups and strips a block.
    """
    e, c, k = x.shape
    ew, kw, n = qw.shape
    if (e, k) != (ew, kw):
        raise ValueError(f"x {tuple(x.shape)} does not match weight "
                         f"{qw.shape}")
    if x.device.type == "cpu":
        return grouped_gemm_w8a8_reference(x, qw, counts)
    return _launch(x, qw, counts, routed=routed)


def _launch(x, qw: QuantizedWeight, counts, plan=None, routed=None):
    """Kernel K5 on CUDA tensors with the (tile rows, groups, strips) given,
    or `k5_plan`'s from `routed` (plan=None, as `grouped_gemm_w8a8` calls
    it); tools/gemm_tc_sweep.py compares plans through here."""
    e, c, k = x.shape
    n = qw.shape[2]
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm_w8a8 runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    vals, bits = _kernel_weight(qw)
    rows, groups, strips = plan or k5_plan(e, c, k, n, bits,
                                           sm_count(x.device.index), routed)
    if rows not in (8, 16) or groups < 1 or strips < 1:
        raise ValueError(f"K5 takes tile_rows 8 or 16, groups >= 1 and "
                         f"strips >= 1, got {plan}")
    check_cuda("x", x, x.device, x.dtype)
    check_cuda("qw.values", vals, x.device, torch.int8)
    check_cuda("qw.scales", qw.scales, x.device, torch.float32)
    if n % 4 or k % (8 if bits == 4 else 4) or \
            tuple(qw.scales.shape) != (e, 1, n):
        raise ValueError(f"K5 needs N % 4 == 0, K % 4 == 0 (K % 8 for "
                         f"INT4) and scales [E, 1, N]; got N={n}, K={k}, "
                         f"scales {tuple(qw.scales.shape)}")
    cnt = counts_i32(counts, e, c, x.device)
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("grouped_gemm_w8a8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_gemm_w8a8_launch(
        x.data_ptr(), vals.data_ptr(), qw.scales.data_ptr(), cnt.data_ptr(),
        out.data_ptr(), e, c, k, n, bits, DTYPE_CODES[x.dtype], rows, groups,
        strips, x.device.index or 0, stream)
    build.check(lib, rc, "grouped_gemm_w8a8")
    grouped_gemm_w8a8.launches += 1
    return out


grouped_gemm_w8a8.launches = 0


def w8a8_ffn(x, params, ctx, activation_fn, output_dim):
    """Two-layer FFN with both GEMMs in the integer domain, the hidden
    re-quantized between them; narrowed to ctx.dispatch_count rows per
    expert (unrounded). Bias and activation run in x's dtype between the
    two K5 calls, as in JAX."""
    counts = getattr(ctx, "dispatch_count", None) if ctx else None
    stream = params.get("fused_stream")
    if stream is not None and stream.n >= output_dim:
        out = fused_ffn_w8a8(x, stream, counts, activation_fn=activation_fn,
                             routed=getattr(ctx, "routed", None))
        return out[..., :output_dim]
    return two_call_ffn(grouped_gemm_w8a8, x, params, counts, activation_fn,
                        output_dim, routed=getattr(ctx, "routed", None))
