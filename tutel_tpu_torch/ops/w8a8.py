"""Integer-domain grouped GEMM, INT8 activations x INT8/INT4 weights
(W8A8, W4A8), and the two-layer expert FFN built on it
(counterpart: tutel_tpu/ops/w8a8_pallas.py:38-207).

Activations are quantized per row outside the kernels
(`quantize_activations`: symmetric absmax -> int8 and an f32 row scale,
bit for bit the JAX function). The products are int8 x int8 summed in
int32, which is exact, and the result is rescaled by the row scale, then
the weight's column scale: out = (float)acc * sx * sw.

`grouped_gemm_w8a8` launches the CUDA kernel K5 (`csrc/grouped_gemm_w8a8.cu`)
for CUDA tensors and runs its plain PyTorch twin,
`grouped_gemm_w8a8_reference`, for CPU tensors. Rows at or past counts[e]
are zeros (the JAX kernel zeroes whole 256-row blocks past the count and
computes the rest). INT4 weights with blocks == 1 unpack in the kernel;
block-packed INT4 unpacks outside and runs as INT8, as in JAX.

`w8a8_ffn` takes the fused kernel K3 (`ops.fused_ffn.fused_ffn_w8a8`)
when the params carry a stream covering the output width and runs K5
twice otherwise. It narrows by ctx.dispatch_count as JAX does, unrounded.
The JAX package's VMEM ladders (the `bn` budget, the chunk loop of the
fused path) were TPU devices and are gone. Inference only.
"""

import torch

from ..csrc import build
from .fused_ffn import (DTYPE_CODES, check_cuda, counts_i32, fused_ffn_w8a8,
                        live_rows)
from .grouped_gemm_quant import two_call_ffn
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


def grouped_gemm_w8a8(x, qw: QuantizedWeight, counts=None):
    """out[e] = x[e] @ dequant(qw[e]) with the contraction in int8.

    x: [E, C, K] float32/bfloat16 (quantized per row here); qw: INT8 or
    INT4 QuantizedWeight of logical shape [E, K, N]; counts: [E] live rows
    per expert (None = all C). Returns [E, C, N] in x.dtype; rows >=
    counts[e] are zeros. CPU tensors run the plain twin; CUDA tensors run
    kernel K5, and anything the kernel does not take raises.
    """
    e, c, k = x.shape
    ew, kw, n = qw.shape
    if (e, k) != (ew, kw):
        raise ValueError(f"x {tuple(x.shape)} does not match weight "
                         f"{qw.shape}")
    if x.device.type == "cpu":
        return grouped_gemm_w8a8_reference(x, qw, counts)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm_w8a8 runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    vals, bits = _kernel_weight(qw)
    check_cuda("x", x, x.device, x.dtype)
    check_cuda("qw.values", vals, x.device, torch.int8)
    check_cuda("qw.scales", qw.scales, x.device, torch.float32)
    if n % 4 or k % (8 if bits == 4 else 4) or \
            tuple(qw.scales.shape) != (e, 1, n):
        raise ValueError(f"K5 needs N % 4 == 0, K % 4 == 0 (K % 8 for "
                         f"INT4) and scales [E, 1, N]; got N={n}, K={k}, "
                         f"scales {tuple(qw.scales.shape)}")
    xq, sx = quantize_activations(x)
    cnt = counts_i32(counts, e, c, x.device)
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("grouped_gemm_w8a8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_gemm_w8a8_launch(
        xq.data_ptr(), sx.data_ptr(), vals.data_ptr(), qw.scales.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), e, c, k, n, bits,
        DTYPE_CODES[x.dtype], x.device.index or 0, stream)
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
                        output_dim)
