"""Grouped GEMM with fused INT8/INT4 weight dequantization, and the
quantized two-layer expert FFN (counterpart: tutel_tpu/ops/
grouped_gemm_pallas.py:34-226).

`grouped_gemm_quant` launches the CUDA kernel K1 (`csrc/grouped_gemm_quant.cu`)
for CUDA tensors and runs its plain PyTorch twin,
`grouped_gemm_quant_reference`, for CPU tensors. Rows at or past
counts[e] are zeros. Inference only, as in the JAX package.

`quantized_ffn` takes the fused kernel K2 (`ops/fused_ffn.py`) whenever the
expert params carry a fused stream that covers the output width, and runs
K1 twice otherwise. The JAX package's VMEM ladders (`vmem_bytes`, the chunk
loop and the `bn` budget) were TPU devices and are gone.
"""

import torch

from ..csrc import build
from .fused_ffn import (DTYPE_CODES, check_cuda, counts_i32, fused_ffn_quant,
                        live_rows)
from .quant import QuantizedWeight, unpack


def grouped_gemm_quant_reference(x, qw: QuantizedWeight, counts=None):
    """Plain PyTorch twin of K1: dequantize, einsum in float32, scale.
    Rows at or past counts[e] are zeros."""
    acc = torch.bmm(x.float(), unpack(qw).float()) * qw.scales
    if counts is not None:
        acc = torch.where(live_rows(x.shape[1], counts, x.device), acc,
                          torch.zeros_like(acc))
    return acc.to(x.dtype)


def grouped_gemm_quant(x, qw: QuantizedWeight, counts=None):
    """out[e] = x[e] @ dequant(qw[e]); rows >= counts[e] are zeros.

    x: [E, C, K] float32/bfloat16; qw: QuantizedWeight of logical shape
    [E, K, N]; counts: [E] live rows per expert (None = all C rows).
    Returns [E, C, N] in x.dtype. CPU tensors run the plain twin; CUDA
    tensors run kernel K1, and anything the kernel does not take raises.
    """
    e, c, k = x.shape
    ew, kw, n = qw.shape
    if (e, k) != (ew, kw):
        raise ValueError(f"x {tuple(x.shape)} does not match weight "
                         f"{qw.shape}")
    if x.device.type == "cpu":
        return grouped_gemm_quant_reference(x, qw, counts)
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
        DTYPE_CODES[x.dtype], x.device.index or 0, stream)
    build.check(lib, rc, "grouped_gemm_quant")
    grouped_gemm_quant.launches += 1
    return out


grouped_gemm_quant.launches = 0


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
                        output_dim)


def two_call_ffn(gemm, x, params, counts, activation_fn, output_dim):
    """fc2(act(fc1(x) + b1)) + b2 with one grouped GEMM per layer (K1 or
    K5); bias and activation in x's dtype between the calls."""
    fc1_b, fc2_b = params.get("fc1_b"), params.get("fc2_b")
    y = gemm(x, params["fc1_w"], counts)
    if fc1_b is not None:
        y = y + fc1_b.to(y.dtype)[:, None, :]
    y = activation_fn(y)
    y = gemm(y, params["fc2_w"], counts)
    if fc2_b is not None:
        bias = fc2_b.to(y.dtype)[:, None, :]
        if bias.shape[-1] != output_dim:
            bias = torch.nn.functional.pad(
                bias, (0, output_dim - bias.shape[-1]))
        y = y + bias
    return y
