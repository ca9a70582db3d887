"""Single-kernel fused quantized expert FFN, fc1 + activation + fc2
(counterpart: tutel_tpu/ops/fused_ffn_pallas.py:64-271,501-519,609-625).

`prepare_fused_ffn` re-lays two QuantizedWeights once into the JAX
package's phase-packed stream, byte for byte: `wstream` int8
[E, T1+T2, Kr, bw] holds the fc1 column tiles then the fc2 column tiles,
and `sb` f32 [E, T1+T2, 2, bw] their scale and bias rows. A stream
prepared by the JAX package therefore converts unchanged
(`convert.from_jax_params`).

`fused_ffn_quant` launches the CUDA kernel K2 (`csrc/fused_ffn_quant.cu`)
for CUDA tensors and runs its plain PyTorch twin,
`fused_ffn_quant_reference`, for CPU tensors. The hidden activations are
rounded to x's dtype before fc2, as in the Pallas kernel. Rows at or past
counts[e] are zeros; the JAX kernel leaves act(b1) @ W2 + b2 there, which
no caller reads. Inference only. Requires H >= K.
"""

import dataclasses

import torch

from ..csrc import build
from .activations import gelu, kernel_code
from .quant import QuantizedWeight, unpack_int4

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block of K2 may use on Hopper (227 KB)
SMEM_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class FusedFFNStream:
    """Phase-packed weight stream for one grouped FFN (see module doc)."""
    wstream: torch.Tensor          # int8 [E, T1+T2, Kr, bw]
    sb: torch.Tensor               # f32 [E, T1+T2, 2, bw] (scales, biases)
    bits: int
    k: int                         # fc1 contraction dim (model dim)
    h: int                         # hidden dim
    n: int                         # fc2 output dim
    t1: int                        # fc1 tiles
    t2: int                        # fc2 tiles
    bw: int                        # tile width (output columns per tile)
    kr: int                        # packed rows per tile


def tile_rows(h, itemsize):
    """Rows per K2 block: the largest of 16, 8, 4 whose relaid x and hidden
    ([rows, H] each) fit in shared memory; None if not even 4 fit."""
    for rows in (16, 8, 4):
        if 2 * rows * h * itemsize <= SMEM_BYTES:
            return rows
    return None


def prepare_fused_ffn(fc1: QuantizedWeight, fc2: QuantizedWeight,
                      fc1_b=None, fc2_b=None, bw=None):
    """Build the phase-packed stream for a two-layer grouped FFN.

    fc1: [E, K, H], fc2: [E, H, N] QuantizedWeights of one bit width, with
    blocks == 1 and H >= K. Returns None when the shapes don't qualify
    (the caller then runs the two-call path).
    """
    if not isinstance(fc1, QuantizedWeight) or \
            not isinstance(fc2, QuantizedWeight):
        return None
    if fc1.bits != fc2.bits or fc1.blocks != 1 or fc2.blocks != 1:
        return None
    bits = fc1.bits
    e, k, h = fc1.shape
    e2, h2, n = fc2.shape
    if e != e2 or h != h2 or h < k or tile_rows(h, 4) is None:
        return None
    kr = fc2.values.shape[1]       # packed rows of fc2 (H or H/2)
    if bw is None:
        bw = next((cand for cand in (2048, 1024, 512, 256, 128)
                   if h % cand == 0), None)
        if bw is None:
            return None
    if h % bw:
        return None
    t1 = h // bw
    t2 = -(-n // bw)               # fc2 output columns are padded to bw

    def tile_cols(qw, bias, ncols, nt):
        v = qw.values
        s = qw.scales.float().expand(e, 1, ncols)
        b = (torch.zeros((e, 1, ncols), device=v.device) if bias is None
             else bias.float().reshape(e, 1, ncols))
        pad = nt * bw - ncols
        if pad:
            v, s, b = (torch.nn.functional.pad(t, (0, pad)) for t in (v, s, b))
        if v.shape[1] < kr:
            v = torch.nn.functional.pad(v, (0, 0, 0, kr - v.shape[1]))
        v = v.reshape(e, kr, nt, bw).permute(0, 2, 1, 3)
        sb = torch.cat([s, b], dim=1).reshape(e, 2, nt, bw).permute(0, 2, 1, 3)
        return v, sb

    if fc2_b is not None and fc2_b.shape[-1] != n:
        fc2_b = torch.nn.functional.pad(fc2_b, (0, n - fc2_b.shape[-1]))
    v1, sb1 = tile_cols(fc1, fc1_b, h, t1)
    v2, sb2 = tile_cols(fc2, fc2_b, n, t2)
    return FusedFFNStream(
        wstream=torch.cat([v1, v2], dim=1).contiguous(),
        sb=torch.cat([sb1, sb2], dim=1).contiguous(),
        bits=bits, k=k, h=h, n=n, t1=t1, t2=t2, bw=bw, kr=kr)


def prepare_fused_ffn_params(params, bw=None):
    """A copy of an expert param dict with a "fused_stream" entry, or the
    dict itself when its weights don't qualify."""
    st = prepare_fused_ffn(params.get("fc1_w"), params.get("fc2_w"),
                           params.get("fc1_b"), params.get("fc2_b"), bw=bw)
    if st is None:
        return params
    out = dict(params)
    out["fused_stream"] = st
    return out


def relayout_x(x, bits, kr):
    """[E, C, K] activations in the unpacked row order of the fc1 tiles: for
    INT4 each half zero-padded from K/2 to Kr, for INT8 the tail padded to
    Kr (identity when K == H)."""
    e, c, k = x.shape
    pack = 2 if bits == 4 else 1
    kq = k // pack
    if kr == kq:
        return x
    if bits == 4:
        z = torch.zeros((e, c, kr - kq), dtype=x.dtype, device=x.device)
        return torch.cat([x[:, :, :kq], z, x[:, :, kq:], z], dim=2)
    return torch.nn.functional.pad(x, (0, kr - k))


def live_rows(c, counts, device):
    """[E, C, 1] bool: row r of expert e is below counts[e]."""
    return (torch.arange(c, device=device)[None, :, None]
            < counts.to(device)[:, None, None])


def fused_ffn_quant_reference(x, stream: FusedFFNStream, counts=None,
                              activation_fn=gelu):
    """Plain PyTorch twin of K2: dequantize the stream, einsum in float32,
    scale, add bias; hidden rounded to x's dtype before fc2. Rows at or
    past counts[e] are zeros."""
    e, c, _ = x.shape
    t1, t2, kr, bw = stream.t1, stream.t2, stream.kr, stream.bw
    q = stream.wstream if stream.bits == 8 else unpack_int4(stream.wstream)
    q = q.float()                                     # [E, T, W, bw]
    w = q.shape[2]
    w1 = q[:, :t1].permute(0, 2, 1, 3).reshape(e, w, t1 * bw)
    w2 = q[:, t1:].permute(0, 2, 1, 3).reshape(e, w, t2 * bw)
    sb1 = stream.sb[:, :t1].permute(0, 2, 1, 3).reshape(e, 2, t1 * bw)
    sb2 = stream.sb[:, t1:].permute(0, 2, 1, 3).reshape(e, 2, t2 * bw)
    xp = relayout_x(x, stream.bits, kr).float()
    h = torch.bmm(xp, w1) * sb1[:, 0:1] + sb1[:, 1:2]
    h = activation_fn(h).to(x.dtype)
    out = (torch.bmm(h.float(), w2) * sb2[:, 0:1] + sb2[:, 1:2])
    out = out[..., :stream.n]
    if counts is not None:
        out = torch.where(live_rows(c, counts, x.device), out,
                          torch.zeros_like(out))
    return out.to(x.dtype)


def check_cuda(name, t, device, dtype):
    """Raise unless t is a contiguous `dtype` tensor on `device`."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def counts_i32(counts, e, c, device):
    """counts as a contiguous int32 [E] tensor on `device` (None = all C)."""
    if counts is None:
        return torch.full((e,), c, dtype=torch.int32, device=device)
    if tuple(counts.shape) != (e,):
        raise ValueError(f"counts must be [{e}], got {tuple(counts.shape)}")
    return counts.to(device=device, dtype=torch.int32).contiguous()


def fused_ffn_quant(x, stream: FusedFFNStream, counts=None,
                    activation_fn=gelu):
    """out[e] = act(x[e] @ W1[e] * s1 + b1) @ W2[e] * s2 + b2, one kernel.

    x: [E, C, K] float32/bfloat16; counts: [E] live rows per expert (None =
    all). Returns [E, C, N] in x.dtype; rows >= counts[e] are zeros. CPU
    tensors run the plain twin; CUDA tensors run kernel K2, and anything
    the kernel does not take (another activation, dtype or layout) raises.
    """
    e, c, k = x.shape
    if k != stream.k or e != stream.wstream.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match the stream "
                         f"(E={stream.wstream.shape[0]}, K={stream.k})")
    if x.device.type == "cpu":
        return fused_ffn_quant_reference(x, stream, counts, activation_fn)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_quant runs on cpu or cuda, not "
                         f"{x.device}")
    act = kernel_code(activation_fn)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_cuda("x", x, x.device, x.dtype)
    check_cuda("stream.wstream", stream.wstream, x.device, torch.int8)
    check_cuda("stream.sb", stream.sb, x.device, torch.float32)
    w = (2 if stream.bits == 4 else 1) * stream.kr
    rows = tile_rows(w, x.element_size())
    if rows is None or stream.bw % 4:
        raise ValueError(f"K2 needs bw % 4 == 0 and a hidden width whose "
                         f"4-row tile fits in {SMEM_BYTES} bytes of shared "
                         f"memory; got bw={stream.bw}, H={w}, {x.dtype}")
    cnt = counts_i32(counts, e, c, x.device)
    out = torch.empty((e, c, stream.n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("fused_ffn_quant")
    cuda_stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_ffn_quant_launch(
        x.data_ptr(), stream.wstream.data_ptr(), stream.sb.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), e, c, k, stream.kr, stream.bw,
        stream.t1, stream.t2, stream.n, stream.bits, act, DTYPE_CODES[x.dtype],
        rows, x.device.index or 0, cuda_stream)
    build.check(lib, rc, "fused_ffn_quant")
    fused_ffn_quant.launches += 1
    return out


fused_ffn_quant.launches = 0
