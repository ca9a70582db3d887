"""Weight-only INT8 / INT4 quantization for expert weights
(counterpart: tutel_tpu/ops/quant.py).

Symmetric per-(expert, output-channel) scales, q = round(w / s) with
s = max|w| / qmax over the contraction axis; dequant is a column scale
after the dot. INT4 packs two values per int8 byte in split-half order
along the contraction axis, per contiguous K-block (`blocks`): packed row
r of a block holds w[r] in the low nibble and w[r + Kb/2] in the high
nibble. The packing is byte-identical to the JAX package's, so weights
quantized there load here unchanged.

`quantize_activations` is the per-row INT8 activation quantizer of the
W8A8 path (counterpart: tutel_tpu/ops/w8a8_pallas.py:38), and `int_bmm`
the exact integer product the W8A8 twins use.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """Per-expert quantized weight of logical shape [E, K, N].

    values: int8 [E, K, N] (bits=8) or [E, K//2, N] nibble-packed (bits=4).
    scales: float32 [E, 1, N] per-output-channel scales.
    """
    values: torch.Tensor
    scales: torch.Tensor
    bits: int
    orig_k: int
    blocks: int = 1

    @property
    def shape(self):
        k = self.values.shape[1] * (2 if self.bits == 4 else 1)
        return (self.values.shape[0], k, self.values.shape[2])

    @property
    def ndim(self):
        return 3

    def to(self, device):
        return dataclasses.replace(self, values=self.values.to(device),
                                   scales=self.scales.to(device))


def quantize(w, bits=8, shard_blocks=1):
    """Quantize [E, K, N] (or [K, N], treated as E=1) weights to INT8/INT4.

    shard_blocks: split-half INT4 packing is applied within each of this
    many contiguous K-blocks, so a K-slice of one block unpacks on its own.
    """
    if bits not in (8, 4):
        raise ValueError(f"unsupported bit width: {bits}")
    if w.ndim == 2:
        w = w[None]
    e, k, n = w.shape
    qmax = 127.0 if bits == 8 else 7.0
    w32 = w.float()
    absmax = torch.amax(torch.abs(w32), dim=1, keepdim=True)       # [E, 1, N]
    scales = torch.where(absmax > 0, absmax / qmax,
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scales), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        if k % (2 * shard_blocks):
            raise ValueError(f"INT4 needs K divisible by 2*shard_blocks, "
                             f"got {k} / {shard_blocks}")
        qb = q.reshape(e, shard_blocks, k // shard_blocks, n).to(torch.int32)
        half = k // (2 * shard_blocks)
        byte = (qb[:, :, :half, :] & 0xF) | ((qb[:, :, half:, :] & 0xF) << 4)
        byte = torch.where(byte >= 128, byte - 256, byte)   # two's complement
        q = byte.to(torch.int8).reshape(e, k // 2, n)
    return QuantizedWeight(values=q, scales=scales, bits=bits, orig_k=k,
                           blocks=shard_blocks)


def unpack_int4(packed, blocks=1):
    """[.., K//2, N] packed int8 -> [.., K, N] int8 in [-8, 7], split-half
    order within each of `blocks` contiguous K-blocks."""
    lead = packed.shape[:-2]
    kp, n = packed.shape[-2:]
    v = packed.reshape(*lead, blocks, kp // blocks, n).to(torch.int32)
    low = ((v & 0xF) ^ 8) - 8          # sign-extend the low nibble
    high = v >> 4                      # arithmetic shift keeps the sign
    out = torch.cat([low, high], dim=-2)
    return out.reshape(*lead, 2 * kp, n).to(torch.int8)


def unpack(qw: QuantizedWeight):
    """[E, K, N] int8 weight values of a QuantizedWeight."""
    return qw.values if qw.bits == 8 else unpack_int4(qw.values, qw.blocks)


def dequantize(qw: QuantizedWeight, dtype=torch.float32):
    """Dense [E, K, N] weights."""
    return (unpack(qw).float() * qw.scales).to(dtype)


def quantize_expert_params(params, bits=8, keys=("fc1_w", "fc2_w",
                                                 "w1", "w2", "w3"),
                           sharded_count=1, k_sliced=("fc2_w", "w3")):
    """Quantize the weight matrices of an expert param dict; biases and
    other entries pass through. sharded_count > 1 packs the K-sliced INT4
    matrices per shard block."""
    out = {}
    for name, p in params.items():
        if name in keys and isinstance(p, torch.Tensor) and p.ndim == 3:
            blocks = sharded_count if (bits == 4 and name in k_sliced
                                       and sharded_count > 1) else 1
            out[name] = quantize(p, bits=bits, shard_blocks=blocks)
        else:
            out[name] = p
    return out


def quantize_activations(x):
    """Symmetric per-row INT8 over the last axis: (q int8, scales f32
    [..., 1]) with x ~= q * scales; an all-zero row gets scale 1."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, division by a Python scalar multiplies by
    # its reciprocal, which can miss the quotient (and K3's scale) by an ulp
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scales), -128, 127).to(torch.int8)
    return q, scales


def int_bmm(a, b):
    """Exact batched product of integer-valued tensors, as float32: the
    sums run in float64, which holds every int8 x int8 sum of up to 2**38
    terms exactly (the kernels sum in int32)."""
    return torch.bmm(a.double(), b.double()).float()
