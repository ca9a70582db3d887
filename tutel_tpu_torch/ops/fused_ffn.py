"""Single-kernel fused quantized expert FFNs over one phase-packed weight
stream (counterpart: tutel_tpu/ops/fused_ffn_pallas.py).

`prepare_fused_ffn` re-lays two QuantizedWeights once into the JAX
package's phase-packed stream, byte for byte: `wstream` int8
[E, T1+T2, Kr, bw] holds the fc1 column tiles then the fc2 column tiles,
and `sb` f32 [E, T1+T2, 2, bw] their scale and bias rows.
`prepare_fused_swiglu` does the same for a SwiGLU expert: T1 W1 tiles, T1
W2 tiles, then T2 W3 tiles, with zero bias rows. A stream prepared by the
JAX package therefore converts unchanged (`convert.from_jax_params`).

Three kernels read such a stream, each launched for CUDA tensors, each
with a plain PyTorch twin (`*_reference`) that CPU tensors run:

  * `fused_ffn_quant`, kernel K2 (`csrc/fused_ffn_quant.cu`):
    act(x @ W1 + b1) @ W2 + b2, the hidden rounded to x's dtype;
  * `fused_ffn_w8a8`, kernel K3 (`csrc/fused_ffn_w8a8.cu`): the same FFN
    with x quantized per row to int8 and both products int8 x int8 ->
    int32; the hidden stays float32 and is re-quantized per row in the
    kernel;
  * `fused_swiglu_quant`, kernel K4 (`csrc/fused_swiglu_quant.cu`):
    (act(x @ W1) * (x @ W2)) @ W3, the hidden rounded to x's dtype after
    the activation and after the product, as in the Pallas kernel.

K2 and K4 split each expert's hidden over S blocks (`split_plan`): a
block computes its slice of the hidden and that slice's partial of the
down projection, and with S > 1 a second kernel sums the S partials in
slice order. `split_slices` is the slice plan the kernels share
(`ffn_common.cuh` `split_rows`). `fused_ffn_quant_ragged` runs K2 over
rows grouped contiguously by expert (expert parallelism's ragged layout)
through the dense view of `ops.ragged`.

Rows at or past counts[e] are zeros; the JAX kernels leave bias-only
values there, which no caller reads. The JAX package's VMEM gates and
chunk ladders were TPU devices and are gone: the kernels take any stream
whose hidden row tile fits the card's shared memory. Inference only.
Requires H >= K.
"""

import dataclasses
import functools
import math

import torch

from ..csrc import build
from .activations import gelu, kernel_code, silu
from .quant import QuantizedWeight, int_bmm, quantize_activations, unpack_int4
from .ragged import dense_to_ragged, ragged_starts, ragged_to_dense

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block of the fused kernels may use on Hopper (227 KB)
SMEM_BYTES = 232448
# the hidden split of K2/K4 (ffn_common.cuh): threads per block, packed rows
# per unit of a slice, the reduction buffer's bytes, and the blocks per SM
# a grid should reach (the decode kernel's occupancy)
SPLIT_THREADS = 256
SPLIT_UNIT = 32
RED_BYTES = SPLIT_THREADS * 17 * 4
BLOCKS_PER_SM = 2


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
    """The largest of 16, 8, 4 rows whose x and hidden ([rows, H] each, at
    `itemsize` bytes) fit in shared memory; None if not even 4 fit. The
    prepare functions take a hidden only where 4 float32 rows fit."""
    for rows in (16, 8, 4):
        if 2 * rows * h * itemsize <= SMEM_BYTES:
            return rows
    return None


def max_split(kr):
    """The most slices K2/K4 may split a hidden of kr packed rows into: one
    per SPLIT_UNIT packed rows, or 1 when kr is not a multiple of it."""
    return kr // SPLIT_UNIT if kr % SPLIT_UNIT == 0 else 1


def split_slices(kr, split):
    """[(p0, p1)] for each of `split` slices: the packed rows of the down
    projection each slice owns (`split_rows` in ffn_common.cuh). The
    kr / SPLIT_UNIT units are dealt out evenly and in order; one slice owns
    all kr rows. At INT4 slice [p0, p1) needs the hidden columns [p0, p1)
    and [kr + p0, kr + p1), at INT8 [p0, p1)."""
    if split == 1:
        return [(0, kr)]
    units = kr // SPLIT_UNIT
    return [(SPLIT_UNIT * (s * units // split),
             SPLIT_UNIT * ((s + 1) * units // split)) for s in range(split)]


def slice_hidden(kr, bits, p0, p1):
    """The hidden columns slice [p0, p1) computes, in the order the kernel
    keeps them in shared memory (the low rows, then at INT4 the high)."""
    cols = list(range(p0, p1))
    return cols + list(range(kr + p0, kr + p1)) if bits == 4 else cols


def split_smem(bits, k, kr, n, split, rows, itemsize):
    """Dynamic shared memory of one K2/K4 block (`split_smem` in
    ffn_common.cuh): the reduction buffer; a pass's scale and bias rows
    (its columns: at most the longest slice's hidden columns, or N rounded
    up to 16) in float32; x [rows, K]; the longest hidden slice
    [rows, pack * its packed rows]."""
    pack = 2 if bits == 4 else 1
    longest = max(p1 - p0 for p0, p1 in split_slices(kr, split))
    stage = max(pack * longest, -(-n // 16) * 16)
    return (RED_BYTES + 8 * stage
            + rows * pack * (k // pack + longest) * itemsize)


@functools.lru_cache(maxsize=256)
def live_tiles(e, c, routed, rows):
    """The row tiles of `rows` rows that hold a live row, over e experts of
    capacity c, expected when `routed` rows fall on the experts uniformly
    at random (top-k routing by a balanced gate): e * E[ceil(min(m, c) /
    rows)], m ~ Binomial(routed, 1 / e). routed=None: every row is live."""
    if routed is None:
        return e * -(-c // rows)
    if e == 1:
        return -(-min(routed, c) // rows)
    lp, lq = math.log(1 / e), math.log1p(-1 / e)
    total = below = 0.0
    # m more than 12 standard deviations from the mean adds under 1e-30
    mean, sd = routed / e, math.sqrt(routed / e)
    for m in range(max(0, int(mean - 12 * sd)),
                   min(routed, c, int(mean + 12 * sd) + 2)):
        pm = math.exp(math.lgamma(routed + 1) - math.lgamma(m + 1)
                      - math.lgamma(routed - m + 1) + m * lp
                      + (routed - m) * lq)
        total += pm * -(-m // rows)
        below += pm
    return e * (total + max(0.0, 1.0 - below) * -(-min(routed, c) // rows))


@functools.lru_cache(maxsize=256)
def split_plan(bits, k, kr, n, e, c, itemsize, sms, split=None, routed=None):
    """(split, tile rows) of a K2/K4 call on `sms` SMs, or None when not
    even a 4-row tile fits in shared memory.

    `routed` is the rows the caller routed to the experts (tokens x top-k,
    known on the host; None: all E x C): the row counts lie on the card,
    so the plan reads the live tiles they are expected to fill
    (`live_tiles`). A call whose live 16-row tiles already give
    BLOCKS_PER_SM blocks per SM (a prefill chunk) takes the largest of 16,
    8, 4 rows that fits and one slice. Otherwise (a decode step, a few live
    rows per expert) it takes 4-row tiles, so that no block multiplies many
    padding rows, and the most slices whose live blocks fit in one wave of
    BLOCKS_PER_SM blocks per SM (a second, partial wave costs more than
    the wider slices save), but two where one slice would leave SMs idle;
    at most max_split(kr). `split` pins the slices."""
    target = BLOCKS_PER_SM * sms
    if live_tiles(e, c, routed, 16) >= target:
        s, candidates = 1, (16, 8, 4)
    else:
        tiles = max(live_tiles(e, c, routed, 4), 1.0)
        s = max(int(target // tiles), 2 if tiles < target else 1)
        s = min(max_split(kr), s)
        candidates = (4,)
    s = split or s
    for rows in candidates:
        if split_smem(bits, k, kr, n, s, rows, itemsize) <= SMEM_BYTES:
            return s, rows
    if split is None:             # narrower slices, if they fit
        for s in range(s + 1, max_split(kr) + 1):
            if split_smem(bits, k, kr, n, s, 4, itemsize) <= SMEM_BYTES:
                return s, 4
    return None


@functools.lru_cache(maxsize=16)
def sm_count(index):
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile_cols(qw: QuantizedWeight, bias, ncols, nt, bw, kr):
    """One weight's column tiles: values [E, nt, kr, bw] (columns padded to
    nt * bw, packed rows to kr) and their scale and bias rows
    [E, nt, 2, bw] (a missing bias is zeros)."""
    v = qw.values
    e = v.shape[0]
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


def _stream(parts, bits, k, h, n, t1, t2, bw, kr):
    return FusedFFNStream(
        wstream=torch.cat([v for v, _ in parts], dim=1).contiguous(),
        sb=torch.cat([sb for _, sb in parts], dim=1).contiguous(),
        bits=bits, k=k, h=h, n=n, t1=t1, t2=t2, bw=bw, kr=kr)


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
    if fc2_b is not None and fc2_b.shape[-1] != n:
        fc2_b = torch.nn.functional.pad(fc2_b, (0, n - fc2_b.shape[-1]))
    return _stream([_tile_cols(fc1, fc1_b, h, t1, bw, kr),
                    _tile_cols(fc2, fc2_b, n, t2, bw, kr)],
                   bits, k, h, n, t1, t2, bw, kr)


def prepare_fused_swiglu(w1: QuantizedWeight, w2: QuantizedWeight,
                         w3: QuantizedWeight, bw=None):
    """The phase-packed stream of a SwiGLU expert (`experts.llama_ffn`):
    out = (act(x @ W1) * (x @ W2)) @ W3, W1/W2 [E, K, H], W3 [E, H, N].

    Tiles: t1 W1 tiles, then t1 W2 tiles, then t2 W3 tiles; the bias rows
    of `sb` are zeros. The tile width is the JAX package's choice (the
    largest divisor of H in 2048..128 whose two packed tiles stay under
    12 MB), so a stream prepared by either package is byte-identical.
    Returns None when the shapes don't qualify, as `prepare_fused_ffn`
    does (this includes a hidden row tile too wide for shared memory).
    """
    qs = (w1, w2, w3)
    if any(not isinstance(q, QuantizedWeight) for q in qs):
        return None
    bits = w1.bits
    if any(q.bits != bits or q.blocks != 1 for q in qs):
        return None
    e, k, h = w1.shape
    if w2.shape != (e, k, h):
        return None
    e3, h3, n = w3.shape
    if e3 != e or h3 != h or h < k or tile_rows(h, 4) is None:
        return None
    kr = w3.values.shape[1]        # packed rows of W3 (H or H/2) == max
    budget = 12 * 1024 * 1024
    if bw is None:
        bw = next((cand for cand in (2048, 1024, 512, 256, 128)
                   if h % cand == 0 and 2 * kr * cand <= budget), None)
        if bw is None:
            return None
    if h % bw or 2 * kr * bw > budget:
        return None
    t1 = h // bw
    t2 = -(-n // bw)
    return _stream([_tile_cols(w1, None, h, t1, bw, kr),
                    _tile_cols(w2, None, h, t1, bw, kr),
                    _tile_cols(w3, None, n, t2, bw, kr)],
                   bits, k, h, n, t1, t2, bw, kr)


def prepare_fused_ffn_params(params, bw=None):
    """A copy of an expert param dict with a "fused_stream" entry, or the
    dict itself when its weights don't qualify: the SwiGLU stream for
    w1/w2/w3 experts, the two-layer stream for fc1/fc2 experts."""
    if "w1" in params and "w3" in params:
        st = prepare_fused_swiglu(params.get("w1"), params.get("w2"),
                                  params.get("w3"), bw=bw)
    else:
        st = prepare_fused_ffn(params.get("fc1_w"), params.get("fc2_w"),
                               params.get("fc1_b"), params.get("fc2_b"),
                               bw=bw)
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


def _unpacked(stream: FusedFFNStream):
    """The stream's values as int8 [E, T, W, bw], W = pack * Kr unpacked
    rows in split-half order."""
    return stream.wstream if stream.bits == 8 else unpack_int4(stream.wstream)


def _tiles(stream: FusedFFNStream, q, lo, hi):
    """Tiles [lo, hi) of unpacked values q as one matrix [E, W, nt * bw],
    with their scale and bias rows [E, 2, nt * bw]."""
    e, _, w, bw = q.shape
    nt = hi - lo
    vals = q[:, lo:hi].permute(0, 2, 1, 3).reshape(e, w, nt * bw)
    sb = stream.sb[:, lo:hi].permute(0, 2, 1, 3).reshape(e, 2, nt * bw)
    return vals, sb


def _live_out(out, counts, dtype):
    """out with rows at or past counts[e] zeroed, in `dtype`."""
    if counts is not None:
        out = torch.where(live_rows(out.shape[1], counts, out.device), out,
                          torch.zeros_like(out))
    return out.to(dtype)


def fused_ffn_quant_reference(x, stream: FusedFFNStream, counts=None,
                              activation_fn=gelu):
    """Plain PyTorch twin of K2: dequantize the stream, einsum in float32,
    scale, add bias; hidden rounded to x's dtype before fc2. Rows at or
    past counts[e] are zeros."""
    t1, t2 = stream.t1, stream.t2
    q = _unpacked(stream).float()
    w1, sb1 = _tiles(stream, q, 0, t1)
    w2, sb2 = _tiles(stream, q, t1, t1 + t2)
    xp = relayout_x(x, stream.bits, stream.kr).float()
    h = torch.bmm(xp, w1) * sb1[:, 0:1] + sb1[:, 1:2]
    h = activation_fn(h).to(x.dtype)
    out = torch.bmm(h.float(), w2) * sb2[:, 0:1] + sb2[:, 1:2]
    return _live_out(out[..., :stream.n], counts, x.dtype)


def fused_ffn_w8a8_hidden(x, stream: FusedFFNStream, activation_fn=gelu):
    """K3's re-quantized hidden as its twin computes it: (hq int8 [E, C,
    H], sxh f32 [E, C, 1]) from h = act((float)(xq @ W1) * sx * s1 + b1),
    kept in float32 and quantized per row over all H columns."""
    xq, sx = quantize_activations(x)
    w1, sb1 = _tiles(stream, _unpacked(stream), 0, stream.t1)
    acc = int_bmm(relayout_x(xq, stream.bits, stream.kr), w1)
    return quantize_activations(
        activation_fn(acc * sx * sb1[:, 0:1] + sb1[:, 1:2]))


def fused_ffn_w8a8_reference(x, stream: FusedFFNStream, counts=None,
                             activation_fn=gelu):
    """Plain PyTorch twin of K3: per-row int8 x, exact integer products,
    the float32 hidden re-quantized per row between fc1 and fc2, and
    out = (float)(hq @ W2) * sxh * s2 + b2. Rows at or past counts[e] are
    zeros."""
    hq, sxh = fused_ffn_w8a8_hidden(x, stream, activation_fn)
    t1, t2 = stream.t1, stream.t2
    w2, sb2 = _tiles(stream, _unpacked(stream), t1, t1 + t2)
    out = int_bmm(hq, w2) * sxh * sb2[:, 0:1] + sb2[:, 1:2]
    return _live_out(out[..., :stream.n], counts, x.dtype)


def fused_swiglu_quant_reference(x, stream: FusedFFNStream, counts=None,
                                 activation_fn=silu):
    """Plain PyTorch twin of K4: dequantize the stream, products in
    float32, and the hidden rounded to x's dtype twice, as in the Pallas
    kernel: h = T(act(x @ W1 * s1)), h = T(h * (x @ W2 * s2)), then
    out = h @ W3 * s3. Rows at or past counts[e] are zeros."""
    t1, t2 = stream.t1, stream.t2
    q = _unpacked(stream).float()
    w1, sb1 = _tiles(stream, q, 0, t1)
    w2, sb2 = _tiles(stream, q, t1, 2 * t1)
    w3, sb3 = _tiles(stream, q, 2 * t1, 2 * t1 + t2)
    xp = relayout_x(x, stream.bits, stream.kr).float()
    h = activation_fn(torch.bmm(xp, w1) * sb1[:, 0:1]).to(x.dtype)
    h = (h.float() * (torch.bmm(xp, w2) * sb2[:, 0:1])).to(x.dtype)
    out = torch.bmm(h.float(), w3) * sb3[:, 0:1]
    return _live_out(out[..., :stream.n], counts, x.dtype)


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


def _check_x(name, x, stream: FusedFFNStream):
    """Raise unless x [E, C, K] matches the stream and lies on the CPU or
    a CUDA device."""
    e, _, k = x.shape
    if k != stream.k or e != stream.wstream.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match the stream "
                         f"(E={stream.wstream.shape[0]}, K={stream.k})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def _check_cuda_stream(x, stream: FusedFFNStream):
    """The device checks every fused kernel makes; returns the unpacked
    row count W = pack * Kr (== H)."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_cuda("x", x, x.device, x.dtype)
    check_cuda("stream.wstream", stream.wstream, x.device, torch.int8)
    check_cuda("stream.sb", stream.sb, x.device, torch.float32)
    if stream.bw % 4:
        raise ValueError(f"the fused kernels need bw % 4 == 0, got "
                         f"{stream.bw}")
    return (2 if stream.bits == 4 else 1) * stream.kr


def _launch(fn, x, stream: FusedFFNStream, head, counts, act, rows,
            split=None):
    """Allocate the output and launch the kernel of wrapper `fn` (K2, K3 or
    K4, built from `csrc/<fn name>.cu`) over the stream; head holds the
    pointers the kernel reads for x (x, or K3's int8 x and row scales).
    K2/K4 also take their hidden split, and with split > 1 a float32
    workspace [split, E, C, N] for the partials."""
    name = fn.__name__
    e, c, k = x.shape
    dev = x.device.index
    cnt = counts_i32(counts, e, c, x.device)
    out = torch.empty((e, c, stream.n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load(name)
    ptrs = [*head, stream.wstream.data_ptr(), stream.sb.data_ptr(),
            cnt.data_ptr(), out.data_ptr()]
    ints = [e, c, k, stream.kr, stream.bw, stream.t1, stream.t2, stream.n,
            stream.bits, act, DTYPE_CODES[x.dtype], rows]
    if split is not None:
        ws = (torch.empty((split, e, c, stream.n), dtype=torch.float32,
                          device=x.device) if split > 1 else None)
        ptrs.append(None if ws is None else ws.data_ptr())
        ints.append(split)
    rc = getattr(lib, name + "_launch")(
        *ptrs, *ints, dev, torch._C._cuda_getCurrentRawStream(dev))
    build.check(lib, rc, name)
    fn.launches += 1
    return out


def _check_split(split, stream: FusedFFNStream):
    """Raise unless `split` (None = the plan's choice) is one K2/K4 take
    for this stream."""
    if split is not None and not 1 <= split <= max_split(stream.kr):
        raise ValueError(f"split must be in [1, {max_split(stream.kr)}] for "
                         f"Kr={stream.kr} (a multiple of {SPLIT_UNIT} packed "
                         f"rows per slice), got {split}")


def _launch_split(fn, label, x, stream: FusedFFNStream, counts, act, split,
                  routed):
    """Launch K2 or K4 with the split and tile rows of `split_plan`."""
    w = _check_cuda_stream(x, stream)
    e, c, _ = x.shape
    plan = split_plan(stream.bits, stream.k, stream.kr, stream.n, e, c,
                      x.element_size(), sm_count(x.device.index), split,
                      routed)
    if plan is None:
        raise ValueError(f"{label} needs a hidden width whose 4-row tile fits "
                         f"in {SMEM_BYTES} bytes of shared memory; got H={w}, "
                         f"{x.dtype}")
    return _launch(fn, x, stream, [x.data_ptr()], counts, act, plan[1],
                   plan[0])


def fused_ffn_quant(x, stream: FusedFFNStream, counts=None,
                    activation_fn=gelu, *, routed=None, split=None):
    """out[e] = act(x[e] @ W1[e] * s1 + b1) @ W2[e] * s2 + b2, one kernel.

    x: [E, C, K] float32/bfloat16; counts: [E] live rows per expert (None =
    all). Returns [E, C, N] in x.dtype; rows >= counts[e] are zeros. CPU
    tensors run the plain twin; CUDA tensors run kernel K2, and anything
    the kernel does not take (another activation, dtype or layout) raises.
    `routed`: the rows routed to the experts, known on the host (the MoE
    layer passes tokens x top-k; None: all E x C), from which `split_plan`
    reads how many live tiles the counts hold. `split` pins the kernel's
    slices of the hidden (tests and tools; CPU tensors only check it).
    """
    _check_x("fused_ffn_quant", x, stream)
    _check_split(split, stream)
    if x.device.type == "cpu":
        return fused_ffn_quant_reference(x, stream, counts, activation_fn)
    act = kernel_code(activation_fn)
    if act not in (0, 1):
        raise ValueError(f"K2 takes relu or gelu, not {activation_fn!r}")
    return _launch_split(fused_ffn_quant, "K2", x, stream, counts, act, split,
                         routed)


fused_ffn_quant.launches = 0


def fused_ffn_quant_ragged(rows, stream: FusedFFNStream, group_sizes, c_max,
                           activation_fn=gelu):
    """K2 over a ragged row layout (counterpart: tutel_tpu/ops/
    grouped_gemm_pallas.py:286): one gather into the dense [E, c_max, K]
    view, one K2 call, one gather back; rows past c_max of a group, and
    past sum(group_sizes), are zeros. The kernel plans from N routed
    rows."""
    n = rows.shape[0]
    gs, starts = ragged_starts(group_sizes)
    dense = ragged_to_dense(rows, gs, starts, c_max)
    y = fused_ffn_quant(dense, stream, torch.clamp(gs, max=c_max),
                        activation_fn=activation_fn, routed=n)
    return dense_to_ragged(y, gs, starts, c_max, n)


# K3's shared memory (csrc/fused_ffn_w8a8.cu `w8a8_smem`): bytes after each
# staged int8 row, floats after each float32 hidden row
W8A8_X_PAD = 48
W8A8_H_PAD = 4


def w8a8_smem(rows, h):
    """Shared memory of a K3 block of `rows` rows: int8 x and hidden and
    the float32 hidden, each row padded, and two row scales."""
    return rows * (2 * (h + W8A8_X_PAD) + 4 * (h + W8A8_H_PAD) + 8)


def tile_rows_w8a8(h, e, c, routed=None):
    """Rows per K3 block: 16 (two n-blocks of the mma) where the experts are
    expected to hold more than 8 live rows each (`routed` rows over e
    experts; None: all C rows), else 8 (one); the largest of that, 8 and 4
    whose rows fit in shared memory; None if not even 4 fit."""
    expected = c if routed is None else min(c, routed / e)
    for rows in (16, 8, 4) if expected > 8 else (8, 4):
        if w8a8_smem(rows, h) <= SMEM_BYTES:
            return rows
    return None


# K3's tensor-core fragments (csrc/gemm_tc.cuh; the columns as K1's,
# grouped_gemm_quant.tc_a_col): m16n8k32 int8, lane = 4 g + t


def w8a8_step_rows(bits):
    """Packed rows of one k-step (32 k of an m16n8k32 mma): at INT4 the
    low nibbles of 16 packed rows, then their high nibbles."""
    return 16 if bits == 4 else 32


def w8a8_load_row(t, load):
    """Packed row, within the k-step, of a lane's load (4 at INT4, 8 at
    INT8): rows 4t .. 4t + 3 make A registers a0/a1 (and at INT4, from
    their high nibbles, a2/a3); INT8 loads 4-7 are rows 16 + 4t .. for
    a2/a3."""
    return 4 * t + (load & 3) + 16 * (load >> 2)


def w8a8_b_offset(bits, t, r, kr):
    """First byte of B register r in a staged int8 row, from the k-step's
    first packed row on; at INT4 register 1 is the high nibbles' x, kr on."""
    return 4 * t + r * kr if bits == 4 else 4 * t + 16 * r


def fused_ffn_w8a8(x, stream: FusedFFNStream, counts=None,
                   activation_fn=gelu, *, routed=None):
    """The fused FFN with both contractions int8 x int8 -> int32 (W8A8 /
    W4A8): x is quantized per row here, the float32 hidden is re-quantized
    per row inside the kernel. Same rows and signature as
    `fused_ffn_quant`; `routed` (the rows routed to the experts, known on
    the host) picks the row tile (`tile_rows_w8a8`). CPU tensors run the
    plain twin; CUDA tensors run kernel K3, and anything the kernel does
    not take raises."""
    _check_x("fused_ffn_w8a8", x, stream)
    if x.device.type == "cpu":
        return fused_ffn_w8a8_reference(x, stream, counts, activation_fn)
    act = kernel_code(activation_fn)
    w = _check_cuda_stream(x, stream)
    rows = tile_rows_w8a8(w, x.shape[0], x.shape[1], routed)
    if rows is None or stream.kr % 4 or \
            stream.k % (8 if stream.bits == 4 else 4):
        raise ValueError(f"K3 needs Kr % 4 == 0, K % 4 == 0 (K % 8 for "
                         f"INT4) and a hidden width whose 4-row tile fits "
                         f"in {SMEM_BYTES} bytes of shared memory; got "
                         f"Kr={stream.kr}, K={stream.k}, H={w}")
    xq, sx = quantize_activations(x)
    return _launch(fused_ffn_w8a8, x, stream, [xq.data_ptr(), sx.data_ptr()],
                   counts, act, rows)


fused_ffn_w8a8.launches = 0


def fused_swiglu_quant(x, stream: FusedFFNStream, counts=None,
                       activation_fn=silu, *, routed=None, split=None):
    """out[e] = (act(x[e] @ W1) * (x[e] @ W2)) @ W3 in one kernel over the
    `prepare_fused_swiglu` stream, no biases; the hidden is rounded to x's
    dtype as in the Pallas kernel. Same rows, `routed` and `split` as
    `fused_ffn_quant`. CPU tensors run the plain twin; CUDA tensors run
    kernel K4, and anything the kernel does not take raises."""
    _check_x("fused_swiglu_quant", x, stream)
    _check_split(split, stream)
    if x.device.type == "cpu":
        return fused_swiglu_quant_reference(x, stream, counts, activation_fn)
    act = kernel_code(activation_fn)
    return _launch_split(fused_swiglu_quant, "K4", x, stream, counts, act,
                         split, routed)


fused_swiglu_quant.launches = 0
