"""Attention over the serving KV cache: one-token decode (K6) and a prompt
chunk's causal prefill (K7) (counterpart: tutel_tpu/ops/decode_attn_pallas
.py:171-345, 493-615).

The cache layout is the JAX package's, byte for byte: K and V are flat
slabs [B, T, KVH * HD] in the model's float type, or int8 with f32 scales
[B, KVH, T] per (group, position), or, with kv_bits=4, int8 bytes
[B, T, KVH * HD / 2] in the split-half packing (byte c holds value c in
its low nibble and value c + D/2 in its high nibble, D = KVH * HD).
Query head h reads KV group h % KVH (`q.reshape(B, mq, KVH, HD)`), which
is `.repeat`, not `.repeat_interleave`, of the groups.

`decode_attn` and `prefill_attn` launch the CUDA kernels
(`csrc/decode_attn.cu`, `csrc/prefill_attn.cu`) for CUDA tensors and run
their plain PyTorch twins (`*_reference`) for CPU tensors. K7 has two
kernels behind one entry, picked by q's type: bfloat16 queries run on the
tensor cores (mma.sync), float32 queries on the CUDA cores (TF32 would
round q and K to 10 bits). The twins
follow the Pallas kernels' rounding order: quantized values are cast to
q's type and the dots accumulate in float32; the K scale multiplies the
score, the V scale the softmax weights, which are rounded to q's type
before the combine; masked scores are -1e30 and the denominator is
clamped at 1e-30. The TPU kernels' block-diagonal q packing, window chunk
ladder (`pick_wc`, `vmem_bytes_decode_attn`) and 16/128 alignment rules
are not ported: the read window is exactly `attn_len` positions.

K6 splits each row's window over S blocks (flash-decoding): slice s
covers a contiguous run of the window's 32-position tiles
(`split_slices`, mirrored by `slice_tiles` in the .cu), `split_plan`
picks S, and a split call writes float32 partials to a workspace that a
second kernel merges in slice order. A call is one ctypes call with one
packed launch record (`_RECORD`, pinned by the source's static_asserts).
"""

import ctypes
import functools
import struct

import torch

from ..csrc import build
from .fused_ffn import DTYPE_CODES, check_cuda, sm_count

MASKED = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
MODES = {"float": 0, "int8": 1, "int4": 2}

# K6's block (csrc/decode_attn.cu): positions of a warp's tile, warps of a
# block at most; slices of a window at most
TILE, WARPS, MAX_SPLIT = 32, 4, 256
# the launch record: q, k, v, k_scale, v_scale, pos, k_new, v_new,
# k_new_scale, v_new_scale, out, workspace, stream; B, NH, KVH, HD, T, W,
# mode, dtype, split, device (`Record` in the .cu)
_RECORD = struct.Struct("<13Q10i")


def unpack_int4(packed):
    """[..., D/2] int8 split-half packed -> [..., D] int8 values in
    [-8, 7] (low nibbles first, then high nibbles)."""
    p = packed.to(torch.int32)
    low = (p << 28) >> 28
    high = p >> 4
    return torch.cat([low, high], dim=-1).to(torch.int8)


def _mode(k, k_scale, kv_bits):
    if k_scale is None:
        return "float"
    if k.dtype != torch.int8:
        raise ValueError(f"a quantized cache is int8, got {k.dtype}")
    return "int4" if kv_bits == 4 else "int8"


def _slab(x, mode, compute_t):
    """Stored cache values (any leading shape) -> float32 values of the
    compute type, unscaled."""
    if mode == "int4":
        x = unpack_int4(x)
    return x.to(compute_t).float()


def _geometry(q_heads, hd, k, k_scale, mode):
    """(T, KVH, mq) of a cache for queries with q_heads heads of hd."""
    t = k.shape[1]
    width = k.shape[2] * (2 if mode == "int4" else 1)
    if width % hd:
        raise ValueError(f"cache row width {width} is not a multiple of "
                         f"head_dim {hd}")
    kvh = width // hd
    if k_scale is not None and tuple(k_scale.shape) != (k.shape[0], kvh, t):
        raise ValueError(f"scales must be [{k.shape[0]}, {kvh}, {t}], got "
                         f"{tuple(k_scale.shape)}")
    if q_heads % kvh:
        raise ValueError(f"{q_heads} query heads do not divide into "
                         f"{kvh} KV groups")
    return t, kvh, q_heads // kvh


def _window(attn_len, t):
    return t if attn_len is None else min(int(attn_len), t)


def _ptr(x):
    """Device address of an optional tensor (0 for None)."""
    return 0 if x is None else x.data_ptr()


def split_slices(tiles, split):
    """The tiles [t0, t1) of each of `split` slices over `tiles` window
    tiles, dealt out evenly and in order (`slice_tiles` in the .cu)."""
    return [(s * tiles // split, (s + 1) * tiles // split)
            for s in range(split)]


def check_split(split, window):
    """Raise unless `split` slices fit a window of `window` positions: at
    least 1, at most one a tile and MAX_SPLIT."""
    tiles = min(max(-(-window // TILE), 1), MAX_SPLIT)
    if isinstance(split, bool) or not isinstance(split, int) or \
            not 1 <= split <= tiles:
        raise ValueError(f"split must be an int in [1, {tiles}] for a window "
                         f"of {window} positions, got {split!r}")


@functools.lru_cache(maxsize=256)
def split_plan(b, kvh, window, sms, residency):
    """The slices S of a K6 call over B rows and KVH groups with a window
    of `window` positions on `sms` SMs that hold `residency` blocks each:
    the most slices whose B * KVH * S blocks fit one wave (a block's start
    and merge cost more than a second, partial wave saves), at least two
    tiles a warp (WARPS warps a block, so each warp's second tile loads
    while it computes the first), and one where B * KVH blocks already
    fill the wave."""
    tiles = -(-window // TILE)
    return max(1, min(residency * sms // (b * kvh), tiles // (2 * WARPS),
                      MAX_SPLIT))


def decode_attn_reference(q, k, v, pos, *, k_scale=None, v_scale=None,
                          attn_len=None, kv_bits=8, k_new=None, v_new=None,
                          k_new_scale=None, v_new_scale=None):
    """Plain PyTorch twin of K6 (see `decode_attn`)."""
    b, nh, hd = q.shape
    mode = _mode(k, k_scale, kv_bits)
    t, kvh, mq = _geometry(nh, hd, k, k_scale, mode)
    w = _window(attn_len, t)
    ct = q.dtype if mode != "float" else k.dtype
    qg = q.reshape(b, mq, kvh, hd).float()
    kd = _slab(k[:, :w], mode, ct).reshape(b, w, kvh, hd)
    vd = _slab(v[:, :w], mode, ct).reshape(b, w, kvh, hd)
    s = torch.einsum("bmgd,btgd->bmgt", qg, kd) * hd ** -0.5
    if mode != "float":
        s = s * k_scale[:, None, :, :w].float()
    pos = pos.to(q.device).long()
    t_idx = torch.arange(w, device=q.device)
    fresh = k_new is not None
    live = (t_idx[None, :] < pos[:, None]) if fresh else \
        (t_idx[None, :] <= pos[:, None])
    live = live[:, None, None, :]                          # [B, 1, 1, W]
    s = torch.where(live, s, torch.full_like(s, MASKED))
    m = s.amax(dim=-1, keepdim=True)
    if fresh:
        kn = _slab(k_new, mode, ct).reshape(b, 1, kvh, hd)
        vn = _slab(v_new, mode, ct).reshape(b, kvh, hd)
        s_new = torch.einsum("bmgd,bgd->bmg", qg, kn[:, 0]) * hd ** -0.5
        vs_new = torch.ones((b, kvh), device=q.device)
        if mode != "float":
            s_new = s_new * k_new_scale.float()[:, None, :]
            vs_new = v_new_scale.float()
        m = torch.maximum(m, s_new[..., None])
    e = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    z = e.sum(dim=-1)
    if mode != "float":
        e = e * v_scale[:, None, :, :w].float()
    acc = torch.einsum("bmgt,btgd->bmgd", e.to(ct).float(), vd)
    if fresh:
        e_new = torch.exp(s_new - m[..., 0])               # [B, mq, KVH]
        z = z + e_new
        acc = acc + (e_new * vs_new[:, None, :])[..., None] * vn[:, None]
    out = acc / torch.clamp(z, min=1e-30)[..., None]
    return out.reshape(b, nh, hd).to(q.dtype)


def prefill_attn_reference(q, k, v, start, *, k_scale=None, v_scale=None,
                           attn_len=None, kv_bits=8):
    """Plain PyTorch twin of K7 (see `prefill_attn`)."""
    b, tq, nh, hd = q.shape
    mode = _mode(k, k_scale, kv_bits)
    t, kvh, mq = _geometry(nh, hd, k, k_scale, mode)
    w = _window(attn_len, t)
    ct = q.dtype
    qg = q.reshape(b, tq, mq, kvh, hd).float()
    kd = _slab(k[:, :w], mode, ct).reshape(b, w, kvh, hd)
    vd = _slab(v[:, :w], mode, ct).reshape(b, w, kvh, hd)
    s = torch.einsum("bqmgd,btgd->bmgqt", qg, kd) * hd ** -0.5
    if mode != "float":
        s = s * k_scale[:, None, :, None, :w].float()
    qpos = int(start) + torch.arange(tq, device=q.device)
    live = torch.arange(w, device=q.device)[None, :] <= qpos[:, None]
    s = torch.where(live, s, torch.full_like(s, MASKED))
    e = torch.where(live, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    z = e.sum(dim=-1)
    if mode != "float":
        e = e * v_scale[:, None, :, None, :w].float()
    acc = torch.einsum("bmgqt,btgd->bqmgd", e.to(ct).float(), vd)
    z = z.permute(0, 3, 1, 2)[..., None]                   # [B, TQ, mq, KVH, 1]
    out = acc / torch.clamp(z, min=1e-30)
    return out.reshape(b, tq, nh, hd).to(q.dtype)


def _need(name, t, q, dtype):
    """Raise `check_cuda`'s message unless t is a contiguous `dtype`
    tensor on q's CUDA device (the test costs a fraction of the raise's)."""
    if not (t.dtype == dtype and t.is_cuda and
            t.get_device() == q.get_device() and t.is_contiguous()):
        check_cuda(name, t, q.device, dtype)


def _kernel_checks(name, q, k, v, k_scale, v_scale, mode, hd, vector_read):
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    cache_t = q.dtype if mode == "float" else torch.int8
    _need("q", q, q, q.dtype)
    _need("k", k, q, cache_t)
    _need("v", v, q, cache_t)
    if k.shape[0] != q.shape[0] or v.shape != k.shape:
        raise ValueError(f"{name}: caches k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match {q.shape[0]} rows")
    if mode != "float":
        _need("k_scale", k_scale, q, torch.float32)
        _need("v_scale", v_scale, q, torch.float32)
        if v_scale.shape != k_scale.shape:
            raise ValueError(f"{name}: v_scale must be "
                             f"{tuple(k_scale.shape)}")
    for t_name, t in vector_read:             # read with 16-byte loads
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")


def decode_attn(q, k, v, pos, *, k_scale=None, v_scale=None, attn_len=None,
                kv_bits=8, k_new=None, v_new=None, k_new_scale=None,
                v_new_scale=None, split=None):
    """One-token attention over the first `attn_len` cache positions.

    out[b, h] = softmax_t(q[b, h] . K[b, t, h % KVH] / sqrt(HD)
                          | t <= pos[b]) . V[b, :, h % KVH]

    q: [B, NH, HD]; k, v: the cache as stored (module doc); k_scale,
    v_scale: [B, KVH, T] f32 for a quantized cache, else None; pos: [B]
    int; attn_len: positions read (None = T), exact while every
    pos[b] < attn_len; kv_bits: 8 or 4 for a quantized cache. k_new,
    v_new ([B, KVH*HD] stored form, [B, KVH*HD/2] for INT4) with
    k_new_scale, v_new_scale [B, KVH]: the current token's K/V row. Then
    position pos[b] is not read from the cache (the mask is t < pos[b]);
    the fresh row seeds the softmax, and the caller writes the cache
    later. split pins K6's slices of the window (tests and tools only;
    None: `split_plan`), checked on CPU tensors too. Returns [B, NH, HD]
    in q.dtype. CPU tensors run the plain twin; CUDA tensors run kernel
    K6, and anything it does not take raises.
    """
    if split is not None:
        check_split(split, _window(attn_len, k.shape[1]))
    if not q.is_cuda:
        if q.device.type == "cpu":
            return decode_attn_reference(
                q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                attn_len=attn_len, kv_bits=kv_bits, k_new=k_new, v_new=v_new,
                k_new_scale=k_new_scale, v_new_scale=v_new_scale)
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    b, nh, hd = q.shape
    mode = _mode(k, k_scale, kv_bits)
    t, kvh, mq = _geometry(nh, hd, k, k_scale, mode)
    if mq > 8:
        raise ValueError(f"K6 takes at most 8 query heads per KV group, got "
                         f"{mq}")
    rest = (k_scale, v_scale, k_new, v_new, k_new_scale, v_new_scale)
    _check(q, k, v, pos, mode, kvh, *rest)
    index = q.get_device()
    pos32 = pos if pos.dtype == torch.int32 and pos.is_cuda and \
        pos.get_device() == index and pos.is_contiguous() else \
        pos.to(device=q.device, dtype=torch.int32).contiguous()
    w = _window(attn_len, t)
    s = split or split_for(b, kvh, w, hd, mq, mode, q.dtype, index)
    out = torch.empty_like(q)
    ws = None
    if s > 1:                   # acc [B, KVH, S, mq, HD], then m and z
        ws = torch.empty(b * kvh * s * mq * (hd + 2), dtype=torch.float32,
                         device=q.device)
    lib, launch = _library()
    rc = launch(pack_record(q, k, v, pos32, out, ws,
                            torch._C._cuda_getCurrentRawStream(index), index,
                            kvh, w, mode, s, *rest))
    if rc:
        build.check(lib, rc, "decode_attn")
    decode_attn.launches += 1
    decode_attn.last_split = s
    return out


def _check(q, k, v, pos, mode, kvh, k_scale, v_scale, k_new, v_new,
           k_new_scale, v_new_scale):
    """Raise for what K6 does not take, saying what it is (on every decode
    step, so each test is the cheap one)."""
    b, _, hd = q.shape
    _kernel_checks("decode_attn", q, k, v, k_scale, v_scale, mode, hd,
                   (("q", q), ("k", k), ("v", v), ("k_new", k_new),
                    ("v_new", v_new)))
    if k_new is not None:
        _need("k_new", k_new, q, k.dtype)
        _need("v_new", v_new, q, k.dtype)
        row = (b, k.shape[2])
        if k_new.shape != row or v_new.shape != row:
            raise ValueError(f"fresh rows must be [{b}, {k.shape[2]}]")
        if mode != "float":
            _need("k_new_scale", k_new_scale, q, torch.float32)
            _need("v_new_scale", v_new_scale, q, torch.float32)
            if k_new_scale.shape != (b, kvh) or \
                    v_new_scale.shape != (b, kvh):
                raise ValueError(f"fresh row scales must be [{b}, {kvh}]")
    if pos.shape != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")


def pack_record(q, k, v, pos32, out, ws, stream, index, kvh, window, mode,
                split, k_scale=None, v_scale=None, k_new=None, v_new=None,
                k_new_scale=None, v_new_scale=None):
    """K6's launch record (`Record` in csrc/decode_attn.cu) as bytes: the
    tensors' addresses (0 for None), the workspace and the stream, then
    B, NH, KVH, HD, T, W, the mode and dtype codes, S and the device."""
    b, nh, hd = q.shape
    return _RECORD.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), pos32.data_ptr(), _ptr(k_new), _ptr(v_new),
        _ptr(k_new_scale), _ptr(v_new_scale), out.data_ptr(), _ptr(ws),
        stream, b, nh, kvh, hd, k.shape[1], window, MODES[mode],
        DTYPE_CODES[q.dtype], split, index)


@functools.lru_cache(maxsize=256)
def split_for(b, kvh, window, hd, mq, mode, dtype, index):
    """The S that `decode_attn` picks for a call of this shape (a `mode`
    cache, `dtype` queries) on CUDA device `index`: `split_plan` at the
    SM count and the block's `residency`."""
    return split_plan(b, kvh, window, sm_count(index),
                      residency(mode, dtype, kvh, hd, mq, index))


@functools.lru_cache(maxsize=64)
def residency(mode, dtype, kvh, hd, mq, index):
    """K6 blocks an SM of CUDA device `index` holds at once for a `mode`
    cache, `dtype` queries, KVH groups of `hd` dims and mq heads a group:
    the occupancy of the kernel instance and block shape the call selects
    (threads, shared memory and registers), asked of the card."""
    lib, _ = _library()
    blocks = ctypes.c_int(0)
    rc = lib.decode_attn_occupancy(_RECORD.pack(
        *[0] * 13, 1, kvh * mq, kvh, hd, TILE, TILE, MODES[mode],
        DTYPE_CODES[dtype], 1, index), ctypes.byref(blocks))
    build.check(lib, rc, "decode_attn occupancy")
    return blocks.value


_LOADED = []


def _library():
    """(K6's library, its C entry), loaded once."""
    if not _LOADED:
        lib = build.load("decode_attn")
        _LOADED.append((lib, lib.decode_attn_launch))
    return _LOADED[0]


def prefill_attn(q, k, v, start, *, k_scale=None, v_scale=None,
                 attn_len=None, kv_bits=8):
    """Causal attention of a prompt chunk at positions start + i over the
    cache prefix.

    out[b, i, h] = softmax_{t <= start + i}(q[b, i, h] . K[b, t, h % KVH]
                   / sqrt(HD)) . V[b, :, h % KVH]

    q: [B, TQ, NH, HD]; k, v, k_scale, v_scale, kv_bits as in
    `decode_attn` (the chunk's own K/V already written); start: int;
    attn_len: positions read (None = T), at least start + TQ. Returns
    [B, TQ, NH, HD] in q.dtype. CPU tensors run the plain twin; CUDA
    tensors run kernel K7 (bfloat16 q: its tensor-core kernel; float32 q:
    its CUDA-core kernel), and anything neither takes raises.
    """
    b, tq, nh, hd = q.shape
    start = int(start)
    w = _window(attn_len, k.shape[1])
    if start < 0 or start + tq > w:
        raise ValueError(f"prefill_attn: the chunk [{start}, {start + tq}) "
                         f"must lie inside the window of {w} positions")
    kw = dict(k_scale=k_scale, v_scale=v_scale, attn_len=attn_len,
              kv_bits=kv_bits)
    if q.device.type == "cpu":
        return prefill_attn_reference(q, k, v, start, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attn runs on cpu or cuda, not {q.device}")
    mode = _mode(k, k_scale, kv_bits)
    t, kvh, _ = _geometry(nh, hd, k, k_scale, mode)
    _kernel_checks("prefill_attn", q, k, v, k_scale, v_scale, mode, hd,
                   (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lib = build.load("prefill_attn")
    rc = lib.prefill_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), out.data_ptr(), b, tq,
        nh, kvh, hd, t, w, start, MODES[mode], DTYPE_CODES[q.dtype],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "prefill_attn")
    prefill_attn.launches += 1
    return out


decode_attn.launches = 0
decode_attn.last_split = None       # the S of the last launch
prefill_attn.launches = 0
