"""The window split of the decode attention kernel K6 (`decode_attn`) on the
CPU: the slice plan the CUDA kernel shares (`decode_attn.split_slices`,
mirrored by `slice_tiles` in `csrc/decode_attn.cu`), `split_plan`'s choice
of S and the block shape it reads, the refusal of a `split=` that does not
fit, the packed launch records of K6 and K8 read back at the offsets the
CUDA sources pin with static_asserts, and a plain-torch emulation of the
kernels' order of work with S slices (each warp's online softmax over
its tiles in the kernel's steps, the weights rounded to q's type against
the warp's running max at each step; the warps' states merged into a
slice's partial, the partials merged in slice order) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances, max |got - ref| / max |ref|: 1e-5 with float32 queries (the
same arithmetic in another order); 1e-2 with bfloat16 queries, the bound
of the bf16 attention parity tests: both sides round the weights to bf16,
the Pallas kernel against the running max of its 128-position chunks and
the emulation against a warp's running max at each step, so a weight can
land on the neighbouring bf16 value (2^-8 apart), and the output is
rounded to bf16.
"""

import pathlib
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.models import TransformerMoE as JModel
from tutel_tpu.ops import decode_attn_pallas as jattn
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import decode_attn as da
from tutel_tpu_torch.ops import kv_write

torch.set_num_threads(1)
CSRC = pathlib.Path(da.__file__).resolve().parents[1] / "csrc"
H100_SMS = 132


# -- the slice plan -----------------------------------------------------------

@pytest.mark.parametrize("tiles,split", [(1, 1), (7, 1), (7, 3), (7, 7),
                                         (64, 6), (64, 16), (65, 8),
                                         (64, 64)])
def test_slices_cover_the_window_in_order(tiles, split):
    """Every tile belongs to exactly one slice, slices in order, each at
    least one tile, their lengths within one of each other."""
    slices = da.split_slices(tiles, split)
    assert len(slices) == split
    assert slices[0][0] == 0 and slices[-1][1] == tiles
    for (a0, a1), (b0, _) in zip(slices, slices[1:]):
        assert a1 == b0
    lengths = [t1 - t0 for t0, t1 in slices]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("b", [1, 2, 8, 16, 64, 128, 256, 1024])
@pytest.mark.parametrize("window", [32, 300, 2048, 8192])
@pytest.mark.parametrize("residency", [1, 2, 3])
def test_split_plan_fills_one_wave(b, window, residency):
    """The most slices whose blocks fit one wave, at least two tiles a
    warp, at least one; one where B * KVH blocks fill the wave."""
    kvh = 2
    s = da.split_plan(b, kvh, window, H100_SMS, residency)
    most = max(1, -(-window // da.TILE) // (2 * da.WARPS))
    assert 1 <= s <= most
    if b * kvh >= residency * H100_SMS:
        assert s == 1
    if s > 1:
        assert b * kvh * s <= residency * H100_SMS
    assert s == most or b * kvh * (s + 1) > residency * H100_SMS


def test_split_plan_at_the_checked_shapes():
    """chip_smoke.py's K6 shapes on 132 SMs: 64 rows x 2 groups over 2048
    positions take as many slices as blocks an SM holds (one wave); 8 rows
    take the most, 8 (8 tiles a slice, two a warp); 256 rows fill the
    card alone."""
    for residency in (1, 2, 3):
        assert da.split_plan(64, 2, 2048, H100_SMS, residency) == residency
        assert da.split_plan(8, 2, 2048, H100_SMS, residency) == 8
        assert da.split_plan(256, 2, 2048, H100_SMS, residency) == 1


@pytest.mark.parametrize("split", [0, -1, 11, 2.0, True])
def test_split_is_refused_where_it_does_not_fit(split):
    """A window of 300 positions has 10 tiles: S in [1, 10], an int; CPU
    tensors are checked too."""
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 320, 64)
    with pytest.raises(ValueError, match="split must be"):
        da.decode_attn(q, k, k, torch.zeros(2, dtype=torch.int32),
                       attn_len=300, split=split)


def test_split_is_refused_past_the_merge_limit():
    """The merge holds at most MAX_SPLIT slices' weights, whatever the
    window."""
    window = 64 * da.MAX_SPLIT
    q = torch.zeros(1, 2, 64)
    k = torch.zeros(1, window, 64)
    da.check_split(da.MAX_SPLIT, window)
    with pytest.raises(ValueError, match="split must be"):
        da.decode_attn(q, k, k, torch.zeros(1, dtype=torch.int32),
                       split=da.MAX_SPLIT + 1)


def test_split_is_accepted_on_the_cpu():
    q = torch.randn(2, 4, 32)
    k, v = torch.randn(2, 320, 64), torch.randn(2, 320, 64)
    pos = torch.tensor([5, 299])
    for split in (1, 10):
        got = da.decode_attn(q, k, v, pos, attn_len=300, split=split)
        assert torch.equal(got, da.decode_attn_reference(q, k, v, pos,
                                                         attn_len=300))


# -- the launch records -------------------------------------------------------

def _offsets(source, struct_name):
    """{field: offset} from `static_assert(offsetof(struct_name, field) ==
    offset` in csrc/<source>, and the struct's sizeof if asserted."""
    text = (CSRC / source).read_text()
    out = {m.group(1): int(m.group(2)) for m in re.finditer(
        rf"offsetof\({struct_name}, (\w+)\) == (\d+)", text)}
    size = re.search(rf"sizeof\({struct_name}\) == (\d+)", text)
    return out, int(size.group(1)) if size else None


def test_decode_attn_record_matches_the_source():
    """K6's record: every field packed by `pack_record` sits where the .cu
    pins it."""
    b, nh, kvh, hd, t = 3, 8, 2, 128, 64
    q = torch.zeros(b, nh, hd, dtype=torch.bfloat16)
    k, v = (torch.zeros(b, t, kvh * hd, dtype=torch.int8) for _ in range(2))
    ks, vs = torch.ones(b, kvh, t), torch.ones(b, kvh, t)
    kn, vn = (torch.zeros(b, kvh * hd, dtype=torch.int8) for _ in range(2))
    kns, vns = torch.ones(b, kvh), torch.ones(b, kvh)
    pos32 = torch.zeros(b, dtype=torch.int32)
    out, ws = torch.empty_like(q), torch.empty(100)
    rec = da.pack_record(q, k, v, pos32, out, ws, 0xABCDEF, 1, kvh=kvh,
                         window=50, mode="int8", split=2, k_scale=ks,
                         v_scale=vs, k_new=kn, v_new=vn, k_new_scale=kns,
                         v_new_scale=vns)
    offsets, size = _offsets("decode_attn.cu", "Record")
    assert len(rec) == size == da._RECORD.size
    u64 = lambda off: struct.unpack_from("<Q", rec, off)[0]  # noqa: E731
    i32 = lambda off: struct.unpack_from("<i", rec, off)[0]  # noqa: E731
    assert u64(offsets["q"]) == q.data_ptr()
    assert u64(offsets["out"]) == out.data_ptr()
    assert u64(offsets["ws"]) == ws.data_ptr()
    assert u64(offsets["stream"]) == 0xABCDEF
    pointers = [q, k, v, ks, vs, pos32, kn, vn, kns, vns, out, ws]
    assert [u64(8 * i) for i in range(12)] == [x.data_ptr()
                                               for x in pointers]
    assert i32(offsets["B"]) == b
    ints = [i32(offsets["B"] + 4 * i) for i in range(10)]
    assert ints == [b, nh, kvh, hd, t, 50, da.MODES["int8"], 1, 2, 1]
    assert i32(offsets["split"]) == 2 and i32(offsets["device"]) == 1
    # no fresh row and no scales: zero addresses
    rec = da.pack_record(q, k, v, pos32, out, None, 0, 0, kvh=kvh, window=t,
                         mode="float", split=1)
    assert [u64(8 * i) for i in (3, 4, 6, 7, 8, 9, 11)] == [0] * 7


def test_kv_write_record_matches_the_source():
    """K8's record: the head, the caches' descriptors packed once by the
    writer, then the fresh tensors' addresses packed each step."""
    b, t = 4, 16
    rows_c = [torch.zeros(b, t, 64, dtype=torch.int8),
              torch.zeros(b, t, 32, dtype=torch.bfloat16)]
    cols_c = [torch.zeros(b, 2, t)]
    rows = [torch.zeros(b, 64, dtype=torch.int8),
            torch.zeros(b, 32, dtype=torch.bfloat16)]
    cols = [torch.zeros(b, 2)]
    pos32 = torch.zeros(b, dtype=torch.int32)
    writer = kv_write.prepare(rows_c, cols_c)
    rec = writer.pack(rows + cols, pos32, 0x1234)
    head, head_size = _offsets("kv_write.cu", "Head")
    desc, desc_size = _offsets("kv_write.cu", "CacheDesc")
    n = 3
    assert len(rec) == head_size + n * desc_size + 8 * n
    u64 = lambda off: struct.unpack_from("<Q", rec, off)[0]  # noqa: E731
    i32 = lambda off: struct.unpack_from("<i", rec, off)[0]  # noqa: E731
    assert u64(0) == 0x1234 and u64(head["pos"]) == pos32.data_ptr()
    assert i32(head["n"]) == n and i32(head["n"] + 4) == b
    assert i32(head["device"]) == 0
    want = [(rows_c[0], 0, 1, t, 64), (rows_c[1], 0, 2, t, 32),
            (cols_c[0], 1, 4, t, 2)]
    for i, (c, kind, itemsize, t_len, width) in enumerate(want):
        base = head_size + i * desc_size
        assert u64(base) == c.data_ptr()
        assert i32(base + desc["kind"]) == kind
        assert i32(base + desc["kind"] + 4) == itemsize
        assert i32(base + desc["width"] - 4) == t_len
        assert i32(base + desc["width"]) == width
    srcs = head_size + n * desc_size
    assert [u64(srcs + 8 * i) for i in range(n)] == [
        x.data_ptr() for x in rows + cols]


def test_prepared_writer_on_the_cpu_matches_write_step():
    """A writer prepared once writes two steps as write_step does; a
    reallocated cache is not the writer's, and the model's flush prepares
    again for it."""
    rng = np.random.default_rng(4)
    b, t = 5, 32

    def case():
        rows_c = [torch.from_numpy(rng.integers(-9, 9, (b, t, 8)).astype(
            np.int8)) for _ in range(4)]
        cols_c = [torch.from_numpy(rng.standard_normal((b, 2, t)).astype(
            np.float32)) for _ in range(4)]
        rows = [torch.from_numpy(rng.integers(-9, 9, (b, 8)).astype(np.int8))
                for _ in range(4)]
        cols = [torch.from_numpy(rng.standard_normal((b, 2)).astype(
            np.float32)) for _ in range(4)]
        return rows_c, cols_c, rows, cols

    rows_c, cols_c, rows, cols = case()
    want_r = [c.clone() for c in rows_c]
    want_c = [c.clone() for c in cols_c]
    writer = kv_write.prepare(rows_c, cols_c)
    pos = torch.tensor([0, 3, 31, 32, -1])
    for _ in range(2):
        kv_write.write_step(want_r, rows, pos, col_caches=want_c, cols=cols)
        got_r, got_c = writer(rows, pos, cols)
        assert all(a is c for a, c in zip(got_r + got_c, rows_c + cols_c))
        pos = pos + 1
    for got, want in zip(rows_c + cols_c, want_r + want_c):
        assert torch.equal(got, want)
    model = TransformerMoE(TransformerMoEConfig(
        vocab_size=11, max_len=t, model_dim=16, num_heads=2, num_kv_heads=2,
        num_layers=2, ffn_hidden=32, moe_every=0, kv_bits=8), device="cpu")
    other = case()
    for rc, cc, rw, cl in ((rows_c, cols_c, rows, cols), other,
                           (rows_c, cols_c, rows, cols)):
        cache = [{"k": rc[2 * i], "v": rc[2 * i + 1], "k_s": cc[2 * i],
                  "v_s": cc[2 * i + 1]} for i in range(2)]
        pend = [{"rows": (rw[2 * i], rw[2 * i + 1]),
                 "cols": (cl[2 * i], cl[2 * i + 1])} for i in range(2)]
        want_r = [c.clone() for c in rc]
        want_c = [c.clone() for c in cc]
        kv_write.write_step_reference(want_r, rw, pos, want_c, cl)
        model._flush_kv_writes(cache, pend, pos)
        assert model._kv_writer.matches(rc, cc)
        assert not model._kv_writer.matches(
            *(other[:2] if rc is rows_c else (rows_c, cols_c)))
        for got, want in zip(rc + cc, want_r + want_c):
            assert torch.equal(got, want)


def test_prepared_writer_refuses_mismatched_rows():
    cache = torch.zeros(2, 8, 4)
    writer = kv_write.prepare([cache])
    with pytest.raises(ValueError, match="do not match"):
        writer([torch.zeros(2, 3)], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        writer([torch.zeros(2, 4, dtype=torch.float64)],
               torch.zeros(2, dtype=torch.int32))


# -- an emulation of the split against the Pallas kernel ---------------------

def kernel_geometry(dtype, mode, kvh, hd, mq):
    """(warps of a block, positions of an online-softmax step) of the K6
    instance a call selects: `block_shape` and `Lanes` (DL dims a lane:
    16, 8 with 8 heads a group, at most HD / MQ and, for INT4 at HD 16,
    8; LP lanes a position, a step of NPS = min(LP, 8) positions a lane over
    32 / LP position groups) in csrc/decode_attn.cu."""
    if mode == "int4":
        row = hd if kvh % 2 == 0 else kvh * hd // 2
    else:
        row = hd * (1 if mode == "int8" else dtype.itemsize)
    stage = 2 * da.TILE * row + 2 * da.TILE * 4
    warps = min(da.WARPS, 232448 // (2 * stage))
    mq_t = next(m for m in (1, 2, 4, 8) if m >= mq)
    dl = min(16 if mq_t <= 4 else 8, hd // mq_t,
             8 if mode == "int4" and hd == 16 else 16)
    lp = hd // dl
    return warps, min(lp, 8) * (32 // lp)


def split_emulation(q, k, v, pos, split, *, k_scale=None, v_scale=None,
                    attn_len=None, kv_bits=8, k_new=None, v_new=None,
                    k_new_scale=None, v_new_scale=None):
    """What K6 computes with `split` slices, in plain torch, in the
    kernel's order: slice s covers the window's tiles
    `split_slices(tiles, split)[s]`; warp w of its block walks tiles w,
    w + warps, ... of the slice in steps of `kernel_geometry`'s positions,
    and at each step updates its running max, rescales its sum and acc,
    and rounds the step's weights exp(score - running max) (times the V
    scale) to q's type before the combine; warp 0 of slice 0 starts from
    the fresh row (m = its score, z = 1, acc = its scaled V row); the
    warps' states merge into the slice's partial, the partials in slice
    order. Summation order within a step is torch's, not the kernel's."""
    b, nh, hd = q.shape
    mode = da._mode(k, k_scale, kv_bits)
    t, kvh, mq = da._geometry(nh, hd, k, k_scale, mode)
    w = da._window(attn_len, t)
    ct = q.dtype if mode != "float" else k.dtype
    warps, step = kernel_geometry(ct, mode, kvh, hd, mq)
    qg = q.reshape(b, mq, kvh, hd).float()
    kd = da._slab(k[:, :w], mode, ct).reshape(b, w, kvh, hd)
    vd = da._slab(v[:, :w], mode, ct).reshape(b, w, kvh, hd)
    s = torch.einsum("bmgd,btgd->bmgt", qg, kd) * hd ** -0.5
    if mode != "float":
        s = s * k_scale[:, None, :, :w].float()
    fresh = k_new is not None
    idx = torch.arange(w)
    live = (idx[None, :] < pos[:, None]) if fresh else \
        (idx[None, :] <= pos[:, None])
    live = live[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, da.MASKED))
    vsc = v_scale[:, None, :, :w].float() if mode != "float" else None

    def merge(states):
        mx = torch.stack([m for m, _, _ in states]).amax(0)
        zt, at = torch.zeros_like(mx), torch.zeros(b, mq, kvh, hd)
        for m, z, acc in states:
            f = torch.exp(m - mx)
            zt = zt + z * f
            at = at + acc * f[..., None]
        return mx, zt, at

    parts = []
    for si, (t0, t1) in enumerate(da.split_slices(max(-(-w // da.TILE), 1),
                                                  split)):
        states = []
        for wi in range(warps):
            m = torch.full((b, mq, kvh), da.MASKED)
            z = torch.zeros(b, mq, kvh)
            acc = torch.zeros(b, mq, kvh, hd)
            if fresh and si == 0 and wi == 0:
                kn = da._slab(k_new, mode, ct).reshape(b, kvh, hd)
                vn = da._slab(v_new, mode, ct).reshape(b, kvh, hd)
                m = torch.einsum("bmgd,bgd->bmg", qg, kn) * hd ** -0.5
                vs_new = torch.ones(b, kvh)
                if mode != "float":
                    m = m * k_new_scale.float()[:, None, :]
                    vs_new = v_new_scale.float()
                z = torch.ones(b, mq, kvh)
                acc = (vs_new[:, None, :, None] * vn[:, None]).expand(
                    b, mq, kvh, hd).clone()
            for tile in range(t0 + wi, t1, warps):
                for lo in range(tile * da.TILE, min((tile + 1) * da.TILE, w),
                                step):
                    hi = min(lo + step, w)
                    ss, ll = s[..., lo:hi], live[..., lo:hi]
                    m_new = torch.maximum(m, ss.amax(dim=-1))
                    corr = torch.exp(m - m_new)
                    e = torch.where(ll, torch.exp(ss - m_new[..., None]),
                                    torch.zeros_like(ss))
                    z = z * corr + e.sum(-1)
                    if vsc is not None:
                        e = e * vsc[..., lo:hi]
                    acc = acc * corr[..., None] + torch.einsum(
                        "bmgt,btgd->bmgd", e.to(ct).float(), vd[:, lo:hi])
                    m = m_new
            states.append((m, z, acc))
        parts.append(merge(states))
    _, zt, at = merge(parts)
    out = at / torch.clamp(zt, min=1e-30)[..., None]
    return out.reshape(b, nh, hd).to(q.dtype)


def _cache(rng, b, t, kvh, hd, bits):
    kf = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    vf = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    if bits == 0:
        return kf.reshape(b, t, -1), vf.reshape(b, t, -1), None, None
    fn = JModel._kv_quantize if bits == 8 else JModel._kv_quantize4
    out = []
    for x in (kf, vf):
        vals, sc = fn(jnp.asarray(x.reshape(b * t, kvh, hd)))
        out.append((np.asarray(vals).reshape(b, t, -1),
                    np.asarray(sc).reshape(b, t, -1).transpose(0, 2, 1)
                    .copy()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _close(got, ref, tol):
    got = np.asarray(got.float().numpy(), np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12)
    assert err <= tol, err


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,kvh,hd", [(4, 2, 64), (8, 1, 128)])
def test_split_emulation_matches_pallas(split, bits, fresh, dtype, nh, kvh,
                                        hd):
    """Rows at pos 0 (every slice but the first empty), inside the first
    tile, at a tile edge, mid-slice and at the window's end; 8 slices of
    a 256-position window are one tile each. HD 64 with 2 heads a group
    takes a tile a step; HD 128 with 8 heads a group 16 positions a step
    (3 warps a block with float32, 4 with bfloat16)."""
    rng = np.random.default_rng(70 + 3 * bits + split + fresh + hd)
    b, t = 5, 256
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, bits)
    pos = np.asarray([0, 17, 32, 150, 255], np.int32)
    jkw, tkw = {}, {}
    if fresh:
        kn, vn, kns, vns = _cache(rng, b, 1, kvh, hd, bits)
        fresh_rows = dict(k_new=kn[:, 0], v_new=vn[:, 0],
                          k_new_scale=None if kns is None else kns[..., 0],
                          v_new_scale=None if vns is None else vns[..., 0])
        jkw = {n: None if x is None else jnp.asarray(x)
               for n, x in fresh_rows.items()}
        tkw = {n: None if x is None else torch.from_numpy(np.array(x))
               for n, x in fresh_rows.items()}
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = getattr(torch, dtype)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    if bits == 0:                       # a float cache is of q's type
        jk, jv = jk.astype(jt), jv.astype(jt)
        tk, tv = tk.to(tt), tv.to(tt)
        for n in ("k_new", "v_new"):
            if n in jkw:
                jkw[n], tkw[n] = jkw[n].astype(jt), tkw[n].to(tt)
    ref = jattn.decode_attn(
        jnp.asarray(q, jt), jk, jv, jnp.asarray(pos),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), wc=128,
        kv_bits=bits or 8, interpret=True, **jkw)
    got = split_emulation(
        torch.from_numpy(q).to(tt), tk, tv, torch.from_numpy(pos), split,
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs),
        kv_bits=bits or 8, **tkw)
    assert got.dtype == tt
    _close(got, np.asarray(ref, np.float32),
           1e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("nh,kvh,hd", [(4, 4, 16), (8, 2, 16), (8, 1, 16),
                                       (3, 1, 16), (4, 4, 32), (8, 1, 32)])
def test_split_emulation_small_head_dim_matches_twin(split, bits, nh, kvh,
                                                     hd):
    """At head_dim 16 and 32 the lanes of a position change (a run of
    16, 8, 4 or 2 dims a lane; 8 for INT4 at 16, where an odd KVH's group
    straddles the packed row's halves): the emulation in that geometry
    against K6's plain twin, float32 with fresh rows."""
    rng = np.random.default_rng(90 + bits + split + hd + nh)
    b, t = 5, 96
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, bits)
    kn, vn, kns, vns = _cache(rng, b, 1, kvh, hd, bits)
    kw = {n: None if x is None else torch.from_numpy(np.array(x))
          for n, x in dict(k_new=kn[:, 0], v_new=vn[:, 0],
                           k_new_scale=None if kns is None else kns[..., 0],
                           v_new_scale=None if vns is None
                           else vns[..., 0]).items()}
    kw.update(k_scale=None if ks is None else torch.from_numpy(ks),
              v_scale=None if vs is None else torch.from_numpy(vs),
              kv_bits=bits or 8)
    args = (torch.from_numpy(q), torch.from_numpy(k.copy()),
            torch.from_numpy(v.copy()),
            torch.from_numpy(np.asarray([0, 17, 32, 60, 95], np.int32)))
    got = split_emulation(*args, split, **kw)
    ref = da.decode_attn_reference(*args, **kw)
    _close(got, ref.numpy(), 1e-5)
