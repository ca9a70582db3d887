"""The tensor-core bodies of K1 (`grouped_gemm_quant`, bfloat16 x), K3
(`fused_ffn_w8a8`) and K5 (`grouped_gemm_w8a8`), emulated on the CPU from
the fragment mapping the kernels mirror (`csrc/gemm_tc.cuh`; `tc_*` in
ops/grouped_gemm_quant.py, `w8a8_*` in ops/fused_ffn.py, `k5_*` in
ops/w8a8.py): each mma is assembled lane by lane and register by register
from the bytes each lane loads, in the permuted K order, and the products
are placed where the kernel's D registers go.

Tolerances and why:
  * K1 on integer-valued x (every float32 sum exact in any order): the
    emulation equals the plain twin and the JAX kernel (interpret mode)
    bit for bit, so no weight or x value can go to a wrong place unseen;
  * K1 on normal x: 1e-6 of max |reference| against the JAX kernel in
    float32 (float32 sums in another order), and within one bfloat16 step
    of the largest output against the twin in bfloat16;
  * the INT4 widening (byte permute, lop3, bf16x2 subtraction) gives every
    nibble's value exactly;
  * K3: int32 sums are exact, so the emulation equals the twin bit for bit,
    and the JAX kernel as the twin does (tests/test_torch_w8a8.py): no
    int8 hidden value differs, live rows within 1e-5;
  * K5: x quantized as the kernel does it (a warp's lanes over a row for
    the absmax, a warp's k-steps a chunk at a time) equals
    `quantize_activations` bit for bit, and the int32 sums are exact, so
    the emulation equals the twin and the JAX kernel (interpret mode) bit
    for bit: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import grouped_gemm_pallas as jgp
from tutel_tpu.ops import quant as jq
from tutel_tpu.ops import w8a8_pallas as jw8
from tutel_tpu_torch import convert
from types import SimpleNamespace

from tutel_tpu_torch.ops import activations, fused_ffn, quant, w8a8
from tutel_tpu_torch.ops import grouped_gemm_quant as tgp

torch.set_num_threads(1)

# counts of 0, 1, 7, 8, 9, 16, 17 and C live rows
C = 20
COUNTS = np.array([0, 1, 7, 8, 9, 16, 17, C], np.int32)
E = len(COUNTS)
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def _bf16(a):
    """float32 values rounded to bfloat16 (and back)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _lane_bytes(values, rows, cols, vec, kp, n):
    """[32, vec] bytes each lane loads (zeros where the load is off)."""
    out = np.zeros((32, vec), np.uint8)
    ok = (rows < kp) & (cols < n)
    idx = cols[ok, None] + np.arange(vec)[None, :]
    out[ok] = values[rows[ok, None], idx].view(np.uint8)
    return out


def _widen_int8(lo_bytes, hi_bytes):
    return (lo_bytes.view(np.int8).astype(np.float32),
            hi_bytes.view(np.int8).astype(np.float32))


def emulate_k1(x, values, scales, counts, bits, blocks, vec, tile_rows):
    """K1's tensor-core body on the CPU: float32 [E, C, N] before the
    output is rounded (rows past counts[e] zero)."""
    e_n, c, k = x.shape
    kp, n = values.shape[1:]
    kb = kp // blocks
    ks = tgp.tc_step_rows(bits)
    nsteps = -(-kp // ks)
    chunk = tgp.tc_chunk_steps(bits, k)
    npairs = kp if bits == 4 else -(-k // 2)
    loads = 2 if bits == 4 else 4
    out = np.zeros((e_n, c, n), np.float32)
    for e in range(e_n):
        count = min(max(int(counts[e]), 0), c)
        for r0, live, nbs in tgp.tc_row_tiles(count, tile_rows):
            pairs = np.zeros((8 * nbs, 8 * nsteps, 2), np.float32)
            for q in range(npairs):
                lo, hi = tgp.tc_pair_k(bits, q, kb)
                pairs[:live, q, 0] = x[e, r0:r0 + live, lo]
                if hi < k:
                    pairs[:live, q, 1] = x[e, r0:r0 + live, hi]
            for c0 in range(0, n, 8 * vec):
                part = np.zeros((4, 8 * nbs, 8 * vec), np.float32)
                for warp in range(4):
                    for ch0, ch1 in tgp.tc_warp_chunks(nsteps, chunk, warp):
                        # the warp's staged chunk: pairs 8 ch0 .. 8 ch1
                        staged = pairs[:, 8 * ch0:8 * ch1]
                        for s in range(ch0, ch1):
                            _k1_step(bits, values[e], s, s - ch0, ks, loads,
                                     c0, vec, kp, n, nbs, staged, part[warp])
                total = part[0] + part[1] + part[2] + part[3]
                c1 = min(c0 + 8 * vec, n)
                out[e, r0:r0 + live, c0:c1] = (
                    total[:live, :c1 - c0] * scales[e, 0, c0:c1])
    return out


def _k1_step(bits, values, s, sc, ks, loads, c0, vec, kp, n, nbs, staged,
             part):
    """One warp's k-step s (step sc of its staged chunk) over the strip at
    column c0: part[row, column] += its mmas' D."""
    lb = [_lane_bytes(values, s * ks + np.array(
        [tgp.tc_load_row(bits, t, l) for t in T]), c0 + vec * G, vec, kp, n)
        for l in range(loads)]
    for i in range(vec // 2):
        a = _a_regs(bits, lb, i)
        amat = np.zeros((16, 16), np.float32)
        for reg, (lo, hi) in enumerate(a):
            m = G + 8 * (reg & 1)
            kk = 2 * T + 8 * (reg >> 1)
            amat[m, kk], amat[m, kk + 1] = lo, hi
        for nb in range(nbs):
            bmat = np.zeros((16, 8), np.float32)
            for r in range(2):
                q = 8 * sc + tgp.tc_b_pair(T, r)
                kk = 2 * T + 8 * r
                bmat[kk, G] = staged[8 * nb + G, q, 0]
                bmat[kk + 1, G] = staged[8 * nb + G, q, 1]
            d = amat @ bmat
            for reg in range(4):
                val = d[G + 8 * (reg >> 1), 2 * T + (reg & 1)]
                col = tgp.tc_a_col(vec, G, i, reg >> 1)
                part[8 * nb + 2 * T + (reg & 1), col] += val


def _a_regs(bits, lb, i):
    """The four A registers of mma i, each (low half, high half) over the
    lanes, from the lanes' loaded bytes lb[load] [32, vec]."""
    b0, b1 = 2 * i, 2 * i + 1          # columns a_col(i, 0), a_col(i, 1)
    if bits == 4:
        words = [w.view(np.uint32) for w in lb]
        wi, j = b0 // 4, b0 % 4
        return [tgp.tc_widen_int4(words[0][:, wi], j),
                tgp.tc_widen_int4(words[0][:, wi], j + 1),
                tgp.tc_widen_int4(words[1][:, wi], j),
                tgp.tc_widen_int4(words[1][:, wi], j + 1)]
    return [_widen_int8(lb[0][:, b0], lb[1][:, b0]),
            _widen_int8(lb[0][:, b1], lb[1][:, b1]),
            _widen_int8(lb[2][:, b0], lb[3][:, b0]),
            _widen_int8(lb[2][:, b1], lb[3][:, b1])]


def _k1_case(bits, blocks, k, n, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (E, C, k)).astype(np.float32)
    else:
        x = _bf16(rng.standard_normal((E, C, k)))
    w = rng.standard_normal((E, k, n)).astype(np.float32) * 0.05
    jw = jq.quantize(jnp.asarray(w), bits, shard_blocks=blocks)
    return x, jw, convert.from_jax_params(jw, "cpu")


def _live(shape, counts):
    return np.arange(shape[1])[None, :, None] < counts[:, None, None]


# (bits, blocks, K, N, vec): N past a whole strip; vec 4 where N % 16 != 0;
# INT4 blocks of 20 packed rows (a k-step crosses a block); INT8 K whose
# last k-step is half empty
K1_SHAPES = [(4, 1, 64, 144, 16), (4, 2, 80, 144, 16), (8, 1, 40, 144, 16),
             (4, 1, 64, 40, 4), (8, 1, 48, 40, 4)]


@pytest.mark.parametrize("tile_rows", [8, 16])
@pytest.mark.parametrize("bits,blocks,k,n,vec", K1_SHAPES)
def test_k1_fragments_match_twin_and_pallas_bitwise(bits, blocks, k, n, vec,
                                                    tile_rows):
    x, jw, tw = _k1_case(bits, blocks, k, n, bits + k + n, integer=True)
    got = emulate_k1(x, tw.values.numpy(), tw.scales.numpy(), COUNTS, bits,
                     blocks, vec, tile_rows)
    ref = np.asarray(jgp.grouped_gemm_quant(
        jnp.asarray(x), jw, jnp.asarray(COUNTS), interpret=True))
    live = _live(got.shape, COUNTS)
    np.testing.assert_array_equal(np.where(live, got, 0),
                                  np.where(live, ref, 0))
    twin = tgp.grouped_gemm_quant(torch.from_numpy(x).to(torch.bfloat16), tw,
                                  torch.from_numpy(COUNTS))
    np.testing.assert_array_equal(_bf16(got), twin.float().numpy())


@pytest.mark.parametrize("bits,blocks,k,n,vec", K1_SHAPES)
def test_k1_fragments_match_pallas_on_normal_x(bits, blocks, k, n, vec):
    x, jw, tw = _k1_case(bits, blocks, k, n, 7 * bits + k, integer=False)
    got = emulate_k1(x, tw.values.numpy(), tw.scales.numpy(), COUNTS, bits,
                     blocks, vec, 16)
    ref = np.asarray(jgp.grouped_gemm_quant(
        jnp.asarray(x), jw, jnp.asarray(COUNTS), interpret=True))
    live = _live(got.shape, COUNTS)
    scale = np.abs(np.where(live, ref, 0)).max()
    assert np.abs(np.where(live, got - ref, 0)).max() <= 1e-6 * scale
    twin = tgp.grouped_gemm_quant(torch.from_numpy(x).to(torch.bfloat16), tw,
                                  torch.from_numpy(COUNTS)).float().numpy()
    assert np.abs(np.where(live, _bf16(got) - twin, 0)).max() <= scale / 128
    assert not np.any(np.where(live, 0, twin))


def test_k1_widen_int4_is_exact():
    """Every byte, through the kernel's bit operations, gives its two
    signed nibbles (low in the low half)."""
    b = np.arange(256, dtype=np.uint32)
    for j in range(4):
        lo, hi = tgp.tc_widen_int4(b << (8 * j) | (0xA5 << (8 * ((j + 1) % 4))), j)
        np.testing.assert_array_equal(lo, ((b & 15) ^ 8).astype(np.float32) - 8)
        np.testing.assert_array_equal(hi, ((b >> 4) ^ 8).astype(np.float32) - 8)


def test_k1_fragments_cover_each_weight_byte_once():
    """Over one k-step the warp's loads cover its packed rows x strip
    columns once, and the A registers take every (packed row, column,
    nibble) once at a distinct (m, k) of the mmas."""
    for bits in (4, 8):
        for vec in (16, 4):
            ks = tgp.tc_step_rows(bits)
            loads = 2 if bits == 4 else 4
            seen = {(tgp.tc_load_row(bits, t, l), vec * g + j)
                    for g, t in zip(G, T) for l in range(loads)
                    for j in range(vec)}
            assert len(seen) == 32 * loads * vec == ks * 8 * vec
            cols = {tgp.tc_a_col(vec, g, i, h) for g in range(8)
                    for i in range(vec // 2) for h in (0, 1)}
            assert cols == set(range(8 * vec))
            pairs = {tgp.tc_b_pair(t, r) for t in range(4) for r in (0, 1)}
            assert pairs == set(range(8))


def test_k1_pair_k_covers_each_row_once():
    for bits, kp, blocks in ((4, 40, 1), (4, 40, 2), (8, 40, 1)):
        ks = [k for q in range(kp if bits == 4 else kp // 2)
              for k in tgp.tc_pair_k(bits, q, kp // blocks)]
        assert sorted(ks) == list(range(2 * kp if bits == 4 else kp))


@pytest.mark.parametrize("e,c,routed,plan", [
    (128, 32, 512, (8, 1)),         # the MoE decode step: 4 rows an expert
    (32, 16, 128, (8, 1)),          # the LM decode step
    (128, 32, None, (16, 2)),       # every row live
    (128, 32, 4096, (16, 2)),
    (64, 32, 990, (16, 1)),         # K < H's counts: 15.5 rows an expert
    (32, 8192, 16384, (16, 4)),     # an LM prefill chunk: 512 an expert
    (4, 8, None, (8, 1)),           # C <= 8
    (8, 20, 40, (16, 1)),           # 5 rows an expert
])
def test_k1_plan(e, c, routed, plan):
    assert tgp.tc_plan(e, c, routed) == plan


def test_k1_plan_pins_the_tile():
    assert tgp.tc_plan(128, 32, 512, tile_rows=16) == (16, 1)
    assert tgp.tc_plan(128, 32, None, tile_rows=8) == (8, 4)


@pytest.mark.parametrize("count,tile,walk", [
    (0, 16, []), (1, 16, [(0, 1, 1)]), (8, 16, [(0, 8, 1)]),
    (9, 16, [(0, 9, 2)]), (17, 16, [(0, 16, 2), (16, 1, 1)]),
    (9, 8, [(0, 8, 1), (8, 1, 1)]), (20, 8, [(0, 8, 1), (8, 8, 1), (16, 4, 1)]),
])
def test_k1_row_tiles(count, tile, walk):
    assert tgp.tc_row_tiles(count, tile) == walk


def test_k1_wrapper_checks_tile_rows():
    """The wrapper takes no pinned tile (it plans from `routed`); the
    launch helper refuses a tile the kernel has no body for before it
    looks at the device."""
    x = torch.zeros(2, 4, 16)
    qw = convert.from_jax_params(jq.quantize(jnp.zeros((2, 16, 8)), 4),
                                 "cpu")
    with pytest.raises(TypeError):
        tgp.grouped_gemm_quant(x, qw, tile_rows=8)
    with pytest.raises(ValueError, match="tile_rows"):
        tgp._launch(x, qw, None, (4, 1))
    assert tgp.grouped_gemm_quant(x, qw, routed=8).shape == (2, 4, 8)


@pytest.mark.parametrize("nsteps", [1, 3, 4, 17, 128, 130, 896, 1000])
def test_k1_warp_chunks_cover_each_step_once(nsteps):
    """The 4 warps' chunks take every k-step once, in order within a warp,
    each chunk at most `chunk` steps and all but a warp's last a whole
    number of loop turns (4 k-steps)."""
    for bits, k in ((4, 2 * 8 * nsteps), (8, 16 * nsteps)):
        chunk = tgp.tc_chunk_steps(bits, k)
        assert chunk % 4 == 0 and 4 <= chunk <= tgp.TC_CHUNK_STEPS
        steps = []
        for warp in range(4):
            runs = tgp.tc_warp_chunks(nsteps, chunk, warp)
            for a, b in runs[:-1]:
                assert b - a == chunk
            steps += [s for a, b in runs for s in range(a, b)]
        assert steps == list(range(nsteps))


@pytest.mark.parametrize("k", [2048, 8192, 10752, 14336])
@pytest.mark.parametrize("bits", [4, 8])
def test_k1_smem_does_not_grow_with_k(bits, k):
    """Wide fc2 contractions (K = 8192 .. 14336) run 16-row tiles (every
    row live) in the same shared memory as K = 2048, under the 227 KB a
    block may take."""
    assert tgp.tc_plan(8, 32)[0] == 16
    for rows in (8, 16):
        for vec in (4, 16):
            got = tgp.tc_smem(bits, vec, rows, k)
            assert got == tgp.tc_smem(bits, vec, rows, 2048)
            assert got <= fused_ffn.SMEM_BYTES


def test_k1_fragments_over_several_chunks(monkeypatch):
    """With 4 k-steps a chunk each warp stages its x in several chunks; the
    emulation stays bitwise equal to the twin and the JAX kernel."""
    monkeypatch.setattr(tgp, "TC_CHUNK_STEPS", 4)
    counts = np.array([3, 9], np.int32)
    rng = np.random.default_rng(11)
    for bits, blocks in ((4, 2), (8, 1)):
        x = rng.integers(-8, 9, (2, 12, 512)).astype(np.float32)
        w = rng.standard_normal((2, 512, 40)).astype(np.float32) * 0.05
        jw = jq.quantize(jnp.asarray(w), bits, shard_blocks=blocks)
        tw = convert.from_jax_params(jw, "cpu")
        assert tgp.tc_chunk_steps(bits, 512) == 4
        got = emulate_k1(x, tw.values.numpy(), tw.scales.numpy(), counts,
                         bits, blocks, 4, 16)
        ref = np.asarray(jgp.grouped_gemm_quant(
            jnp.asarray(x), jw, jnp.asarray(counts), interpret=True))
        live = _live(got.shape, counts)
        np.testing.assert_array_equal(np.where(live, got, 0),
                                      np.where(live, ref, 0))


# ---------------------------------------------------------------------------
# K3


def _prmt(a, b, sel):
    """__byte_perm(a, b, sel) on uint32 arrays."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _transpose4(w):
    """gemm_tc.cuh `transpose4`: four rows of four columns -> column j's
    bytes of rows 0..3, row i in byte i."""
    a, b = _prmt(w[0], w[1], 0x5140), _prmt(w[2], w[3], 0x5140)
    d, f = _prmt(w[0], w[1], 0x7362), _prmt(w[2], w[3], 0x7362)
    return [_prmt(a, b, 0x5410), _prmt(a, b, 0x7632),
            _prmt(d, f, 0x5410), _prmt(d, f, 0x7632)]


def _s8(word):
    """[32] uint32 -> [32, 4] int8 values, byte 0 first."""
    return np.ascontiguousarray(word).view(np.int8).reshape(-1, 4).astype(
        np.int64)


def _s8_step(lb, bmat, bits, vec):
    """The s8 mmas of one k-step (gemm_tc.cuh `s8_mma_group`): from the
    lanes' loaded words lb[load] [32, vec / 4] and the B matrices bmat
    [nbs, 32, 8], each mma's A assembled register by register; returns the
    D registers [nbs, vec / 2, 32 lanes, 4]."""
    nbs = len(bmat)
    acc = np.zeros((nbs, vec // 2, 32, 4), np.int64)
    for wi in range(vec // 4):
        w = [lb[l][:, wi] for l in range(4)]
        if bits == 4:
            lo = _transpose4([(x << 4) & 0xF0F0F0F0 for x in w])
            hi = _transpose4([x & 0xF0F0F0F0 for x in w])
        else:
            lo = _transpose4(w)
            hi = _transpose4([lb[4 + l][:, wi] for l in range(4)])
        for m in range(2):
            a = [lo[2 * m], lo[2 * m + 1], hi[2 * m], hi[2 * m + 1]]
            amat = np.zeros((16, 32), np.int64)
            for reg in range(4):
                kk = 4 * T[:, None] + 16 * (reg >> 1) + np.arange(4)
                amat[(G + 8 * (reg & 1))[:, None], kk] = _s8(a[reg])
            for nb in range(nbs):
                d = amat @ bmat[nb]
                for reg in range(4):
                    acc[nb, 2 * wi + m, :, reg] = d[G + 8 * (reg >> 1),
                                                    2 * T + (reg & 1)]
    return acc


def _k3_phase(src, rows, tiles, prow, wst, kr, vec, bits):
    """One integer phase of K3 emulated: {(row, tile, column): int sum}
    from the int8 rows src [rows, W + pad] (one n-block of the mma for up
    to 8 rows, two for 16) and an expert's stream tiles wst [T, kr, bw],
    each mma assembled lane by lane."""
    bw = wst.shape[-1]
    ks = fused_ffn.w8a8_step_rows(bits)
    loads = 4 if bits == 4 else 8
    nsteps = -(-prow // ks)
    nbs = 2 if rows == 16 else 1
    # B columns past a 4-row tile read row 0
    xrow = [np.where(8 * nb + G < rows, 8 * nb + G, 0) for nb in range(nbs)]
    sums = {}
    for tt in tiles:
        for gc in range(0, bw, 8 * vec):
            col = gc + vec * G
            acc = np.zeros((nbs, vec // 2, 32, 4), np.int64)
            for s in range(nsteps):
                lb = [_lane_bytes(wst[tt], s * ks + np.array(
                    [fused_ffn.w8a8_load_row(t, l) for t in T]), col, vec,
                    prow, bw).view(np.uint32) for l in range(loads)]
                bmat = np.zeros((nbs, 32, 8), np.int64)
                for nb in range(nbs):
                    for r in range(2):
                        bmat[nb, 4 * T[:, None] + 16 * r + np.arange(4),
                             G[:, None]] = np.stack(
                            [src[xrow[nb], s * ks + fused_ffn.w8a8_b_offset(
                                bits, T, r, kr) + j] for j in range(4)], 1)
                acc += _s8_step(lb, bmat, bits, vec)
            for nb in range(nbs):
                for i in range(vec // 2):
                    for reg in range(4):
                        c = gc + tgp.tc_a_col(vec, G, i, reg >> 1)
                        r = 8 * nb + 2 * T + (reg & 1)
                        for lane in range(32):
                            if c[lane] < bw and r[lane] < rows:
                                sums[(r[lane], tt, c[lane])] = \
                                    acc[nb, i, lane, reg]
    return sums


def emulate_k3(x, stream, counts, act, tile_rows):
    """K3's tensor-core body on the CPU: (out in x's dtype, the int8 hidden
    [E, C, H], its row scales [E, C, 1]), each block's rows as the kernel
    computes them, in its order of float32 operations."""
    bits, kr, bw, t1, t2, n = (stream.bits, stream.kr, stream.bw, stream.t1,
                               stream.t2, stream.n)
    w = (2 if bits == 4 else 1) * kr
    vec = 16 if bw % 16 == 0 else 4
    shift = 4 if bits == 4 else 0
    e_n, c, k = x.shape
    xq, sx = quant.quantize_activations(x)
    xr = fused_ffn.relayout_x(xq, bits, kr).numpy()
    sx, sb, wst = sx.numpy(), stream.sb.numpy(), stream.wstream.numpy()
    # fc1's float32 y, then the activation over the whole [E, C, H] at once,
    # as the twin applies it (an elementwise function, equal per element)
    y1 = np.zeros((e_n, c, w), np.float32)
    blocks = []
    for e in range(e_n):
        count = min(max(int(counts[e]), 0), c)
        for r0 in range(0, min(count, c), tile_rows):
            live, rows = min(tile_rows, count - r0), tile_rows
            xs = np.zeros((rows, w + fused_ffn.W8A8_X_PAD), np.int8)
            xs[:live, :w] = xr[e, r0:r0 + live]
            rs = np.ones(rows, np.float32)
            rs[:live] = sx[e, r0:r0 + live, 0]
            prow = k // 2 if bits == 4 else k
            for (r, tt, col), v in _k3_phase(xs, rows, range(t1), prow,
                                             wst[e], kr, vec, bits).items():
                if r < live:
                    y1[e, r0 + r, tt * bw + col] = (
                        np.float32(v >> shift) * rs[r] * sb[e, tt, 0, col]
                        + sb[e, tt, 1, col])
            blocks.append((e, r0, live, rows))
    h = act(torch.from_numpy(y1)).numpy()
    hq = np.zeros((e_n, c, w), np.int8)
    sxh = np.ones((e_n, c, 1), np.float32)
    out = np.zeros((e_n, c, n), np.float32)
    for e, r0, live, rows in blocks:
        hb = h[e, r0:r0 + live]
        m = np.abs(hb).max(axis=1)
        scale = np.where(m > 0, m / np.float32(127), np.float32(1))
        q = np.clip(np.rint(hb / scale[:, None]), -128, 127).astype(np.int8)
        hq[e, r0:r0 + live], sxh[e, r0:r0 + live, 0] = q, scale
        hs = np.zeros((rows, w + fused_ffn.W8A8_X_PAD), np.int8)
        hs[:live, :w] = q
        for (r, tt, col), v in _k3_phase(hs, rows, range(t1, t1 + t2), kr,
                                         wst[e], kr, vec, bits).items():
            ocol = (tt - t1) * bw + col
            if r < live and ocol < n:
                out[e, r0 + r, ocol] = (np.float32(v >> shift) * scale[r]
                                        * sb[e, tt, 0, col] + sb[e, tt, 1, col])
    return (torch.from_numpy(out).to(x.dtype), torch.from_numpy(hq),
            torch.from_numpy(sxh))


# (bits, act, K, H, N, bw): K < H; N past a 128-column strip and below
# t2 * bw; bw % 16 != 0 (4-byte loads, 32-column strips)
K3_SHAPES = [(4, "relu", 256, 256, 192, 128), (8, "gelu", 128, 256, 192, 128),
             (4, "gelu", 128, 256, 96, 8), (8, "relu", 256, 256, 160, 32)]


def _k3_case(bits, act, k, h, n, bw, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, k)).astype(np.float32)
    w1 = rng.standard_normal((E, k, h)).astype(np.float32) * 0.05
    w2 = rng.standard_normal((E, h, n)).astype(np.float32) * 0.05
    b1 = rng.standard_normal((E, h)).astype(np.float32) * 0.1
    b2 = rng.standard_normal((E, n)).astype(np.float32) * 0.1
    jst = jfp.prepare_fused_ffn(jq.quantize(jnp.asarray(w1), bits),
                                jq.quantize(jnp.asarray(w2), bits),
                                jnp.asarray(b1), jnp.asarray(b2), bw=bw)
    return x, jst, convert.from_jax_params(jst, "cpu")


@pytest.mark.parametrize("tile_rows", [4, 8, 16])
@pytest.mark.parametrize("bits,act,k,h,n,bw", K3_SHAPES)
def test_k3_fragments_match_twin_bitwise(bits, act, k, h, n, bw, tile_rows):
    x, _, st = _k3_case(bits, act, k, h, n, bw, bits + k + bw)
    tact = getattr(activations, act)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    counts = torch.from_numpy(COUNTS)
    out, hq, sxh = emulate_k3(xt, st, COUNTS, tact, tile_rows)
    assert torch.equal(out, fused_ffn.fused_ffn_w8a8_reference(
        xt, st, counts, tact))
    thq, tsxh = fused_ffn.fused_ffn_w8a8_hidden(xt, st, tact)
    live = torch.from_numpy(_live(hq.shape, COUNTS))
    assert torch.equal(torch.where(live, thq, 0), hq)
    assert torch.equal(torch.where(live, tsxh, 1), sxh)


@pytest.mark.parametrize("bits,act,k,h,n,bw", K3_SHAPES)
def test_k3_fragments_match_pallas(bits, act, k, h, n, bw):
    x, jst, st = _k3_case(bits, act, k, h, n, bw, 3 * bits + k)
    jact = {"relu": jax.nn.relu, "gelu": jax.nn.gelu}[act]
    ref = np.asarray(jfp.fused_ffn_w8a8(jnp.asarray(x), jst,
                                        jnp.asarray(COUNTS),
                                        activation_fn=jact, interpret=True))
    out, hq, _ = emulate_k3(torch.from_numpy(x), st, COUNTS,
                            getattr(activations, act),
                            fused_ffn.tile_rows_w8a8(h, E, C))
    # the Pallas kernel's re-quantized hidden, with its own operations
    xq, sx = jw8.quantize_activations(jnp.asarray(x))
    xp = jfp._relayout_x(xq, bits, jst.kr, C)
    q = jst.wstream if bits == 8 else jq.unpack_int4(jst.wstream)
    w1 = q[:, :jst.t1].transpose(0, 2, 1, 3).reshape(E, h, jst.t1 * bw)
    sb = jst.sb[:, :jst.t1].transpose(0, 2, 1, 3).reshape(E, 2, jst.t1 * bw)
    acc = jnp.einsum("eck,ekh->ech", xp, w1, preferred_element_type=jnp.int32)
    jhq, _ = jw8.quantize_activations(
        jact(acc.astype(jnp.float32) * sx * sb[:, 0:1] + sb[:, 1:2]))
    live = _live(hq.shape, COUNTS)
    assert int(np.sum(live & (hq.numpy() != np.asarray(jhq)))) == 0
    live = _live(ref.shape, COUNTS)
    scale = np.abs(np.where(live, ref, 0)).max()
    assert np.abs(np.where(live, out.numpy() - ref, 0)).max() <= 1e-5 * scale


@pytest.mark.parametrize("h,e,c,routed,rows", [
    (2048, 128, 32, 512, 8),        # the W4A8 decode step: 4 rows an expert
    (2048, 128, 32, None, 16),      # every row live
    (4096, 64, 32, 990, 8),         # K < H: 16 rows do not fit
    (2048, 8, 20, 64, 8),           # 8 rows an expert
    (2048, 8, 20, 72, 16),          # 9
    (9000, 8, 20, None, 4),         # only 4 rows fit
    (10000, 8, 20, None, None),
])
def test_k3_tile_rows(h, e, c, routed, rows):
    assert fused_ffn.tile_rows_w8a8(h, e, c, routed) == rows


def test_k3_fragments_cover_each_weight_byte_once():
    for bits in (4, 8):
        ks = fused_ffn.w8a8_step_rows(bits)
        loads = 4 if bits == 4 else 8
        rows = {fused_ffn.w8a8_load_row(t, l) for t in range(4)
                for l in range(loads)}
        assert rows == set(range(ks))
        # B: the x bytes of the k-step, once each (at INT4 kr apart)
        kr = 64
        got = sorted(fused_ffn.w8a8_b_offset(bits, t, r, kr) + j
                     for t in range(4) for r in (0, 1) for j in range(4))
        want = (list(range(16)) + list(range(kr, kr + 16)) if bits == 4
                else list(range(32)))
        assert got == want


# ---------------------------------------------------------------------------
# K5


def k5_row_scales(xt):
    """The kernel's row scales of the live rows xt [live, K] (float32): the
    row's warp's lane l takes the 4-value groups from 4 l on, 128 apart,
    then a butterfly of maxima over the lanes; max / 127, 1 for zeros."""
    k = xt.shape[1]
    lanes = np.zeros((xt.shape[0], 32), np.float32)
    for lane in range(32):
        idx = (np.arange(4 * lane, k, 128)[:, None] + np.arange(4)).ravel()
        if idx.size:
            lanes[:, lane] = np.abs(xt[:, idx]).max(axis=1)
    for off in (16, 8, 4, 2, 1):
        lanes = np.maximum(lanes, lanes[:, LANES ^ off])
    m = lanes[:, 0]
    return np.where(m > 0, m / np.float32(127), np.float32(1))


def k5_stage(xt, sx, bits, c, n, chunk, k, rows):
    """A warp's staged int8 x of its k-steps [c, c + n): [rows, 32 chunk +
    pad], rows past the live ones zero."""
    out = np.zeros((rows, 32 * chunk + w8a8.K5_X_PAD), np.int8)
    for src, dst in w8a8.k5_stage_words(bits, c, n, chunk, k):
        if src is not None:
            q = np.rint(xt[:, src:src + 4] / sx[:, None])
            out[:len(xt), dst:dst + 4] = np.clip(q, -128, 127)
    return out


def emulate_k5(x, values, scales, counts, bits, vec, tile_rows):
    """K5 on the CPU: the output [E, C, N] in x's dtype (rows past counts[e]
    zero). Each tile's live rows are quantized as the kernel does it, each
    warp's k-steps staged a chunk at a time, each mma assembled lane by
    lane; the warps' int32 partials are summed, then (float)sum * sx * sw
    in float32."""
    e_n, c, k = x.shape
    kp, n = values.shape[1:]
    xf = x.float().numpy()
    ks = fused_ffn.w8a8_step_rows(bits)
    nsteps = w8a8.k5_steps(bits, k)
    chunk = w8a8.k5_chunk_steps(bits, k)
    loads = 4 if bits == 4 else 8
    out = np.zeros((e_n, c, n), np.float32)
    for e in range(e_n):
        count = min(max(int(counts[e]), 0), c)
        for r0, live, nbs in tgp.tc_row_tiles(count, tile_rows):
            xt = xf[e, r0:r0 + live]
            sx = k5_row_scales(xt)
            for c0 in range(0, n, 8 * vec):
                total = np.zeros((8 * nbs, 8 * vec), np.int64)
                for warp in range(4):
                    s_end = (warp + 1) * nsteps // 4
                    prow = min(kp, s_end * ks)
                    for ch0, ch1 in tgp.tc_warp_chunks(nsteps, chunk, warp):
                        xs = k5_stage(xt, sx, bits, ch0, ch1 - ch0, chunk, k,
                                      8 * nbs)
                        for s in range(ch0, ch1):
                            lb = [_lane_bytes(values[e], s * ks + np.array(
                                [fused_ffn.w8a8_load_row(t, l) for t in T]),
                                c0 + vec * G, vec, prow, n).view(np.uint32)
                                for l in range(loads)]
                            bmat = np.zeros((nbs, 32, 8), np.int64)
                            for nb in range(nbs):
                                for r in range(2):
                                    off = (s - ch0) * ks + \
                                        fused_ffn.w8a8_b_offset(bits, T, r,
                                                                16 * chunk)
                                    bmat[nb, 4 * T[:, None] + 16 * r
                                         + np.arange(4), G[:, None]] = \
                                        np.stack([xs[8 * nb + G, off + j]
                                                  for j in range(4)], 1)
                            d = _s8_step(lb, bmat, bits, vec)
                            for nb in range(nbs):
                                for i in range(vec // 2):
                                    for reg in range(4):
                                        total[8 * nb + 2 * T + (reg & 1),
                                              tgp.tc_a_col(vec, G, i,
                                                           reg >> 1)] += \
                                            d[nb, i, :, reg]
                if bits == 4:
                    assert not np.any(total % 16)
                    total >>= 4
                c1 = min(c0 + 8 * vec, n)
                out[e, r0:r0 + live, c0:c1] = (
                    total[:live, :c1 - c0].astype(np.float32) * sx[:, None]
                    * scales[e, 0, c0:c1])
    return torch.from_numpy(out).to(x.dtype)


# (bits, K, N, vec): N past a whole strip; vec 4 where N % 16 != 0; a last
# k-step only partly inside the packed rows (INT4 K = 200, INT8 K = 104)
K5_SHAPES = [(4, 256, 144, 16), (4, 200, 40, 4), (8, 136, 144, 16),
             (8, 104, 40, 4)]


def _k5_case(bits, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, C, k)).astype(
        np.float32) * 2).to(dtype)
    x[2, 3] = 0                                    # a row of zeros: scale 1
    w = rng.standard_normal((E, k, n)).astype(np.float32) * 0.05
    jw = jq.quantize(jnp.asarray(w), bits)
    return x, jw, convert.from_jax_params(jw, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_rows", [8, 16])
@pytest.mark.parametrize("bits,k,n,vec", K5_SHAPES)
def test_k5_fragments_match_twin_and_pallas_bitwise(bits, k, n, vec,
                                                    tile_rows, dtype):
    x, jw, tw = _k5_case(bits, k, n, bits + k + n, dtype)
    counts = torch.from_numpy(COUNTS)
    got = emulate_k5(x, tw.values.numpy(), tw.scales.numpy(), COUNTS, bits,
                     vec, tile_rows)
    assert torch.equal(got, w8a8.grouped_gemm_w8a8(x, tw, counts))
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jw8.grouped_gemm_w8a8(jx, jw, jnp.asarray(COUNTS),
                                           interpret=True).astype(jnp.float32))
    live = _live(ref.shape, COUNTS)
    np.testing.assert_array_equal(np.where(live, got.float().numpy(), 0),
                                  np.where(live, ref, 0))


def test_k5_fragments_over_several_chunks(monkeypatch):
    """With 4 k-steps a chunk each warp quantizes its x in several chunks;
    the emulation stays bitwise equal to the twin."""
    monkeypatch.setattr(tgp, "TC_CHUNK_STEPS", 4)
    counts = np.array([3, 9], np.int32)
    rng = np.random.default_rng(12)
    for bits, k in ((4, 1024), (8, 776)):
        x = torch.from_numpy(rng.standard_normal((2, 12, k)).astype(
            np.float32)).to(torch.bfloat16)
        tw = quant.quantize(torch.from_numpy(
            rng.standard_normal((2, k, 40)).astype(np.float32) * 0.05), bits)
        assert w8a8.k5_chunk_steps(bits, k) == 4
        assert w8a8.k5_steps(bits, k) > 16         # several chunks a warp
        got = emulate_k5(x, tw.values.numpy(), tw.scales.numpy(), counts,
                         bits, 4, 16)
        assert torch.equal(got, w8a8.grouped_gemm_w8a8(
            x, tw, torch.from_numpy(counts)))


@pytest.mark.parametrize("chunk_cap", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,k", [(4, 200), (4, 2048), (8, 104),
                                    (8, 2048)])
def test_k5_quantization_mirror_is_quantize_activations(bits, k, dtype,
                                                        chunk_cap,
                                                        monkeypatch):
    """The kernel's quantization (the absmax a warp's lanes at a time, then
    each warp's k-steps chunk by chunk, `k5_stage_words`) gives
    `quantize_activations`' int8 values and scales bit for bit, and the JAX
    function's; each x value is staged once."""
    monkeypatch.setattr(tgp, "TC_CHUNK_STEPS", chunk_cap)
    rng = np.random.default_rng(bits + k)
    x = torch.from_numpy(rng.standard_normal((2, 6, k)).astype(
        np.float32) * 3).to(dtype)
    x[1, 2] = 0
    tq, ts = quant.quantize_activations(x)
    jqv, js = jw8.quantize_activations(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    nsteps, chunk = w8a8.k5_steps(bits, k), w8a8.k5_chunk_steps(bits, k)
    xf = x.float().numpy().reshape(-1, k)
    sx = k5_row_scales(xf)
    xq = np.zeros(xf.shape, np.int8)
    seen = np.zeros(k, np.int64)
    for warp in range(4):
        for c0, c1 in tgp.tc_warp_chunks(nsteps, chunk, warp):
            xs = k5_stage(xf, sx, bits, c0, c1 - c0, chunk, k, len(xf))
            for src, dst in w8a8.k5_stage_words(bits, c0, c1 - c0, chunk, k):
                if src is not None:
                    xq[:, src:src + 4] = xs[:, dst:dst + 4]
                    seen[src:src + 4] += 1
    assert np.all(seen == 1)
    np.testing.assert_array_equal(xq, tq.numpy().reshape(-1, k))
    np.testing.assert_array_equal(sx, ts.numpy().reshape(-1))


@pytest.mark.parametrize("vec", [16, 4])
@pytest.mark.parametrize("bits,k", [(4, 200), (4, 2048), (4, 14336),
                                    (8, 104), (8, 2048)])
def test_k5_reads_each_weight_byte_once(bits, k, vec):
    """The 4 warps' loads over one strip as the kernel issues them (a
    warp's first group before its chunks, then each loop turn's groups
    s + D and s + 2D, at packed rows below the warp's own end) bring every
    (packed row, strip column) once: no load runs into another warp's
    rows, not even a group ahead."""
    kp = k // 2 if bits == 4 else k
    ks = fused_ffn.w8a8_step_rows(bits)
    nsteps, chunk = w8a8.k5_steps(bits, k), w8a8.k5_chunk_steps(bits, k)
    depth, loads = w8a8.K5_DEPTH, 4 if bits == 4 else 8
    seen = np.zeros((kp, 8 * vec), np.int64)
    for warp in range(4):
        prow = min(kp, (warp + 1) * nsteps // 4 * ks)

        def load(s):
            for d in range(depth):
                for t in range(4):
                    for l in range(loads):
                        row = (s + d) * ks + fused_ffn.w8a8_load_row(t, l)
                        if row < prow:
                            seen[row] += 1

        runs = tgp.tc_warp_chunks(nsteps, chunk, warp)
        if runs:
            load(runs[0][0])
        for c0, c1 in runs:
            assert (c1 - c0) % (2 * depth) == 0 or c1 == runs[-1][1]
            for s in range(c0, c1, 2 * depth):
                load(s + depth)
                load(s + 2 * depth)
    assert np.all(seen == 1)


@pytest.mark.parametrize("e,c,routed,plan", [
    (128, 32, 0, (8, 1, 1)),        # nothing routed
    (128, 32, None, (16, 2, 4)),    # every row may be live: 4 strips a block
    (128, 32, 512, (8, 1, 1)),      # the W4A8 decode step: 4 rows an expert
])
def test_k5_plan_from_routed(e, c, routed, plan, monkeypatch):
    """K5 takes K1's tile and groups from the routed rows, and 4 strips a
    block where its tiles are 16 rows and x fits one chunk a warp (on an
    H100's 132 SMs); the W8A8 two-call FFN passes the MoE layer's routed
    rows to both of its K5 calls."""
    assert w8a8.k5_plan(e, c, 2048, 2048, 4, 132, routed) == plan
    assert tgp.tc_plan(e, c, routed) == plan[:2]
    seen = []

    def spy(x, qw, counts=None, *, routed=None):
        seen.append(routed)
        return w8a8.grouped_gemm_w8a8_reference(x, qw, counts)

    monkeypatch.setattr(w8a8, "grouped_gemm_w8a8", spy)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 8, 64)).astype(np.float32))
    params = {name: quant.quantize(torch.from_numpy(rng.standard_normal(
        shape).astype(np.float32) * 0.05), 4)
        for name, shape in (("fc1_w", (4, 64, 96)), ("fc2_w", (4, 96, 64)))}
    ctx = SimpleNamespace(dispatch_count=torch.tensor([8, 0, 3, 5]),
                          routed=routed)
    out = w8a8.w8a8_ffn(x, params, ctx, activations.relu, 64)
    assert out.shape == (4, 8, 64) and seen == [routed, routed]


@pytest.mark.parametrize("bits,k,strips", [
    (4, 2048, 4), (4, 4096, 4),     # a warp's x in one chunk: staged once
    (4, 4112, 1), (4, 14336, 1),    # several chunks a warp: one strip
    (8, 4096, 4), (8, 4128, 1),
])
def test_k5_plan_takes_strips_where_x_is_staged_once(bits, k, strips):
    """Strips a block only where x is staged once and 16-row tiles are
    expected."""
    assert w8a8.k5_plan(128, 32, k, 2048, bits, 132) == (16, 2, strips)
    assert w8a8.k5_plan(128, 32, k, 2048, bits, 132, 512) == (8, 1, 1)


@pytest.mark.parametrize("e,n,routed,k,strips", [
    (128, 2048, None, 1024, 4),     # 2 groups x 16 strips x 128: 1024 at 4
    (64, 4096, 990, 1024, 2),       # K < H: 1 group x 32 strips x 64
    (64, 4096, None, 1024, 4),
    (8, 640, None, 1024, 1),        # too few blocks to share the strips
    (128, 200, None, 1024, 2),      # 7 strips of 32 columns (N % 16 != 0)
    (96, 2048, None, 2048, 2),      # 768 blocks at 4 strips: under 2 x 3
    (96, 2048, None, 4096, 4),      # 98 KB a block: 2 an SM, 2 waves at 4
])
def test_k5_plan_keeps_two_waves_of_blocks(e, n, routed, k, strips):
    """The most strips a block (up to 4) whose blocks still fill two waves
    of the blocks each of 132 SMs holds: 3 by the launch bounds, fewer
    where the partials beside x leave room for fewer."""
    rows, groups, got = w8a8.k5_plan(e, 32, k, n, 8, 132, routed)
    assert rows == 16 and got == strips
    vec = 16 if n % 16 == 0 else 4
    columns = -(-n // (8 * vec))
    smem = w8a8.k5_smem(8, vec, rows, k, 2) + w8a8.K5_BLOCK_SMEM
    per_sm = min(3, w8a8.SM_SMEM_BYTES // smem)
    assert per_sm == (2 if k == 4096 else 3)
    blocks = groups * e * -(-columns // got)
    assert got == 1 or blocks >= 2 * per_sm * 132


@pytest.mark.parametrize("k", [768, 2048, 8192, 14336])
@pytest.mark.parametrize("bits", [4, 8])
def test_k5_smem_does_not_grow_with_k(bits, k):
    """A block's shared memory stays at or under its 32-k-step chunk's
    (66,560 bytes at 16 rows), under the 227 KB a block may take, and a
    staged row's stride keeps the 8 rows x 4 lanes of a B load on 32
    distinct banks."""
    for rows in (8, 16):
        for vec in (4, 16):
            got = w8a8.k5_smem(bits, vec, rows, k)
            assert got <= 4 * rows * (32 * 32 + w8a8.K5_X_PAD)
            # several strips a block: the partials beside the staged x
            assert w8a8.k5_smem(bits, vec, rows, k, 4) <= fused_ffn.SMEM_BYTES
    assert w8a8.k5_smem(bits, 16, 16, 14336) == 66560
    words = (32 * w8a8.k5_chunk_steps(bits, k) + w8a8.K5_X_PAD) // 4
    banks = {(words * g + t) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32

