"""The tensor-core bodies of K1 (`grouped_gemm_quant`, bfloat16 x) and K3
(`fused_ffn_w8a8`), emulated on the CPU from the fragment mapping the
kernels mirror (`csrc/gemm_tc.cuh`; `tc_*` in ops/grouped_gemm_quant.py,
`w8a8_*` in ops/fused_ffn.py): each mma is assembled lane by lane and
register by register from the bytes each lane loads, in the permuted K
order, and the products are placed where the kernel's D registers go.

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
    int8 hidden value differs, live rows within 1e-5.
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
from tutel_tpu_torch.ops import activations, fused_ffn, quant
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
    """ffn_common.cuh `transpose4`: four rows of four columns -> column j's
    bytes of rows 0..3, row i in byte i."""
    a, b = _prmt(w[0], w[1], 0x5140), _prmt(w[2], w[3], 0x5140)
    d, f = _prmt(w[0], w[1], 0x7362), _prmt(w[2], w[3], 0x7362)
    return [_prmt(a, b, 0x5410), _prmt(a, b, 0x7632),
            _prmt(d, f, 0x5410), _prmt(d, f, 0x7632)]


def _s8(word):
    """[32] uint32 -> [32, 4] int8 values, byte 0 first."""
    return np.ascontiguousarray(word).view(np.int8).reshape(-1, 4).astype(
        np.int64)


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
                                acc[nb, 2 * wi + m, :, reg] += d[
                                    G + 8 * (reg >> 1), 2 * T + (reg & 1)]
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
