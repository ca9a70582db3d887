// The tensor-core fragments of K1 (grouped_gemm_quant.cu, bfloat16 x), K3
// (fused_ffn_w8a8.cu) and K5 (grouped_gemm_w8a8.cu): which packed row and
// column of a quantized weight each lane loads, and how it becomes the A
// operand of mma.sync.
//
// All three put the weights in the M operand ("swap AB"): at decode an
// expert holds a few rows, so the weight columns take the mma's M = 16 and
// the tile's rows its N = 8; D[m][n] is column m of the weight times row n
// of x. A lane (g = lane / 4, t = lane % 4) loads VEC adjacent bytes (16,
// or 4 where the row length does not allow 16-byte loads) of a packed row
// at the columns [VEC * g, VEC * g + VEC) of the warp's strip of 8 * VEC
// columns; the 8 lanes of one t read 8 * VEC contiguous bytes. mma i of a
// k-step (VEC / 2 of them) takes its M rows g and g + 8 from the lane's
// columns 2i and 2i + 1 (`a_col`), so one load feeds VEC / 2 mmas and no
// byte crosses lanes. The K order inside an mma is free as long as x
// follows it:
//
// K1, m16n8k16 bf16 (A register: two bf16 of one column at k 2j, 2j + 1):
//   INT4: a k-step is 8 packed rows. k 2j and 2j + 1 are the low and the
//     high nibble of packed row j (logical rows p and p + kb of a split-half
//     block), so one packed byte widens into one A register (`widen_int4`).
//     Lane t loads packed rows t and t + 4 (a0/a1 and a2/a3).
//   INT8: a k-step is 16 packed rows in their own order; lane t loads rows
//     2t, 2t + 1, 2t + 8, 2t + 9, and an A register pairs one byte of the
//     first with the same column's byte of the second (`widen_int8`).
//   x is staged in shared memory as bf16 pairs, pair j of a k-step holding
//   the two x values its k 2j, 2j + 1 meet: (x[p], x[p + kb]) at INT4,
//   (x[2q], x[2q + 1]) at INT8 (`pair_k`); B register r of lane t is pair
//   t + 4r, one 32-bit load shared by every mma of the k-step.
//
// K3 and K5, m16n8k32 s8 (A register: four int8 of one column at k 4t ..
// 4t + 3):
//   INT4: a k-step is 16 packed rows. k 0..15 are the low nibbles of its
//     rows, k 16..31 the high nibbles; lane t loads rows 4t .. 4t + 3, and
//     `transpose4` (ffn_common.cuh) of their nibbles, each kept in the top
//     half of its byte (16 x its value, `int_sum` divides the sum by 16),
//     gives the low register (a0/a1) and the high one (a2/a3) of a column.
//   INT8: a k-step is 32 packed rows; lane t loads rows 4t .. 4t + 3 (a0/a1)
//     and 16 + 4t .. 16 + 4t + 3 (a2/a3).
//   B register r of lane t: the int8 x (or hidden) at k 4t + 16r .. + 3 of
//   the k-step, one 32-bit load; at INT4 the high nibbles meet the upper
//   half of the row, kr further on (K5 stages a chunk of k-steps' low and
//   high halves 16 * chunk bytes apart, and passes that as kr).
//
// D (both): d0, d1 are column a_col(i, 0) at rows 2t, 2t + 1 of the n-block,
// d2, d3 column a_col(i, 1) at the same rows.
//
// ops/grouped_gemm_quant.py (`tc_*`), ops/fused_ffn.py (`w8a8_*`) and
// ops/w8a8.py (`k5_*`) mirror these functions; the CPU tests assemble the
// products lane by lane from them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// packed rows per k-step
__host__ __device__ constexpr int k1_step_rows(int bits) {
  return bits == 4 ? 8 : 16;
}
__host__ __device__ constexpr int k3_step_rows(int bits) {
  return bits == 4 ? 16 : 32;
}
// loads of VEC bytes a lane makes per k-step
__host__ __device__ constexpr int k1_loads(int bits) { return bits == 4 ? 2 : 4; }
__host__ __device__ constexpr int k3_loads(int bits) { return bits == 4 ? 4 : 8; }

// packed row (within the k-step) of load l of a lane with t = lane % 4
__host__ __device__ constexpr int k1_load_row(int bits, int t, int l) {
  return bits == 4 ? t + 4 * l : 2 * t + (l & 1) + 8 * (l >> 1);
}
__host__ __device__ constexpr int k3_load_row(int t, int l) {
  return 4 * t + (l & 3) + 16 * (l >> 2);
}

// column (within the warp's strip) of mma i's M row g + 8h
__host__ __device__ constexpr int a_col(int vec, int g, int i, int h) {
  return vec * g + 2 * i + h;
}

// K1 and K5: the 4 warps of a block split an expert's k-steps in four, and
// each stages the x of its own k-steps in chunks of at most 32 k-steps: its
// share rounded up to whole loop turns of 4 k-steps, so shared memory does
// not grow with K (grouped_gemm_quant.py `warp_chunk_steps` mirrors it).
constexpr int kSplitWarps = 4;
__host__ __device__ inline int chunk_steps(int nsteps) {
  const int per_warp = (nsteps + kSplitWarps - 1) / kSplitWarps;
  const int steps = (per_warp + 3) / 4 * 4;
  return steps < 32 ? steps : 32;
}

// the staged pair (within the k-step's 8) of K1's B register r
__host__ __device__ constexpr int k1_b_pair(int t, int r) { return t + 4 * r; }
// the first byte of K3's B register r in a staged int8 row, from the
// k-step's first packed row on (at INT4 the high nibbles' x is kr on)
__host__ __device__ constexpr int k3_b_offset(int bits, int t, int r, int kr) {
  return bits == 4 ? 4 * t + r * kr : 4 * t + 16 * r;
}

// The two logical rows of x that staged pair q meets: at INT4 the low and
// the high nibble of packed row q in its split-half block of kb packed rows.
__host__ __device__ inline void pair_k(int bits, int q, int kb, int& k_lo,
                                       int& k_hi) {
  if (bits == 4) {
    const int b = q / kb, i = q % kb;
    k_lo = 2 * b * kb + i;
    k_hi = k_lo + kb;
  } else {
    k_lo = 2 * q;
    k_hi = 2 * q + 1;
  }
}

// Byte j of word w (4 packed bytes) as one bf16x2 A register: the low
// nibble in the low half, the high nibble in the high half. Each nibble,
// xor 8, goes under the exponent of 128 (0x4300: 128 + u for u < 128),
// and one subtraction of 136 leaves its signed value, exactly.
__device__ __forceinline__ uint32_t widen_int4(uint32_t w, int j) {
  // bytes: w.j, w.j, (w >> 4).j, (w >> 4).j
  const uint32_t r = __byte_perm(w, w >> 4, 0x4400u + 0x1111u * j);
  const uint32_t v = (r & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 f = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&f);
}

// Byte j of words a and b as one bf16x2 A register (a's in the low half):
// each signed byte, xor 0x80, goes into the mantissa of 2^23, and one
// float subtraction leaves its value.
__device__ __forceinline__ uint32_t widen_int8(uint32_t a, uint32_t b, int j) {
  const uint32_t sel = 0x7540u + j;               // byte j, 0, 0, 0x4B
  const float lo = __uint_as_float(__byte_perm(a ^ 0x80808080u, 0x4B000000u, sel));
  const float hi = __uint_as_float(__byte_perm(b ^ 0x80808080u, 0x4B000000u, sel));
  const __nv_bfloat162 f = __floats2bfloat162_rn(lo - 8388736.f, hi - 8388736.f);
  return *reinterpret_cast<const uint32_t*>(&f);
}

// d[16x8] += a[16x16] . b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16x8] += a[16x32] . b[32x8], int8 in, int32 accumulate (exact)
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// VEC (16 or 4) bytes of weights through the read-only path, or zeros
template <int VEC>
__device__ __forceinline__ void load_weights(const int8_t* p, bool ok,
                                             uint32_t* w) {
  if constexpr (VEC == 16) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok) u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    w[0] = ok ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
  }
}

// Four rows w[0..3] of four adjacent int8 columns each -> c[j] holds
// column j's bytes of rows 0..3 (row i in byte i): the A registers of the
// s8 mma from four packed rows a lane loaded.
__device__ __forceinline__ void transpose4(const unsigned w[4], int c[4]) {
  const unsigned a = __byte_perm(w[0], w[1], 0x5140);   // r0c0 r1c0 r0c1 r1c1
  const unsigned b = __byte_perm(w[2], w[3], 0x5140);   // r2c0 r3c0 r2c1 r3c1
  const unsigned d = __byte_perm(w[0], w[1], 0x7362);   // r0c2 r1c2 r0c3 r1c3
  const unsigned f = __byte_perm(w[2], w[3], 0x7362);   // r2c2 r3c2 r2c3 r3c3
  c[0] = (int)__byte_perm(a, b, 0x5410);
  c[1] = (int)__byte_perm(a, b, 0x7632);
  c[2] = (int)__byte_perm(d, f, 0x5410);
  c[3] = (int)__byte_perm(d, f, 0x7632);
}

// K3's and K5's s8 body. One load group of the lane's weights: G k-steps
// from k-step s on, rows `row_len` bytes apart; zeros at packed rows past
// `prow` or columns past the tile's.
template <int BITS, int VEC, int G>
__device__ __forceinline__ void s8_load_group(
    uint32_t (*f)[k3_loads(BITS)][VEC / 4], const int8_t* wl, int s,
    int prow, int row_len, int t, bool col_ok) {
#pragma unroll
  for (int d = 0; d < G; ++d) {
#pragma unroll
    for (int l = 0; l < k3_loads(BITS); ++l) {
      const int row = (s + d) * k3_step_rows(BITS) + k3_load_row(t, l);
      load_weights<VEC>(wl + (size_t)row * row_len, col_ok && row < prow, f[d][l]);
    }
  }
}

// The mmas of one load group: acc[nb][i] += weights . int8 rows, n-block
// nb's B column g from the staged row xrow[nb]; k-steps at or past nsteps
// are not multiplied. At INT4 each nibble is kept in the top half of its
// byte (16 x its value; `int_sum` of ffn_common.cuh divides the sum).
template <int BITS, int VEC, int NB, int G>
__device__ __forceinline__ void s8_mma_group(
    uint32_t (*f)[k3_loads(BITS)][VEC / 4], const int8_t* const* xrow,
    int s, int nsteps, int kr, int t, int (*acc)[VEC / 2][4]) {
#pragma unroll
  for (int d = 0; d < G; ++d) {
    if (s + d >= nsteps) break;
    const int p0 = (s + d) * k3_step_rows(BITS);
    uint32_t b[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        b[nb][r] = *reinterpret_cast<const uint32_t*>(
            xrow[nb] + p0 + k3_b_offset(BITS, t, r, kr));
#pragma unroll
    for (int wi = 0; wi < VEC / 4; ++wi) {       // 4 columns: mmas 2wi, 2wi + 1
      unsigned v[4];
      int lo[4], hi[4];
      if constexpr (BITS == 4) {
#pragma unroll
        for (int l = 0; l < 4; ++l) v[l] = (f[d][l][wi] << 4) & 0xF0F0F0F0u;
        transpose4(v, lo);
#pragma unroll
        for (int l = 0; l < 4; ++l) v[l] = f[d][l][wi] & 0xF0F0F0F0u;
        transpose4(v, hi);
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) v[l] = f[d][l][wi];
        transpose4(v, lo);
#pragma unroll
        for (int l = 0; l < 4; ++l) v[l] = f[d][4 + l][wi];
        transpose4(v, hi);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t a[4] = {(uint32_t)lo[2 * m], (uint32_t)lo[2 * m + 1],
                               (uint32_t)hi[2 * m], (uint32_t)hi[2 * m + 1]};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_s8(acc[nb][2 * wi + m], a, b[nb][0], b[nb][1]);
      }
    }
  }
}

}  // namespace tc
