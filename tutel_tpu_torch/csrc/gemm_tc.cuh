// The tensor-core fragments of K1 (grouped_gemm_quant.cu, bfloat16 x) and
// K3 (fused_ffn_w8a8.cu): which packed row and column of a quantized weight
// each lane loads, and how it becomes the A operand of mma.sync.
//
// Both kernels put the weights in the M operand ("swap AB"): at decode an
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
// K3, m16n8k32 s8 (A register: four int8 of one column at k 4t .. 4t + 3):
//   INT4: a k-step is 16 packed rows. k 0..15 are the low nibbles of its
//     rows, k 16..31 the high nibbles; lane t loads rows 4t .. 4t + 3, and
//     `transpose4` (ffn_common.cuh) of their nibbles, each kept in the top
//     half of its byte (16 x its value, `int_sum` divides the sum by 16),
//     gives the low register (a0/a1) and the high one (a2/a3) of a column.
//   INT8: a k-step is 32 packed rows; lane t loads rows 4t .. 4t + 3 (a0/a1)
//     and 16 + 4t .. 16 + 4t + 3 (a2/a3).
//   B register r of lane t: the int8 x (or hidden) at k 4t + 16r .. + 3 of
//   the k-step, one 32-bit load; at INT4 the high nibbles meet the upper
//   half of the row, kr further on.
//
// D (both): d0, d1 are column a_col(i, 0) at rows 2t, 2t + 1 of the n-block,
// d2, d3 column a_col(i, 1) at the same rows.
//
// ops/grouped_gemm_quant.py (`tc_*`) and ops/fused_ffn.py (`w8a8_*`) mirror
// these functions; the CPU tests assemble the products lane by lane from
// them.

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

}  // namespace tc
