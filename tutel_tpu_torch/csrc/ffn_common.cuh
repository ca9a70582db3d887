// Shared by the expert-FFN kernels K2 (fused_ffn_quant.cu), K3
// (fused_ffn_w8a8.cu), K4 (fused_swiglu_quant.cu) and K5
// (grouped_gemm_w8a8.cu): type conversions, the activations, the staging
// of a row tile of x for the fused kernels, the float32 dequantizing dot
// of K2/K4 and the int8 x int8 dot of K3/K5, each over four weight
// columns per thread.
//
// Integer dots use __dp4a, which sums four int8 x int8 products into an
// int32 in one instruction. It wants the four K-consecutive bytes of one
// operand in one register, but a [K, N] row-major weight keeps the bytes
// of one column N apart, while one 32-bit load brings four adjacent
// columns of one row. `dp4a_cols` therefore loads four rows of four
// columns (four coalesced 32-bit loads) and transposes the 4 x 4 bytes in
// registers with eight __byte_perm, so each column's four bytes meet the
// activation word of those four rows: 4 rows x 4 columns x ROWS rows of
// activations cost 8 permutes and 4 * ROWS dp4a, against 16 * ROWS
// multiply-adds with scalar bytes.
//
// INT4 weights are split-half packed (byte = low nibble: row p, high
// nibble: row p + K/2). A nibble is left in the top half of its byte,
// (w << 4) & 0xF0F0F0F0 for the low ones and w & 0xF0F0F0F0 for the high
// ones, so each byte is 16 x the signed nibble: the dots are 16 x the true
// sums, exactly, and an arithmetic shift by 4 at the end recovers them
// (|sum| < 2^31 / 16 for K < 2^17). No per-nibble sign extension is needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffn {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 0 = relu, 1 = tanh-approximated gelu (jax.nn.gelu's default),
// 2 = silu (x * sigmoid(x), jax.nn.silu); all in float32
template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if constexpr (ACT == 0) {
    return fmaxf(y, 0.f);
  } else if constexpr (ACT == 1) {
    const float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.f + tanhf(inner));
  } else {
    return y * (1.f / (1.f + expf(-y)));
  }
}

// A row tile of x [rows, K] (rows K apart from xe) into xs [rows, W] in
// the unpacked row order of the fused stream's first tiles: for INT4 each
// half of x zero-padded from K/2 to kr, for INT8 the tail zero-padded to
// W. Rows >= live are zeros. The caller synchronizes.
template <int BITS, typename V>
__device__ void stage_x(V* xs, const V* __restrict__ xe, int K, int kr, int W,
                        int rows, int live, V zero) {
  const int kq = BITS == 4 ? K / 2 : K;
  for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
    const int r = idx / W, i = idx % W;
    int src = -1;
    if (r < live) {
      if (BITS == 4)
        src = i < kr ? (i < kq ? i : -1) : (i - kr < kq ? kq + i - kr : -1);
      else
        src = i < K ? i : -1;
    }
    xs[idx] = src >= 0 ? xe[(size_t)r * K + src] : zero;
  }
}

// acc[r][j] += sum over packed rows p < prow of column j's dequantized
// weight times src[r][p] (INT8), or times src[r][p] and src[r][kr + p]
// for the low and the high nibble (INT4), in float32. src [ROWS][W] is in
// shared memory and read as broadcasts; wp points at the thread's four
// columns of the tile's first packed row, rows bw apart, so one 32-bit
// load brings the four columns' bytes of a row.
template <typename T, int BITS, int ROWS>
__device__ __forceinline__ void float_dot_cols(const T* src, int W,
                                               const int8_t* __restrict__ wp,
                                               int prow, int kr, int bw,
                                               float acc[][4]) {
#pragma unroll 4
  for (int p = 0; p < prow; ++p) {
    const unsigned packed = *reinterpret_cast<const unsigned*>(wp + (size_t)p * bw);
    float xl[ROWS], xh[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xl[r] = to_float(src[r * W + p]);
      if constexpr (BITS == 4) xh[r] = to_float(src[r * W + kr + p]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned byte = packed >> (8 * j);
      if constexpr (BITS == 4) {
        const float lo = (float)((int)(int8_t)(byte << 4) >> 4);
        const float hi = (float)((int)(int8_t)byte >> 4);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r][j] = fmaf(xl[r], lo, fmaf(xh[r], hi, acc[r][j]));
      } else {
        const float q = (float)(int8_t)byte;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(xl[r], q, acc[r][j]);
      }
    }
  }
}

// Four rows w[0..3] of four adjacent int8 columns each -> c[j] holds
// column j's bytes of rows 0..3 (row i in byte i).
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

// acc[r][j] += sum over 4 packed rows of column j times the activation
// word of row r. xlo/xhi: the rows' activation words (4 consecutive int8)
// for the low and the high nibble rows (xhi unused for INT8). For INT4 the
// sums are 16 x the true ones (see the header comment).
template <int BITS, int ROWS>
__device__ __forceinline__ void dp4a_cols(const unsigned w[4], const int* xlo,
                                          const int* xhi, int acc[][4]) {
  int c[4];
  if constexpr (BITS == 8) {
    transpose4(w, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][j] = __dp4a(c[j], xlo[r], acc[r][j]);
  } else {
    unsigned v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (w[i] << 4) & 0xF0F0F0F0u;
    transpose4(v, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][j] = __dp4a(c[j], xlo[r], acc[r][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = w[i] & 0xF0F0F0F0u;
    transpose4(v, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][j] = __dp4a(c[j], xhi[r], acc[r][j]);
  }
}

// the true integer sum of an accumulator filled by dp4a_cols
template <int BITS>
__device__ __forceinline__ int int_sum(int acc) {
  return BITS == 4 ? acc >> 4 : acc;
}

}  // namespace ffn
