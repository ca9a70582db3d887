// Shared by the expert-FFN kernels K2 (fused_ffn_quant.cu), K3
// (fused_ffn_w8a8.cu), K4 (fused_swiglu_quant.cu) and K5
// (grouped_gemm_w8a8.cu): type conversions, the activations, the staging
// of a row tile of x for K3, the int32 sum of K3's and K5's s8 mmas, and the
// hidden split of K2/K4 (the second half of this file).
//
// INT4 weights are split-half packed (byte = low nibble: row p, high
// nibble: row p + K/2). K3 and K5 leave a nibble in the top half of its
// byte, (w << 4) & 0xF0F0F0F0 for the low ones and w & 0xF0F0F0F0 for the
// high ones, so each byte is 16 x the signed nibble: the integer dots are
// 16 x the true sums, exactly, and an arithmetic shift by 4 at the end
// recovers them (|sum| < 2^31 / 16 for K < 2^17). No per-nibble sign
// extension is needed.

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

// A row tile of x [rows, K] (rows K apart from xe) into xs [rows, W] (rows
// `ws` apart) in the unpacked row order of the fused stream's first tiles:
// for INT4 each half of x zero-padded from K/2 to kr, for INT8 the tail
// zero-padded to W. Rows >= live are zeros. The caller synchronizes.
template <int BITS, typename V>
__device__ void stage_x(V* xs, const V* __restrict__ xe, int K, int kr, int W,
                        int ws, int rows, int live, V zero) {
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
    xs[(size_t)r * ws + i] = src >= 0 ? xe[(size_t)r * K + src] : zero;
  }
}

// the true integer sum of an s8 mma accumulator (gemm_tc.cuh
// `s8_mma_group`): at INT4 each nibble met x as 16 x its value
template <int BITS>
__device__ __forceinline__ int int_sum(int acc) {
  return BITS == 4 ? acc >> 4 : acc;
}

// ---------------------------------------------------------------------------
// The hidden split of K2 and K4.
//
// Block (e, s, row tile) owns slice s of expert e's hidden: the packed rows
// [p0, p1) of the down projection. At INT4 a packed row p holds hidden rows
// p (low nibble) and p + kr (high nibble), so the slice needs the hidden
// columns [p0, p1) and [kr + p0, kr + p1) from the first layer; at INT8 the
// columns [p0, p1). The block computes those hidden columns over all of K,
// keeps them in shared memory, and multiplies them by its packed rows of
// the down projection over all N columns: with S slices, each of an
// expert's weight bytes is still read once, by one of S blocks.
//
// `split_rows` deals out the kr / kSplitUnit units of kSplitUnit packed rows
// evenly and in order (all kr rows when S == 1); fused_ffn.split_slices is
// its host twin. A slice therefore starts and ends on a multiple of 32
// packed rows, and S > 1 needs kr % 32 == 0.
//
// Inside a block a pass (one weight matrix, or W1 / W2 / W3 at SwiGLU)
// deals out column groups of VEC adjacent columns to its 256 threads. Each
// thread loads VEC bytes of a packed row at once (16 at decode where bw
// allows, else 4: one uint4 or 32-bit load; `dispatch_rows`) for 4 packed
// rows before it uses them, converts the nibbles or bytes to float once
// per packed row and adds them into acc[ROWS][VEC] (ROWS * VEC <= 64
// floats, so 16-byte loads go with tiles of 2 or 4 rows). Where a pass
// has fewer column groups than threads, the
// packed rows are split over the idle threads too (kz ways), and the kz
// float32 partials of each column are summed in shared memory in a fixed
// order, 16 accumulators at a time: the result never depends on timing.
// The pass's column scales (and biases) are staged in shared memory while
// the products run, so its epilogue waits on no global load.
//
// At a decode step the kernels stream weights at about a fifth of the
// memory rate. Their weight loops take 16.4-16.8 instructions per weight
// byte at 4 rows and 11.5-11.8 at 2 (PERF.md): issuing them fills under
// half of the main kernel's time, and what fills the rest is not known
// yet.

constexpr int kSplitThreads = 256;
constexpr int kSplitUnit = 32;          // packed rows per unit of the split
constexpr int kRedStride = 17;          // 16 floats + 1 against bank conflicts
constexpr int kRedBytes = kSplitThreads * kRedStride * 4;

// Packed rows [p0, p1) of the down projection owned by slice s of `split`.
__host__ __device__ __forceinline__ void split_rows(int kr, int split, int s,
                                                    int& p0, int& p1) {
  if (split == 1) {
    p0 = 0;
    p1 = kr;
    return;
  }
  const int units = kr / kSplitUnit;
  p0 = kSplitUnit * (s * units / split);
  p1 = kSplitUnit * ((s + 1) * units / split);
}

// Packed rows of the longest slice.
__host__ __device__ __forceinline__ int split_longest(int kr, int split) {
  const int units = kr / kSplitUnit;
  return split == 1 ? kr : kSplitUnit * ((units + split - 1) / split);
}

// Floats of the scale (and bias) rows a pass stages: its columns, at most
// the longest slice's hidden columns or n rounded up to 16.
__host__ __device__ __forceinline__ int split_stage(int bits, int kr, int n,
                                                   int split) {
  const int hidden = (bits == 4 ? 2 : 1) * split_longest(kr, split);
  const int down = (n + 15) / 16 * 16;
  return hidden > down ? hidden : down;
}

// Dynamic shared memory of a K2/K4 block: the reduction buffer, a pass's
// scale and bias rows [2, split_stage] in float, then the staged x
// [tile_rows, pack * K/pack] and the hidden slice [tile_rows, pack *
// longest slice], in T. fused_ffn.split_smem mirrors it.
__host__ __forceinline__ size_t split_smem(int bits, int K, int kr, int n,
                                           int split, int tile_rows,
                                           size_t itemsize) {
  const int pack = bits == 4 ? 2 : 1;
  return kRedBytes + 8 * (size_t)split_stage(bits, kr, n, split) +
         (size_t)tile_rows * pack * (K / pack + split_longest(kr, split)) *
             itemsize;
}

// Where a block's operands lie in shared memory (in elements of T).
struct SplitLayout {
  int kr;
  int kq;    // packed rows of the first layer that meet x (K/2 or K)
  int ldx;   // a staged x row: [x[:kq] | x[kq:2kq]] at INT4, x at INT8
  int p0;    // the slice's first packed row of the down projection
  int len;   // its packed rows
  int ldh;   // a hidden row: [low rows | high rows] at INT4
};

template <int BITS>
__device__ __forceinline__ SplitLayout split_layout(int K, int kr, int split,
                                                    int s) {
  SplitLayout L;
  int p1;
  split_rows(kr, split, s, L.p0, p1);
  L.kr = kr;
  L.kq = BITS == 4 ? K / 2 : K;
  L.ldx = (BITS == 4 ? 2 : 1) * L.kq;
  L.len = p1 - L.p0;
  L.ldh = (BITS == 4 ? 2 : 1) * L.len;
  return L;
}

// Column ranges [a1, b1) and [a2, b2) that one pass computes.
struct Cols {
  int a1, b1, a2, b2;
};

// The first layer's columns (hidden columns) the slice needs; the two INT4
// ranges are one when the slice is the whole hidden.
template <int BITS>
__device__ __forceinline__ Cols hidden_cols(const SplitLayout& L) {
  const int b1 = L.p0 + L.len;
  if (BITS == 8) return {L.p0, b1, b1, b1};
  const int a2 = L.kr + L.p0, b2 = a2 + L.len;
  return b1 == a2 ? Cols{L.p0, b2, b2, b2} : Cols{L.p0, b1, a2, b2};
}

// Where hidden column j lies in a row of the hidden slice.
template <int BITS>
__device__ __forceinline__ int hidden_pos(const SplitLayout& L, int j) {
  if (BITS == 8 || j < L.kr) return j - L.p0;
  return L.len + j - L.kr - L.p0;
}

// Rows [0, rows) of x (rows K apart from xe) into xs [rows, ldx]: at INT4
// the low half x[:kq] then the high half x[kq:2kq]. Rows >= live are
// zeros. The caller synchronizes.
template <int BITS, typename T>
__device__ void stage_rows(T* xs, const T* __restrict__ xe, int K,
                           const SplitLayout& L, int rows, int live) {
  for (int idx = threadIdx.x; idx < rows * L.ldx; idx += blockDim.x) {
    const int r = idx / L.ldx, i = idx - r * L.ldx;
    xs[idx] = r < live ? xe[(size_t)r * K + i] : from_float<T>(0.f);
  }
}

// A signed nibble of h at bits [s, s + 4) (s <= 12), times 2^s, as float
// without an int-to-float conversion: with its sign bit flipped it is the
// mantissa field of 2^23 + (v + 8) * 2^s, exactly, and one subtraction
// leaves v * 2^s: a mask, a flip and a subtraction, which the SASS holds
// as two LOP3 and one FADD per nibble (PERF.md). The same for a
// signed byte at bits [s, s + 8) (s <= 8). A 32-bit word of weights is
// read as its low half h = w and its high half h = w >> 16, so the
// columns' values come out scaled by 2^0, 2^4, 2^8 or 2^12, and the x
// values they meet are scaled by the inverse: the products are exact, as
// without the scaling.
template <int S>
__device__ __forceinline__ float nibble_scaled(unsigned h) {
  return __uint_as_float((h & (0xFu << S)) ^ (0x4B000000u | (8u << S))) -
         (8388608.f + 8.f * (float)(1 << S));
}
template <int S>
__device__ __forceinline__ float byte_scaled(unsigned h) {
  return __uint_as_float((h & (0xFFu << S)) ^ (0x4B000000u | (0x80u << S))) -
         (8388608.f + 128.f * (float)(1 << S));
}

// The same values unscaled, one shift more each: where a thread holds
// many rows, scaling each row's x costs more than the shifts save.
__device__ __forceinline__ float nibble(unsigned w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}
__device__ __forceinline__ float byte_value(unsigned w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFFu) ^ 0x4B000080u) - 8388736.f;
}

// VEC bytes of one packed row (16-byte aligned for 16: bw and the group's
// first column are multiples of VEC) through the read-only path.
template <int VEC>
__device__ __forceinline__ void load_w(const int8_t* p, unsigned (&w)[VEC / 4]) {
  if constexpr (VEC == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// acc[r][j] += packed row w's column j times src[r * ld] (INT8), or its low
// nibble times src[r * ld] plus its high nibble times src[r * ld + hi]
// (INT4); the weights are converted once for all ROWS rows. Up to 4 rows,
// the rows' x values are scaled by 2^0, 2^-4, 2^-8 and 2^-12 and the
// weights converted a 16-bit half-word at a time (nibble_scaled); with
// more rows, one shift per value instead (nibble).
template <typename T, int BITS, int ROWS, int VEC>
__device__ __forceinline__ void fma_row(const T* src, int ld, int hi,
                                        const unsigned (&w)[VEC / 4],
                                        float (&acc)[ROWS][VEC]) {
  if constexpr (ROWS <= 4) {
    float x0[ROWS], x8[ROWS], h4[ROWS], h12[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      x0[r] = to_float(src[r * ld]);
      x8[r] = x0[r] * 0x1p-8f;
      if constexpr (BITS == 4) {
        const float xh = to_float(src[r * ld + hi]);
        h4[r] = xh * 0x1p-4f;
        h12[r] = xh * 0x1p-12f;
      }
    }
#pragma unroll
    for (int half = 0; half < VEC / 2; ++half) {
      const unsigned h = half % 2 ? w[half / 2] >> 16 : w[half / 2];
      const int j = 2 * half;                // columns j (bits 0-7), j + 1
      if constexpr (BITS == 4) {
        const float lo0 = nibble_scaled<0>(h), up0 = nibble_scaled<4>(h);
        const float lo1 = nibble_scaled<8>(h), up1 = nibble_scaled<12>(h);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][j] = fmaf(x0[r], lo0, fmaf(h4[r], up0, acc[r][j]));
          acc[r][j + 1] = fmaf(x8[r], lo1, fmaf(h12[r], up1, acc[r][j + 1]));
        }
      } else {
        const float v0 = byte_scaled<0>(h), v1 = byte_scaled<8>(h);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][j] = fmaf(x0[r], v0, acc[r][j]);
          acc[r][j + 1] = fmaf(x8[r], v1, acc[r][j + 1]);
        }
      }
    }
  } else {
    float xl[ROWS], xh[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xl[r] = to_float(src[r * ld]);
      if constexpr (BITS == 4) xh[r] = to_float(src[r * ld + hi]);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const unsigned word = w[j / 4];
      if constexpr (BITS == 4) {
        const float lo = nibble(word, 8 * (j % 4));
        const float up = nibble(word, 8 * (j % 4) + 4);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r][j] = fmaf(xl[r], lo, fmaf(xh[r], up, acc[r][j]));
      } else {
        const float v = byte_value(word, 8 * (j % 4));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(xl[r], v, acc[r][j]);
      }
    }
  }
}

// acc += packed rows [pb, pe) of a column group (wp: its first column at
// packed row 0, rows bw apart) times src [ROWS, ld] in shared memory: four
// packed rows' loads in flight, then their products.
template <typename T, int BITS, int ROWS, int VEC>
__device__ __forceinline__ void dot_rows(const T* src, int ld, int hi,
                                         const int8_t* __restrict__ wp, int bw,
                                         int pb, int pe,
                                         float (&acc)[ROWS][VEC]) {
  int p = pb;
  for (; p + 4 <= pe; p += 4) {
    unsigned w[4][VEC / 4];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_w<VEC>(wp + (size_t)(p + u) * bw, w[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      fma_row<T, BITS, ROWS, VEC>(src + p + u, ld, hi, w[u], acc);
  }
  for (; p < pe; ++p) {
    unsigned w[VEC / 4];
    load_w<VEC>(wp + (size_t)p * bw, w);
    fma_row<T, BITS, ROWS, VEC>(src + p, ld, hi, w, acc);
  }
}

// One pass: for every column `col` in cols.a1.. and cols.a2.. (groups of
// VEC), the sum over packed rows [0, prow) of src [ROWS, ld] times the
// column of the stream's tiles tile0, tile0 + 1, ... (column col lies in
// tile tile0 + col / bw), from packed row p_base on; emit(r, col, sum,
// scale, bias) for every row and column, with the column's scale and (if
// BIAS, else 0) bias from the tiles' rows in sbe. Those rows are staged
// in shared memory (`stage`, split_stage floats twice) while the products
// run. Every thread of the block calls it (it synchronizes); red holds
// kRedBytes of shared memory.
template <typename T, int BITS, int ROWS, int VEC, bool BIAS, typename Emit>
__device__ void split_pass(const T* src, int ld, int hi,
                           const int8_t* __restrict__ we,
                           const float* __restrict__ sbe, int tile0, int kr,
                           int bw, int p_base, int prow, Cols cols, float* red,
                           float* stage, Emit emit) {
  const int n1 = (cols.b1 - cols.a1 + VEC - 1) / VEC;
  const int ng = n1 + (cols.b2 - cols.a2 + VEC - 1) / VEC;
  if (ng == 0) return;
  auto col_of = [&](int g) {
    return g < n1 ? cols.a1 + g * VEC : cols.a2 + (g - n1) * VEC;
  };
  auto wcol = [&](int col) {
    const int t = col / bw;
    return we + ((size_t)(tile0 + t) * kr + p_base) * bw + (col - t * bw);
  };
  float* sc = stage;
  float* bi = stage + ng * VEC;
  for (int lc = threadIdx.x; lc < ng * VEC; lc += kSplitThreads) {
    const int col = col_of(lc / VEC) + lc % VEC, t = col / bw;
    const float* st = sbe + (size_t)(tile0 + t) * 2 * bw + (col - t * bw);
    sc[lc] = st[0];
    if constexpr (BIAS) bi[lc] = st[bw];
  }
  auto emit_at = [&](int r, int g, int j, float v) {
    const int lc = g * VEC + j;
    emit(r, col_of(g) + j, v, sc[lc], BIAS ? bi[lc] : 0.f);
  };
  const int kz = max(1, min(kSplitThreads / ng, (prow + 3) / 4));
  if (kz == 1) {
    __syncthreads();
    for (int g = threadIdx.x; g < ng; g += kSplitThreads) {
      float acc[ROWS][VEC] = {};
      dot_rows<T, BITS, ROWS, VEC>(src, ld, hi, wcol(col_of(g)), bw, 0, prow,
                                   acc);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j) emit_at(r, g, j, acc[r][j]);
    }
    return;
  }
  // kz threads per column group, each over a chunk of the packed rows
  const int chunk = ((prow + kz - 1) / kz + 3) & ~3;
  const int t = threadIdx.x, g = t % ng, z = t / ng;
  const bool active = z < kz;
  float acc[ROWS][VEC] = {};
  if (active) {
    const int pb = z * chunk, pe = min(prow, pb + chunk);
    if (pb < pe)
      dot_rows<T, BITS, ROWS, VEC>(src, ld, hi, wcol(col_of(g)), bw, pb, pe, acc);
  }
  constexpr int kAcc = ROWS * VEC;
#pragma unroll
  for (int q = 0; q < (kAcc + 15) / 16; ++q) {
    if (active) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (16 * q + i < kAcc)
          red[t * kRedStride + i] = acc[(16 * q + i) / VEC][(16 * q + i) % VEC];
    }
    __syncthreads();
    for (int v = t; v < ng * 16; v += kSplitThreads) {
      const int gg = v >> 4, i = v & 15, f = 16 * q + i;
      if (f >= kAcc) continue;
      float sum = 0.f;
      for (int zz = 0; zz < kz; ++zz) sum += red[(zz * ng + gg) * kRedStride + i];
      emit_at(f / VEC, gg, f % VEC, sum);
    }
    __syncthreads();
  }
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// Calls f(Int<ROWS>, Int<VEC>): a kernel of 4-row tiles (DECODE) runs
// ROWS = 2 or 4 with 16-byte loads where the tile width bw allows them (a
// load never crosses a tile), else 4 rows with 4-byte loads; the others
// take the smallest of 4, 8, 16 rows that holds `live` with 4-byte loads,
// so that ROWS * VEC <= 64 and no instance holds more than 64
// accumulators.
template <bool DECODE, typename F>
__device__ __forceinline__ void dispatch_rows(int live, int bw, F f) {
  if constexpr (DECODE) {
    if (bw % 16) f(Int<4>{}, Int<4>{});
    else if (live <= 2) f(Int<2>{}, Int<16>{});
    else f(Int<4>{}, Int<16>{});
  } else {
    if (live <= 4) f(Int<4>{}, Int<4>{});
    else if (live <= 8) f(Int<8>{}, Int<4>{});
    else f(Int<16>{}, Int<4>{});
  }
}

// activate<ACT> with the activation code chosen at run time (K2/K4 apply
// it once per hidden value, so one kernel serves every activation)
__device__ __forceinline__ float activate(int act, float y) {
  return act == 0 ? activate<0>(y) : act == 1 ? activate<1>(y) : activate<2>(y);
}

// The combine of a split call: out[e, r, col] for every row of every
// expert, zeros at or past counts[e], else the S float32 partials of
// ws [S, E, C, n] summed in slice order, scaled by the down projection's
// column scale (plus its bias when BIAS) once and rounded to T.
template <typename T, bool BIAS>
__device__ __forceinline__ void combine_body(
    const float* __restrict__ ws, const float* __restrict__ sb,
    const int* __restrict__ counts, T* __restrict__ out, int split, int E,
    int C, int n, int t_down, int t_all, int bw) {
  const size_t total = (size_t)E * C * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % n);
    const size_t er = i / n;
    const int r = (int)(er % C), e = (int)(er / C);
    float y = 0.f;
    if (r < min(max(counts[e], 0), C)) {
      float sum = 0.f;
      for (int s = 0; s < split; ++s) sum += ws[(size_t)s * total + i];
      const int t = col / bw, c = col - t * bw;
      const float* st = sb + ((size_t)e * t_all + t_down + t) * 2 * bw;
      y = BIAS ? fmaf(sum, st[c], st[bw + c]) : __fmul_rn(sum, st[c]);
    }
    out[i] = from_float<T>(y);
  }
}

// Blocks of the combine kernel (256 threads, grid-stride).
__host__ __forceinline__ unsigned combine_blocks(size_t total) {
  const size_t blocks = (total + kSplitThreads - 1) / kSplitThreads;
  return (unsigned)(blocks < 4096 ? blocks : 4096);
}

}  // namespace ffn
