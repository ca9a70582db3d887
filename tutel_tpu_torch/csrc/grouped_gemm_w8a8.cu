// Integer-domain grouped GEMM: x quantized per row to int8, times INT8 or
// INT4 weights, on the tensor cores (K5).
//
// Replaces the Pallas kernel `grouped_gemm_w8a8` (tutel_tpu/ops/
// w8a8_pallas.py:81, body `_w8a8_kernel` :49) together with the per-row
// quantization of x that precedes it (`quantize_activations`, :38):
//   sx[e, r] = max_k |x[e, r, k]| / 127 (1 for a row of zeros)
//   xq[e, r, k] = clamp(rint(x[e, r, k] / sx[e, r]), -128, 127)
//   out[e, r, n] = (float)(sum_k xq[e, r, k] * q[e, k, n]) * sx[e, r] * sw[e, n]
// for r < counts[e], and 0 for r >= counts[e]. x [E, C, K] float32 or
// bfloat16; q int8 [E, K, N], or INT4 [E, K/2, N] in split-half packing
// (one block; block-packed INT4 is unpacked to INT8 by the wrapper); sw f32
// [E, 1, N]; out [E, C, N] in x's type. The quantization is
// `quantize_activations`' arithmetic (correctly rounded divisions, rint),
// the int32 sums are exact, and the two rescales run in this order with no
// fused multiply-add, so the result equals the plain twin bit for bit
// where x is finite. A row holding NaN is not: fmaxf skips the NaN in the
// absmax where the twin's amax keeps it, and the twin's int8 conversion of
// NaN is undefined.
//
// What bounds it on an H100: at decode shapes (a few rows per expert) the
// kernel must read every live expert's packed weights once: K*N/2 bytes
// per expert at INT4, 268 MB for 128 experts at 2048 x 2048. It is bound
// by those bytes over HBM bandwidth; x, its quantization and the output are
// a few percent of that.
//
// Design: K1's grid (grouped_gemm_quant.cu) with K3's int8 tensor-core body
// (gemm_tc.cuh). One block of 4 warps per (row-tile group, strip of
// 8 * VEC columns, expert): 128 columns where N allows 16-byte loads, 32
// otherwise. The warps split the expert's k-steps in four; each lane loads
// 16 bytes of each of its packed rows straight into registers, one k-step
// ahead of the one it multiplies, and one 4 x 4 byte
// transpose per 4 packed rows of 4 columns makes the A registers of
// mma.sync m16n8k32 s8 with the weights as the M operand (at INT4 each
// nibble in the top half of its byte). A tile holds 8 or 16 rows (one or two
// n-blocks of the mma): the launch's tile (the wrapper's plan from the
// routed rows) sets the registers and shared memory, and a tile with at most
// 8 live rows runs one n-block. Up to 4 blocks side by side on a strip take
// every groups-th row tile of the expert and share its weights in L2.
//
// The quantization runs here, on live rows only, so a call is one launch.
// For each row tile the block first issues its first weight loads, then
// reads the live rows over the whole K for their absmax (a warp a row; max
// is order-free, so the split is exact) and their scales; then each warp
// quantizes the x of its own k-steps into shared memory, up to 32 k-steps
// at a time (`tc::chunk_steps`), so shared memory does not grow with K. B
// registers are 32-bit loads of the staged int8 rows, padded against bank
// conflicts. The four warps' int32 partials meet in shared memory; the
// epilogue rescales and rounds them. Experts with no rows read no weights,
// and rows at or past counts[e] are written as zeros.
//
// Each block would quantize the same rows as the other strips' blocks of
// its expert. Where the tiles hold 16 rows and each warp's x fits one
// chunk, a block therefore takes up to 4 strips (the wrapper's plan,
// `w8a8.k5_plan`, keeps two waves of blocks) and quantizes its rows once
// for all of them; the partials then sit beside the staged x.

#include "ffn_common.cuh"
#include "gemm_tc.cuh"

namespace {

using namespace ffn;

constexpr int kWarps = tc::kSplitWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kXPad = 16;                      // bytes after each staged row
// k-steps per load group: one (16 packed rows at INT4, 32 at INT8; a warp
// has one group in flight while it multiplies the other)
constexpr int kDepth = 1;

// Shared memory of a block of `rows`-row tiles: each warp's staged int8 x
// chunk, and the warps' int32 partials after it, or over it where the
// block takes one strip (w8a8.py `k5_smem` mirrors it).
__host__ __device__ inline size_t k5_xs_bytes(int bits, int rows, int K) {
  const int kp = bits == 4 ? K / 2 : K;
  const int nsteps = (kp + tc::k3_step_rows(bits) - 1) / tc::k3_step_rows(bits);
  return (size_t)kWarps * rows * (32 * tc::chunk_steps(nsteps) + kXPad);
}
__host__ __device__ inline size_t k5_smem(int bits, int vec, int rows, int K,
                                          int strips) {
  const size_t xs = k5_xs_bytes(bits, rows, K);
  const size_t red = (size_t)kWarps * rows * (8 * vec + 4) * 4;
  return strips > 1 ? xs + red : xs > red ? xs : red;
}

// Four values of x from p on as float: one 16-byte (float32) or 8-byte
// (bfloat16) load where x is aligned for it, else four.
__device__ __forceinline__ void load4(const float* p, bool vec, float v[4]) {
  if (vec) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p[j];
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      float v[4]) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// The row scales of rows [0, live) of the tile (rows K apart from x): a
// warp a row, its lanes over 4-value groups of the whole row.
template <typename T>
__device__ void row_scales(const T* __restrict__ x, int K, int live, bool vec,
                           float* scale) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < live; r += kWarps) {
    const T* xr = x + (size_t)r * K;
    float m = 0.f;
    for (int i = 4 * lane; i < K; i += 128) {
      float v[4];
      load4(xr + i, vec, v);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                         fmaxf(fabsf(v[2]), fabsf(v[3]))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) scale[r] = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  }
}

// Two adjacent outputs (an 8- or 4-byte store), and four zeros.
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void zero4(float* o) {
  *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero4(__nv_bfloat16* o) {
  *reinterpret_cast<uint2*>(o) = make_uint2(0u, 0u);
}

// Four values quantized with their row's scale as `quantize_activations`
// does it (a correctly rounded quotient, rint, clamp), packed low byte
// first.
__device__ __forceinline__ uint32_t quantize4(const float v[4], float s) {
  uint32_t word = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = min(max(__float2int_rn(__fdiv_rn(v[j], s)), -128), 127);
    word |= (uint32_t)(q & 0xFF) << (8 * j);
  }
  return word;
}

// Word j of a staged row for the warp's k-steps [c, c + n): its first x
// element (src), its byte in the staged row (dst), and whether it lies
// inside the packed rows (INT4) or K (INT8); at INT4 words [0, 4n) hold the
// x of the low nibbles of packed rows 16c .., words [4n, 8n) that of the
// high nibbles (kp further on in x), from byte 16 * chunk (w8a8.py
// `k5_stage_words`).
template <int BITS>
__device__ __forceinline__ bool stage_word(int j, int c, int n, int chunk,
                                           int kp, int K, int& src, int& dst) {
  if constexpr (BITS == 4) {
    const bool hi = j >= 4 * n;
    const int p = 16 * c + 4 * (hi ? j - 4 * n : j);
    src = hi ? kp + p : p;
    dst = (hi ? 16 * chunk : 0) + p - 16 * c;
    return p < kp;
  } else {
    src = 32 * c + 4 * j;
    dst = 4 * j;
    return src < K;
  }
}

// One warp stages the int8 x of its k-steps [c, c + n) for rows [0, rows)
// of the tile, `stride` bytes a row; x outside the packed rows or K, and
// rows >= live, stage as 0. A lane takes words of the staged rows.
template <int BITS, typename T>
__device__ void stage_chunk(int8_t* xs, const T* __restrict__ x,
                            const float* scale, int rows, int live, int K,
                            int kp, int c, int n, int chunk, int stride,
                            bool vec) {
  for (int j = threadIdx.x % 32; j < 8 * n; j += 32) {
    int src, dst;
    const bool ok = stage_word<BITS>(j, c, n, chunk, kp, K, src, dst);
    for (int r = 0; r < rows; ++r) {
      uint32_t word = 0u;
      if (ok && r < live) {
        float v[4];
        load4(x + (size_t)r * K + src, vec, v);
        word = quantize4(v, scale[r]);
      }
      *reinterpret_cast<uint32_t*>(xs + (size_t)r * stride + dst) = word;
    }
  }
}

// The warps' partials of one strip meet in `red` [warp][row][column] (d0,
// d1: column a_col(i, 0) at rows 2t, 2t + 1; d2, d3: column a_col(i, 1)),
// then the exact sum becomes (float)sum * sx * sw, two adjacent columns a
// thread.
template <typename T, int BITS, int VEC, int NB>
__device__ void k5_epilogue(int (*acc)[VEC / 2][4], int* red,
                            T* __restrict__ out, const float* __restrict__ sw,
                            const float* scale, int live, int N, int c0) {
  constexpr int STRIP = 8 * VEC;
  constexpr int RED = STRIP + 4;               // ints a row of partials
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  __syncthreads();                             // the mmas' reads done
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const int cc = tc::a_col(VEC, g, i, 0);
      int* p = red + ((size_t)warp * 8 * NB + 8 * nb + 2 * t) * RED + cc;
      *reinterpret_cast<int2*>(p) = make_int2(acc[nb][i][0], acc[nb][i][2]);
      *reinterpret_cast<int2*>(p + RED) = make_int2(acc[nb][i][1], acc[nb][i][3]);
    }
  __syncthreads();
  constexpr int PAIRS = STRIP / 2;
  for (int idx = threadIdx.x; idx < live * PAIRS; idx += kThreads) {
    const int r = idx / PAIRS, cc = 2 * (idx % PAIRS);
    if (c0 + cc >= N) continue;
    int v0 = 0, v1 = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int2 p = *reinterpret_cast<const int2*>(
          red + ((size_t)k * 8 * NB + r) * RED + cc);
      v0 += p.x;
      v1 += p.y;
    }
    const float s = scale[r];
    store2(out + (size_t)r * N + c0 + cc,
           __fmul_rn(__fmul_rn((float)int_sum<BITS>(v0), s), sw[c0 + cc]),
           __fmul_rn(__fmul_rn((float)int_sum<BITS>(v1), s), sw[c0 + cc + 1]));
  }
}

// One tile of NB n-blocks: rows [0, live) of x / out (offset by the caller)
// over the block's strips, columns [c_begin, c_end). Warp w takes k-steps
// [w * nsteps / 4, (w + 1) * nsteps / 4) in chunks of `chunk`
// (`tc_warp_chunks`), quantizing each chunk's x into its own region of xs
// (TILE rows of `stride` bytes) before its mmas; where its k-steps fit one
// chunk, once for all the block's strips. The partials go to `red`.
template <typename T, int BITS, int VEC, int NB, int TILE>
__device__ void k5_tile(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ sw, T* __restrict__ out,
                        int live, int K, int N, int kp, int nsteps, int chunk,
                        int c_begin, int c_end, bool vec, int8_t* smem,
                        int* red, float* scale) {
  constexpr int STRIP = 8 * VEC;
  constexpr int D = kDepth;
  constexpr int LOADS = tc::k3_loads(BITS);
  const int stride = 32 * chunk + kXPad;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  __syncthreads();                             // the last tile's reads done

  const int s_begin = warp * nsteps / kWarps;
  const int s_end = (warp + 1) * nsteps / kWarps;
  const bool once = s_end - s_begin <= chunk;
  // the warp's packed rows: no load past them, not even a group ahead
  const int prow = min(kp, s_end * tc::k3_step_rows(BITS));
  uint32_t fa[D][LOADS][VEC / 4], fb[D][LOADS][VEC / 4];
  int col = c_begin + VEC * g;
  bool col_ok = col < N;
  const int8_t* wl = w + (col_ok ? col : 0);
  tc::s8_load_group<BITS, VEC, D>(fa, wl, s_begin, prow, N, t, col_ok);
  row_scales(x, K, live, vec, scale);
  __syncthreads();

  int8_t* xs = smem + (size_t)warp * TILE * stride;
  const int8_t* xrow[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) xrow[nb] = xs + (size_t)(8 * nb + g) * stride;
  if (once)
    stage_chunk<BITS>(xs, x, scale, 8 * NB, live, K, kp, s_begin,
                      s_end - s_begin, chunk, stride, vec);
  for (int c0 = c_begin; c0 < c_end; c0 += STRIP) {
    if (c0 != c_begin) {                       // the next strip's first group
      col = c0 + VEC * g;
      col_ok = col < N;
      wl = w + (col_ok ? col : 0);
      tc::s8_load_group<BITS, VEC, D>(fa, wl, s_begin, prow, N, t, col_ok);
    }
    int acc[NB][VEC / 2][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nb][i][r] = 0;
    for (int c = s_begin; c < s_end; c += chunk) {
      const int ce = min(c + chunk, s_end);
      if (!once) {
        __syncwarp();                          // the last chunk's reads done
        stage_chunk<BITS>(xs, x, scale, 8 * NB, live, K, kp, c, ce - c, chunk,
                          stride, vec);
      }
      __syncwarp();
      for (int s = c; s < ce; s += 2 * D) {
        tc::s8_load_group<BITS, VEC, D>(fb, wl, s + D, prow, N, t, col_ok);
        tc::s8_mma_group<BITS, VEC, NB, D>(fa, xrow, s - c, ce - c, 16 * chunk, t, acc);
        tc::s8_load_group<BITS, VEC, D>(fa, wl, s + 2 * D, prow, N, t, col_ok);
        tc::s8_mma_group<BITS, VEC, NB, D>(fb, xrow, s - c + D, ce - c, 16 * chunk, t, acc);
      }
    }
    k5_epilogue<T, BITS, VEC, NB>(acc, red, out, sw, scale, live, N, c0);
  }
}

// Block (z, y, e): expert e's row tiles z, z + Z, z + 2Z, ... (Z =
// gridDim.x row-tile groups) over strips [y * strips, (y + 1) * strips) of
// columns. The Z blocks of one strip are neighbours in the grid, so they
// run side by side and read its weights from memory about once.
// At most 128 registers a thread with one n-block (4 blocks an SM), 168
// with two (3): the weight stream needs the warps more than the registers.
template <typename T, int BITS, int VEC, int NB_MAX>
__global__ void __launch_bounds__(kThreads, NB_MAX == 1 ? 4 : 3)
gmm_w8a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ sw, const int* __restrict__ counts,
                T* __restrict__ out, int C, int K, int N, int strips) {
  extern __shared__ __align__(16) int8_t smem_k5[];
  constexpr int TILE = 8 * NB_MAX;
  __shared__ float scale[TILE];
  const int z = blockIdx.x, groups = gridDim.x;
  const int c_begin = blockIdx.y * strips * 8 * VEC;
  const int c_end = min(c_begin + strips * 8 * VEC, N);
  const int e = blockIdx.z;
  const int kp = BITS == 4 ? K / 2 : K;
  const int nsteps = (kp + tc::k3_step_rows(BITS) - 1) / tc::k3_step_rows(BITS);
  const int chunk = tc::chunk_steps(nsteps);
  const int count = min(max(counts[e], 0), C);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
  int* red = reinterpret_cast<int*>(
      smem_k5 + (strips > 1 ? k5_xs_bytes(BITS, TILE, K) : 0));
  const T* xe = x + (size_t)e * C * K;
  const int8_t* we = w + (size_t)e * kp * N;
  const float* se = sw + (size_t)e * N;
  T* oe = out + (size_t)e * C * N;

  for (int r0 = z * TILE; r0 < count; r0 += groups * TILE) {
    const int live = min(TILE, count - r0);
    if (NB_MAX == 1 || live <= 8)
      k5_tile<T, BITS, VEC, 1, TILE>(xe + (size_t)r0 * K, we, se,
                                     oe + (size_t)r0 * N, live, K, N, kp,
                                     nsteps, chunk, c_begin, c_end, vec,
                                     smem_k5, red, scale);
    else
      k5_tile<T, BITS, VEC, NB_MAX, TILE>(xe + (size_t)r0 * K, we, se,
                                          oe + (size_t)r0 * N, live, K, N, kp,
                                          nsteps, chunk, c_begin, c_end, vec,
                                          smem_k5, red, scale);
  }
  // rows at or past the count (every groups-th of them here): zeros, 4
  // columns a store
  const int quads = (c_end - c_begin + 3) / 4;
  const int dead = (C - count + groups - 1 - z) / groups;
  for (int idx = threadIdx.x; idx < dead * quads; idx += kThreads) {
    const int r = count + z + groups * (idx / quads);
    zero4(oe + (size_t)r * N + c_begin + 4 * (idx % quads));
  }
}

template <typename T, int BITS, int VEC, int NB_MAX>
cudaError_t launch(const void* x, const int8_t* w, const float* sw,
                   const int* counts, void* out, int E, int C, int K, int N,
                   int groups, int strips, cudaStream_t stream) {
  auto kernel = gmm_w8a8_kernel<T, BITS, VEC, NB_MAX>;
  const size_t smem = k5_smem(BITS, VEC, 8 * NB_MAX, K, strips);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(groups, (N + strips * 8 * VEC - 1) / (strips * 8 * VEC), E);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), w, sw,
                                           counts, static_cast<T*>(out), C, K,
                                           N, strips);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t dispatch(const void* x, const int8_t* w, const float* sw,
                     const int* counts, void* out, int E, int C, int K, int N,
                     int tile_rows, int groups, int strips, cudaStream_t s) {
  // 16-byte weight loads where every packed row starts 16-byte aligned
  const bool wide = N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (tile_rows == 8)
    return wide ? launch<T, BITS, 16, 1>(x, w, sw, counts, out, E, C, K, N, groups, strips, s)
                : launch<T, BITS, 4, 1>(x, w, sw, counts, out, E, C, K, N, groups, strips, s);
  return wide ? launch<T, BITS, 16, 2>(x, w, sw, counts, out, E, C, K, N, groups, strips, s)
              : launch<T, BITS, 4, 2>(x, w, sw, counts, out, E, C, K, N, groups, strips, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x's and the output's type); tile_rows 8
// or 16, groups >= 1 row-tile groups per strip, strips >= 1 strips per
// block. Requires N % 4 == 0, K % 4 == 0 (K % 8 for INT4), contiguous
// tensors on `device`. Returns a cudaError_t.
int grouped_gemm_w8a8_launch(const void* x, const int8_t* w, const float* sw,
                             const int* counts, void* out, int E, int C, int K,
                             int N, int bits, int dtype, int tile_rows,
                             int groups, int strips, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((tile_rows != 8 && tile_rows != 16) || groups < 1 || strips < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = bits == 4 ? dispatch<__nv_bfloat16, 4>(x, w, sw, counts, out, E, C, K, N, tile_rows, groups, strips, s)
                    : dispatch<__nv_bfloat16, 8>(x, w, sw, counts, out, E, C, K, N, tile_rows, groups, strips, s);
  } else {
    err = bits == 4 ? dispatch<float, 4>(x, w, sw, counts, out, E, C, K, N, tile_rows, groups, strips, s)
                    : dispatch<float, 8>(x, w, sw, counts, out, E, C, K, N, tile_rows, groups, strips, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
