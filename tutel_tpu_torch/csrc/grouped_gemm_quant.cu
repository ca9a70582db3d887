// Grouped GEMM with fused INT8 / INT4 weight dequantization (kernel K1).
//
// Replaces the Pallas kernel `grouped_gemm_quant` (tutel_tpu/ops/
// grouped_gemm_pallas.py:94, body `_gmm_kernel` :34):
//   out[e, r, :] = (x[e, r, :] @ q[e]) * scales[e]      for r < counts[e]
//   out[e, r, :] = 0                                     for r >= counts[e]
// x [E, C, K] float32 or bfloat16; q int8 [E, K, N], or INT4 [E, K/2, N] in
// split-half packing per contiguous K-block (`blocks`); scales f32 [E, 1, N];
// counts i32 [E]; out [E, C, N] in x's type. Dots accumulate in float32 and
// the column scale is applied after the dot, as in the Pallas kernel.
//
// What bounds it on an H100: at decode shapes (a few rows per expert) the
// kernel must read every live expert's packed weights once: K*N/2 bytes per
// expert at INT4, 268 MB for 128 experts at 2048 x 2048, against a few MB of
// activations. It is bound by those bytes over HBM bandwidth.
//
// Design (simple first): one block per (expert, 512-column strip), 128
// threads, each owning 4 adjacent output columns, so one 32-bit load brings
// 4 packed bytes and a warp reads 128 contiguous bytes of a weight row. The
// nibbles are unpacked in registers (sign-extending byte shifts; the Pallas
// int32-domain shifts were a Mosaic workaround). Activations are staged in
// shared memory as float, a chunk of packed rows at a time (the low and the
// high halves of each split-half block), and read as broadcasts. The block
// walks its expert's live rows in tiles; a tile of 4, 8 or 16 rows is picked
// from the live row count so that decode work scales with the routed rows.
// Experts with no rows read no weights. Tensor cores are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                       // columns per thread
constexpr int kStrip = kThreads * kCols;       // columns per block
constexpr int kMaxRows = 16;                   // largest row tile
constexpr int kChunk = 64;                     // packed rows per staging pass

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

// One row tile: rows [r0, r0 + live) of expert e, ROWS >= live.
template <typename T, int BITS, int ROWS>
__device__ void gemm_tile(const T* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scales, T* __restrict__ out,
                          int r0, int live, int K, int N, int blocks, int n0,
                          float (*xs_lo)[kChunk], float (*xs_hi)[kChunk]) {
  const int tid = threadIdx.x;
  const bool col_ok = n0 < N;
  const int kp = BITS == 4 ? K / 2 : K;        // packed rows
  const int kb = kp / blocks;                  // packed rows per block
  float acc[ROWS][kCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int b = 0; b < blocks; ++b) {
    const int kbase = b * (BITS == 4 ? 2 * kb : kb);   // first logical k
    for (int p0 = 0; p0 < kb; p0 += kChunk) {
      const int pc = min(kChunk, kb - p0);
      __syncthreads();
      for (int idx = tid; idx < ROWS * kChunk; idx += kThreads) {
        const int r = idx / kChunk, i = idx % kChunk;
        const bool ok = r < live && i < pc;
        const T* xr = x + (size_t)(r0 + r) * K + kbase + p0 + i;
        xs_lo[r][i] = ok ? to_float(xr[0]) : 0.f;
        if constexpr (BITS == 4) xs_hi[r][i] = ok ? to_float(xr[kb]) : 0.f;
      }
      __syncthreads();
      if (!col_ok) continue;
      const int8_t* wp = w + (size_t)(b * kb + p0) * N + n0;
#pragma unroll 4
      for (int i = 0; i < pc; ++i) {
        const unsigned packed = *reinterpret_cast<const unsigned*>(wp + (size_t)i * N);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const unsigned byte = packed >> (8 * j);
          if constexpr (BITS == 4) {
            const float lo = (float)((int)(int8_t)(byte << 4) >> 4);
            const float hi = (float)((int)(int8_t)byte >> 4);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r][j] = fmaf(xs_lo[r][i], lo, fmaf(xs_hi[r][i], hi, acc[r][j]));
          } else {
            const float q = (float)(int8_t)byte;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(xs_lo[r][i], q, acc[r][j]);
          }
        }
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= live) break;
    T* o = out + (size_t)(r0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[j] = from_float<T>(acc[r][j] * scales[n0 + j]);
  }
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
gmm_quant_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scales, const int* __restrict__ counts,
                 T* __restrict__ out, int C, int K, int N, int blocks) {
  __shared__ float xs_lo[kMaxRows][kChunk];
  __shared__ float xs_hi[BITS == 4 ? kMaxRows : 1][kChunk];
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  const int kp = BITS == 4 ? K / 2 : K;
  const int count = min(max(counts[e], 0), C);
  const T* xe = x + (size_t)e * C * K;
  const int8_t* we = w + (size_t)e * kp * N;
  const float* se = scales + (size_t)e * N;
  T* oe = out + (size_t)e * C * N;

  for (int r0 = 0; r0 < count; r0 += kMaxRows) {
    const int live = min(kMaxRows, count - r0);
    if (live <= 4)
      gemm_tile<T, BITS, 4>(xe, we, se, oe, r0, live, K, N, blocks, n0, xs_lo, xs_hi);
    else if (live <= 8)
      gemm_tile<T, BITS, 8>(xe, we, se, oe, r0, live, K, N, blocks, n0, xs_lo, xs_hi);
    else
      gemm_tile<T, BITS, 16>(xe, we, se, oe, r0, live, K, N, blocks, n0, xs_lo, xs_hi);
  }
  if (n0 < N) {
    for (int r = count; r < C; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) oe[(size_t)r * N + n0 + j] = from_float<T>(0.f);
    }
  }
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const int8_t* w, const float* scales,
                   const int* counts, void* out, int E, int C, int K, int N,
                   int blocks, cudaStream_t stream) {
  dim3 grid((N + kStrip - 1) / kStrip, E);
  gmm_quant_kernel<T, BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, scales, counts, static_cast<T*>(out), C, K,
      N, blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Requires N % 4 == 0, (K/2 or K) %
// blocks == 0, contiguous tensors on `device`. Returns a cudaError_t.
int grouped_gemm_quant_launch(const void* x, const int8_t* w, const float* scales,
                              const int* counts, void* out, int E, int C, int K,
                              int N, int bits, int blocks, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = bits == 4 ? launch<__nv_bfloat16, 4>(x, w, scales, counts, out, E, C, K, N, blocks, s)
                    : launch<__nv_bfloat16, 8>(x, w, scales, counts, out, E, C, K, N, blocks, s);
  } else {
    err = bits == 4 ? launch<float, 4>(x, w, scales, counts, out, E, C, K, N, blocks, s)
                    : launch<float, 8>(x, w, scales, counts, out, E, C, K, N, blocks, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
