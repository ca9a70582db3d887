// Integer-domain grouped GEMM, int8 activations x INT8/INT4 weights (K5).
//
// Replaces the Pallas kernel `grouped_gemm_w8a8` (tutel_tpu/ops/
// w8a8_pallas.py:81, body `_w8a8_kernel` :49):
//   out[e, r, n] = (float)(sum_k xq[e, r, k] * q[e, k, n]) * sx[e, r] * sw[e, n]
// for r < counts[e], and 0 for r >= counts[e]. xq int8 [E, C, K] and its
// row scales sx f32 [E, C] come from the wrapper's per-row quantization
// (`quantize_activations`); q is int8 [E, K, N] or INT4 [E, K/2, N] in
// split-half packing (one block; block-packed INT4 is unpacked to INT8 by
// the wrapper); sw f32 [E, 1, N]; out [E, C, N] in x's type. The sum is
// exact in int32, so the two rescales, in this order, are the only
// rounding, as in the Pallas kernel.
//
// What bounds it on an H100: at decode shapes (a few rows per expert) the
// kernel must read every live expert's packed weights once: K*N/2 bytes
// per expert at INT4, 268 MB for 128 experts at 2048 x 2048. It is bound
// by those bytes over HBM bandwidth.
//
// Design (simple first, as K1 in grouped_gemm_quant.cu): one block per
// (expert, 512-column strip), 128 threads, each owning 4 adjacent output
// columns, so one 32-bit load brings 4 columns of a weight row and a warp
// reads 128 contiguous bytes. Four such loads (four rows) are transposed
// in registers and fed to __dp4a against the activation words
// (ffn_common.cuh); INT4 nibbles stay in the top half of their bytes, so
// unpacking costs one shift and one mask per word. Activation rows are
// staged in shared memory as 32-bit words, a chunk of packed rows at a
// time, and read as broadcasts. The block walks its expert's live rows in
// tiles of 4, 8 or 16 picked from the live row count; experts with no
// rows read no weights. Tensor cores are not used yet.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

constexpr int kThreads = 128;
constexpr int kCols = 4;                       // columns per thread
constexpr int kStrip = kThreads * kCols;       // columns per block
constexpr int kMaxRows = 16;                   // largest row tile
constexpr int kChunk = 256;                    // packed rows per staging pass
constexpr int kWords = kChunk / 4;

// One row tile: rows [r0, r0 + live) of expert e, ROWS >= live.
template <typename T, int BITS, int ROWS>
__device__ void w8a8_tile(const int8_t* __restrict__ xq,
                          const float* __restrict__ sx,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ sw, T* __restrict__ out,
                          int r0, int live, int K, int N, int n0,
                          int (*xs_lo)[kWords], int (*xs_hi)[kWords]) {
  const int tid = threadIdx.x;
  const bool col_ok = n0 < N;
  const int kp = BITS == 4 ? K / 2 : K;        // packed rows
  int acc[ROWS][kCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0;

  for (int p0 = 0; p0 < kp; p0 += kChunk) {
    const int pc = min(kChunk, kp - p0);       // a multiple of 4
    __syncthreads();
    for (int idx = tid; idx < ROWS * kWords; idx += kThreads) {
      const int r = idx / kWords, i = idx % kWords;
      const bool ok = r < live && 4 * i < pc;
      const int8_t* xr = xq + (size_t)(r0 + r) * K + p0 + 4 * i;
      xs_lo[r][i] = ok ? *reinterpret_cast<const int*>(xr) : 0;
      if constexpr (BITS == 4)
        xs_hi[r][i] = ok ? *reinterpret_cast<const int*>(xr + kp) : 0;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int8_t* wp = w + (size_t)p0 * N + n0;
#pragma unroll 2
    for (int i = 0; i < pc / 4; ++i) {
      unsigned wr[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        wr[b] = *reinterpret_cast<const unsigned*>(wp + (size_t)(4 * i + b) * N);
      int xl[ROWS], xh[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        xl[r] = xs_lo[r][i];
        if constexpr (BITS == 4) xh[r] = xs_hi[r][i];
        else xh[r] = 0;
      }
      dp4a_cols<BITS, ROWS>(wr, xl, xh, acc);
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= live) break;
    const float s = sx[r0 + r];
    T* o = out + (size_t)(r0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[j] = from_float<T>(__fmul_rn(__fmul_rn((float)int_sum<BITS>(acc[r][j]), s),
                                     sw[n0 + j]));
  }
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
gmm_w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ w, const float* __restrict__ sw,
                const int* __restrict__ counts, T* __restrict__ out, int C,
                int K, int N) {
  __shared__ int xs_lo[kMaxRows][kWords];
  __shared__ int xs_hi[BITS == 4 ? kMaxRows : 1][kWords];
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  const int kp = BITS == 4 ? K / 2 : K;
  const int count = min(max(counts[e], 0), C);
  const int8_t* xe = xq + (size_t)e * C * K;
  const float* se = sx + (size_t)e * C;
  const int8_t* we = w + (size_t)e * kp * N;
  const float* swe = sw + (size_t)e * N;
  T* oe = out + (size_t)e * C * N;

  for (int r0 = 0; r0 < count; r0 += kMaxRows) {
    const int live = min(kMaxRows, count - r0);
    if (live <= 4)
      w8a8_tile<T, BITS, 4>(xe, se, we, swe, oe, r0, live, K, N, n0, xs_lo, xs_hi);
    else if (live <= 8)
      w8a8_tile<T, BITS, 8>(xe, se, we, swe, oe, r0, live, K, N, n0, xs_lo, xs_hi);
    else
      w8a8_tile<T, BITS, 16>(xe, se, we, swe, oe, r0, live, K, N, n0, xs_lo, xs_hi);
  }
  if (n0 < N) {
    for (int r = count; r < C; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) oe[(size_t)r * N + n0 + j] = from_float<T>(0.f);
    }
  }
}

template <typename T, int BITS>
cudaError_t launch(const int8_t* xq, const float* sx, const int8_t* w,
                   const float* sw, const int* counts, void* out, int E, int C,
                   int K, int N, cudaStream_t stream) {
  dim3 grid((N + kStrip - 1) / kStrip, E);
  gmm_w8a8_kernel<T, BITS><<<grid, kThreads, 0, stream>>>(
      xq, sx, w, sw, counts, static_cast<T*>(out), C, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the output's type). Requires N % 4 ==
// 0, K % 4 == 0 (K % 8 == 0 for INT4), contiguous tensors on `device`.
// Returns a cudaError_t.
int grouped_gemm_w8a8_launch(const int8_t* xq, const float* sx,
                             const int8_t* w, const float* sw,
                             const int* counts, void* out, int E, int C, int K,
                             int N, int bits, int dtype, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = bits == 4 ? launch<__nv_bfloat16, 4>(xq, sx, w, sw, counts, out, E, C, K, N, s)
                    : launch<__nv_bfloat16, 8>(xq, sx, w, sw, counts, out, E, C, K, N, s);
  } else {
    err = bits == 4 ? launch<float, 4>(xq, sx, w, sw, counts, out, E, C, K, N, s)
                    : launch<float, 8>(xq, sx, w, sw, counts, out, E, C, K, N, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
