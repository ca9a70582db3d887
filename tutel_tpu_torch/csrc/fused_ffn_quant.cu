// Fused quantized expert FFN, fc1 + activation + fc2 in one kernel (K2).
//
// Replaces the Pallas kernel `fused_ffn_quant` (tutel_tpu/ops/
// fused_ffn_pallas.py:209, body `_fused_kernel` :173). Per expert e and
// live row r < counts[e]:
//   h      = act(xr @ W1 * s1 + b1), rounded to x's type
//   out[r] = (h @ W2 * s2 + b2)[:n]
// Rows r >= counts[e] are written as zeros. The weights come in the JAX
// package's phase-packed stream: wstream int8 [E, T1+T2, Kr, bw], fc1
// column tiles then fc2 column tiles, each tile Kr packed rows x bw
// columns (INT4 split-half or INT8); sb f32 [E, T1+T2, 2, bw] holds the
// scale row and the bias row of every tile. xr is x re-laid to the
// unpacked row order of the fc1 tiles: for INT4 each half of x is
// zero-padded from K/2 to Kr (`_relayout_x`, fused_ffn_pallas.py:501).
// Dots accumulate in float32; scale, then bias, then the activation
// (0 = relu, 1 = tanh-approximated gelu) in float32.
//
// What bounds it on an H100: every live expert's whole stream is read once
// per call, (K*H + H*N)/2 bytes at INT4: 537 MB for 128 experts at
// 2048 x 2048 x 2048. The kernel is bound by those bytes over HBM
// bandwidth; activations and outputs are a few percent of that.
//
// Design (simple first): one block per (expert, row tile), 256 threads.
// The row tile's relaid x and its whole hidden activation [rows, H] live in
// shared memory (16 rows x 2048 x bf16 = 64 KB each), so the hidden never
// goes to device memory and the stream is read in one pass from fc1 into
// fc2. Each thread owns 4 adjacent columns of a tile: one 32-bit load brings
// 4 packed bytes, nibbles are unpacked in registers, activations are read
// from shared memory as broadcasts, and the sums stay in registers. A tile
// of 4, 8 or 16 rows is picked from the live row count. Experts with no
// rows read no weights. Tensor cores are not used yet.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

constexpr int kThreads = 256;
constexpr int kCols = 4;                       // columns per thread

// One phase over stream tiles [t_begin, t_end): src [ROWS][W] in shared
// memory times each tile, over the first `prow` packed rows.
// FC1 writes act(y) into hs; otherwise y goes to the output rows.
template <typename T, int BITS, int ACT, int ROWS, bool FC1>
__device__ void phase(const T* src, int W, const int8_t* __restrict__ we,
                      const float* __restrict__ sbe, int t_begin, int t_end,
                      int prow, int kr, int bw, T* hs, T* __restrict__ out,
                      int n, int t1, int live) {
  for (int t = t_begin; t < t_end; ++t) {
    const int8_t* tile = we + (size_t)t * kr * bw;
    const float* scale = sbe + (size_t)t * 2 * bw;
    const float* bias = scale + bw;
    for (int c0 = threadIdx.x * kCols; c0 < bw; c0 += kThreads * kCols) {
      float acc[ROWS][kCols];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
      float_dot_cols<T, BITS, ROWS>(src, W, tile + c0, prow, kr, bw, acc);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float s = scale[c0 + j], b = bias[c0 + j];
        if constexpr (FC1) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            hs[r * W + t * bw + c0 + j] = from_float<T>(activate<ACT>(fmaf(acc[r][j], s, b)));
        } else {
          const int col = (t - t1) * bw + c0 + j;
          if (col < n) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              if (r < live) out[(size_t)r * n + col] = from_float<T>(fmaf(acc[r][j], s, b));
          }
        }
      }
    }
  }
}

template <typename T, int BITS, int ACT, int ROWS>
__device__ void ffn_rows(const T* xs, T* hs, int W, const int8_t* we,
                         const float* sbe, int K, int kr, int bw, int t1, int t2,
                         T* out, int n, int live) {
  // fc1 reads only the packed rows that meet real inputs: the rest of each
  // half is zero padding in both x and the weights.
  const int prow1 = BITS == 4 ? K / 2 : K;
  phase<T, BITS, ACT, ROWS, true>(xs, W, we, sbe, 0, t1, prow1, kr, bw, hs, out, n, t1, live);
  __syncthreads();
  phase<T, BITS, ACT, ROWS, false>(hs, W, we, sbe, t1, t1 + t2, kr, kr, bw, hs, out, n, t1, live);
}

template <typename T, int BITS, int ACT>
__global__ void __launch_bounds__(kThreads)
fused_ffn_kernel(const T* __restrict__ x, const int8_t* __restrict__ wstream,
                 const float* __restrict__ sb, const int* __restrict__ counts,
                 T* __restrict__ out, int C, int K, int kr, int bw, int t1, int t2,
                 int n, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (BITS == 4 ? 2 : 1) * kr;      // unpacked rows == H
  T* xs = reinterpret_cast<T*>(smem);
  T* hs = xs + (size_t)tile_rows * W;
  const int e = blockIdx.x;
  const int r0 = blockIdx.y * tile_rows;
  const int count = min(max(counts[e], 0), C);
  const int rows_here = min(tile_rows, C - r0);
  const int live = max(0, min(rows_here, count - r0));
  T* oe = out + ((size_t)e * C + r0) * n;

  for (int idx = threadIdx.x; idx < (rows_here - live) * n; idx += kThreads)
    oe[(size_t)live * n + idx] = from_float<T>(0.f);
  if (live == 0) return;

  // stage x in the unpacked row order of the fc1 tiles; rows >= live are 0
  stage_x<BITS>(xs, x + ((size_t)e * C + r0) * K, K, kr, W, tile_rows, live,
                from_float<T>(0.f));
  __syncthreads();

  const int T_all = t1 + t2;
  const int8_t* we = wstream + (size_t)e * T_all * kr * bw;
  const float* sbe = sb + (size_t)e * T_all * 2 * bw;
  if (live <= 4)
    ffn_rows<T, BITS, ACT, 4>(xs, hs, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
  else if (live <= 8)
    ffn_rows<T, BITS, ACT, 8>(xs, hs, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
  else
    ffn_rows<T, BITS, ACT, 16>(xs, hs, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
}

template <typename T, int BITS, int ACT>
cudaError_t launch(const void* x, const int8_t* wstream, const float* sb,
                   const int* counts, void* out, int E, int C, int K, int kr,
                   int bw, int t1, int t2, int n, int tile_rows,
                   cudaStream_t stream) {
  const size_t W = (BITS == 4 ? 2 : 1) * (size_t)kr;
  const size_t smem = 2 * (size_t)tile_rows * W * sizeof(T);
  auto kernel = fused_ffn_kernel<T, BITS, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(E, (C + tile_rows - 1) / tile_rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), wstream, sb, counts, static_cast<T*>(out), C, K,
      kr, bw, t1, t2, n, tile_rows);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_act(int act, const void* x, const int8_t* wstream,
                       const float* sb, const int* counts, void* out, int E,
                       int C, int K, int kr, int bw, int t1, int t2, int n,
                       int tile_rows, cudaStream_t stream) {
  if (act == 0)
    return launch<T, BITS, 0>(x, wstream, sb, counts, out, E, C, K, kr, bw, t1,
                              t2, n, tile_rows, stream);
  return launch<T, BITS, 1>(x, wstream, sb, counts, out, E, C, K, kr, bw, t1,
                            t2, n, tile_rows, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = relu, 1 = gelu (tanh).
// tile_rows in {4, 8, 16}, with 2 * tile_rows * (bits == 4 ? 2 : 1) * kr *
// sizeof(x) bytes of shared memory allowed per block; bw % 4 == 0.
// Returns a cudaError_t.
int fused_ffn_quant_launch(const void* x, const int8_t* wstream, const float* sb,
                           const int* counts, void* out, int E, int C, int K,
                           int kr, int bw, int t1, int t2, int n, int bits,
                           int act, int dtype, int tile_rows, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = bits == 4
              ? launch_act<__nv_bfloat16, 4>(act, x, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s)
              : launch_act<__nv_bfloat16, 8>(act, x, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s);
  } else {
    err = bits == 4
              ? launch_act<float, 4>(act, x, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s)
              : launch_act<float, 8>(act, x, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
