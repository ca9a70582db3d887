// Fused quantized SwiGLU expert, (act(x @ W1) * (x @ W2)) @ W3 in one
// kernel (K4).
//
// Replaces the Pallas kernel `fused_swiglu_quant` (tutel_tpu/ops/
// fused_ffn_pallas.py:556, body `_swiglu_kernel` :522). Per expert e and
// live row r < counts[e], in x's type T:
//   h      = T(act(xr @ W1 * s1))
//   h      = T(float(h) * (xr @ W2 * s2))
//   out[r] = T(h @ W3 * s3)[:n]
// the two roundings of the hidden where the Pallas kernel makes them. Rows
// r >= counts[e] are written as zeros. The weights come in the stream of
// `prepare_fused_swiglu` (:433): wstream int8 [E, 2*T1+T2, Kr, bw], T1 W1
// tiles, T1 W2 tiles, then T2 W3 tiles, INT4 split-half or INT8; sb f32
// [E, 2*T1+T2, 2, bw] holds each tile's scale row (the bias rows are zero
// and not read). xr is x in the unpacked row order of the W1/W2 tiles
// (each INT4 half zero-padded from K/2 to Kr). Dots accumulate in float32.
//
// What bounds it on an H100: at decode, every live expert's weights are
// read once, (2*K*H + H*N)/2 bytes at INT4: 3 MB per expert, 96 MB for the
// LM's 32 experts at 1024 x 2048 x 1024, so it is bound by bytes; a
// prefill chunk of 16,384 routed rows does 2.1e11 operations and is bound
// by them.
//
// Design (simple first, as K2 in fused_ffn_quant.cu): one block per
// (expert, row tile), 256 threads. The row tile's relaid x and its whole
// hidden [rows, H] live in shared memory in T (16 rows x 2048 x bf16 =
// 64 KB each), so the hidden never goes to device memory and the stream is
// read in one pass: the W1 tiles write act(y) into the hidden, the W2
// tiles multiply it in place (each thread owns the same columns in both),
// the W3 tiles write the output. Each thread owns 4 adjacent columns of a
// tile: one 32-bit load brings 4 packed bytes, nibbles are unpacked in
// registers, activations are read from shared memory as broadcasts. W1/W2
// read only the packed rows that meet real inputs (K/2 of Kr at INT4) and
// W3 only the columns below n: the stream's padding is never read. A tile
// of 4, 8 or 16 rows is picked from the live row count; experts with no
// rows read no weights. Tensor cores are not used yet.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

constexpr int kThreads = 256;
constexpr int kCols = 4;                       // columns per thread

enum Phase { kGate = 0, kUp = 1, kDown = 2 };

// One phase over stream tiles [t_begin, t_end): src [ROWS][W] in shared
// memory times each tile's first `prow` packed rows, times the tile's
// column scales. kGate writes T(act(y)) into hs, kUp multiplies hs by y in
// place, kDown writes the output rows below n.
template <typename T, int BITS, int ACT, int ROWS, int PHASE>
__device__ void phase(const T* src, int W, const int8_t* __restrict__ we,
                      const float* __restrict__ sbe, int t_begin, int t_end,
                      int prow, int kr, int bw, T* hs, T* __restrict__ out,
                      int n, int live) {
  for (int t = t_begin; t < t_end; ++t) {
    const int8_t* tile = we + (size_t)t * kr * bw;
    const float* scale = sbe + (size_t)t * 2 * bw;
    for (int c0 = threadIdx.x * kCols; c0 < bw; c0 += kThreads * kCols) {
      const int col0 = (t - t_begin) * bw + c0;  // column within the phase
      if (PHASE == kDown && col0 >= n) break;   // padding: never read
      float acc[ROWS][kCols];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
      float_dot_cols<T, BITS, ROWS>(src, W, tile + c0, prow, kr, bw, acc);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float s = scale[c0 + j];
        const int col = col0 + j;
        if constexpr (PHASE == kGate) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            hs[r * W + col] = from_float<T>(activate<ACT>(__fmul_rn(acc[r][j], s)));
        } else if constexpr (PHASE == kUp) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            hs[r * W + col] = from_float<T>(
                __fmul_rn(to_float(hs[r * W + col]), __fmul_rn(acc[r][j], s)));
        } else if (col < n) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (r < live) out[(size_t)r * n + col] = from_float<T>(__fmul_rn(acc[r][j], s));
        }
      }
    }
  }
}

template <typename T, int BITS, int ACT, int ROWS>
__device__ void swiglu_rows(const T* xs, T* hs, int W, const int8_t* we,
                            const float* sbe, int K, int kr, int bw, int t1,
                            int t2, T* out, int n, int live) {
  // W1 and W2 read only the packed rows that meet real inputs: the rest of
  // each half is zero padding in both x and the weights.
  const int prow1 = BITS == 4 ? K / 2 : K;
  phase<T, BITS, ACT, ROWS, kGate>(xs, W, we, sbe, 0, t1, prow1, kr, bw, hs, out, n, live);
  phase<T, BITS, ACT, ROWS, kUp>(xs, W, we, sbe, t1, 2 * t1, prow1, kr, bw, hs, out, n, live);
  __syncthreads();
  phase<T, BITS, ACT, ROWS, kDown>(hs, W, we, sbe, 2 * t1, 2 * t1 + t2, kr, kr, bw, hs, out, n, live);
}

template <typename T, int BITS, int ACT>
__global__ void __launch_bounds__(kThreads)
fused_swiglu_kernel(const T* __restrict__ x, const int8_t* __restrict__ wstream,
                    const float* __restrict__ sb, const int* __restrict__ counts,
                    T* __restrict__ out, int C, int K, int kr, int bw, int t1,
                    int t2, int n, int tile_rows) {
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

  // stage x in the unpacked row order of the W1/W2 tiles; rows >= live are 0
  stage_x<BITS>(xs, x + ((size_t)e * C + r0) * K, K, kr, W, tile_rows, live,
                from_float<T>(0.f));
  __syncthreads();

  const int T_all = 2 * t1 + t2;
  const int8_t* we = wstream + (size_t)e * T_all * kr * bw;
  const float* sbe = sb + (size_t)e * T_all * 2 * bw;
  if (live <= 4)
    swiglu_rows<T, BITS, ACT, 4>(xs, hs, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
  else if (live <= 8)
    swiglu_rows<T, BITS, ACT, 8>(xs, hs, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
  else
    swiglu_rows<T, BITS, ACT, 16>(xs, hs, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
}

template <typename T, int BITS, int ACT>
cudaError_t launch(const void* x, const int8_t* wstream, const float* sb,
                   const int* counts, void* out, int E, int C, int K, int kr,
                   int bw, int t1, int t2, int n, int tile_rows,
                   cudaStream_t stream) {
  const size_t W = (BITS == 4 ? 2 : 1) * (size_t)kr;
  const size_t smem = 2 * (size_t)tile_rows * W * sizeof(T);
  auto kernel = fused_swiglu_kernel<T, BITS, ACT>;
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
  if (act == 1)
    return launch<T, BITS, 1>(x, wstream, sb, counts, out, E, C, K, kr, bw, t1,
                              t2, n, tile_rows, stream);
  return launch<T, BITS, 2>(x, wstream, sb, counts, out, E, C, K, kr, bw, t1,
                            t2, n, tile_rows, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = relu, 1 = gelu (tanh),
// 2 = silu. t1 = W1 tiles (== W2 tiles), t2 = W3 tiles. tile_rows in
// {4, 8, 16}, with 2 * tile_rows * (bits == 4 ? 2 : 1) * kr * sizeof(x)
// bytes of shared memory allowed per block; bw % 4 == 0. Returns a
// cudaError_t.
int fused_swiglu_quant_launch(const void* x, const int8_t* wstream,
                              const float* sb, const int* counts, void* out,
                              int E, int C, int K, int kr, int bw, int t1,
                              int t2, int n, int bits, int act, int dtype,
                              int tile_rows, int device, void* stream) {
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
