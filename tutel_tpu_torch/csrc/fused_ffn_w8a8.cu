// Fused W8A8 / W4A8 expert FFN, both contractions int8 x int8 -> int32 (K3).
//
// Replaces the Pallas kernel `fused_ffn_w8a8` (tutel_tpu/ops/
// fused_ffn_pallas.py:354, body `_fused_w8a8_kernel` :286). Per expert e
// and live row r < counts[e], with xq, sx the wrapper's per-row int8
// quantization of x:
//   h      = act((float)(xr @ W1) * sx[r] * s1 + b1)       float32
//   sxh    = max|h| / 127 (1 if h == 0); hq = clip(rint(h / sxh), -128, 127)
//   out[r] = ((float)(hq @ W2) * sxh * s2 + b2)[:n]
// Rows r >= counts[e] are written as zeros. The weights come in K2's
// phase-packed stream (wstream int8 [E, T1+T2, Kr, bw], INT4 split-half or
// INT8; sb f32 [E, T1+T2, 2, bw] the scale and bias rows); xr is xq in the
// unpacked row order of the fc1 tiles (each INT4 half zero-padded from K/2
// to Kr). The integer sums are exact; the rescales run in the Pallas
// kernel's order, with no fused multiply-add, so the hidden and its
// re-quantization match the plain twin bit for bit up to the activation.
//
// What bounds it on an H100: every live expert's whole stream is read once
// per call, (K*H + H*N)/2 bytes at INT4: 537 MB for 128 experts at
// 2048 x 2048 x 2048. The kernel is bound by those bytes over HBM
// bandwidth; activations and outputs are a few percent of that.
//
// Design (simple first, as K2 in fused_ffn_quant.cu): one block per
// (expert, row tile), 256 threads. The per-row absmax runs over the whole
// hidden row, so a block holds all of it: the row tile's int8 x, its
// float32 hidden and the re-quantized int8 hidden live in shared memory
// (16 rows x 2048: 32 + 128 + 32 KB), and the stream is read in one pass
// from fc1 into fc2. Each thread owns 4 adjacent columns of a tile: four
// 32-bit loads bring 4 packed rows of them, transposed in registers for
// __dp4a (ffn_common.cuh); activation words are read from shared memory as
// broadcasts. Between the phases each warp reduces the absmax of its rows
// with shuffles. fc1 reads only the packed rows that meet real inputs
// (K/2 of Kr at INT4) and fc2 only the columns below n. A tile of 4, 8 or
// 16 rows is picked from the live row count; experts with no rows read no
// weights. Tensor cores are not used yet.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                       // columns per thread

// One integer phase over stream tiles [t_begin, t_end): the int8 rows
// src [ROWS][W] in shared memory times each tile's first `prow` packed
// rows, rescaled by the rows' scales. FC1 writes act(y) into the float32
// hidden hs; otherwise y goes to the output rows below n.
template <typename T, int BITS, int ACT, int ROWS, bool FC1>
__device__ void int_phase(const int8_t* src, const float* row_scale, int W,
                          const int8_t* __restrict__ we,
                          const float* __restrict__ sbe, int t_begin,
                          int t_end, int prow, int kr, int bw, float* hs,
                          T* __restrict__ out, int n, int t1, int live) {
  for (int t = t_begin; t < t_end; ++t) {
    const int8_t* tile = we + (size_t)t * kr * bw;
    const float* scale = sbe + (size_t)t * 2 * bw;
    const float* bias = scale + bw;
    for (int c0 = threadIdx.x * kCols; c0 < bw; c0 += kThreads * kCols) {
      const int col0 = (t - t1) * bw + c0;     // fc2 output column
      if (!FC1 && col0 >= n) break;            // padding: never read
      int acc[ROWS][kCols];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = 0;
      const int8_t* wp = tile + c0;
#pragma unroll 2
      for (int p = 0; p < prow; p += 4) {
        unsigned wr[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wr[b] = *reinterpret_cast<const unsigned*>(wp + (size_t)(p + b) * bw);
        int xl[ROWS], xh[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          xl[r] = *reinterpret_cast<const int*>(src + r * W + p);
          if constexpr (BITS == 4) xh[r] = *reinterpret_cast<const int*>(src + r * W + kr + p);
          else xh[r] = 0;
        }
        dp4a_cols<BITS, ROWS>(wr, xl, xh, acc);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float s = scale[c0 + j], b = bias[c0 + j];
        if constexpr (FC1) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float y = __fadd_rn(
                __fmul_rn(__fmul_rn((float)int_sum<BITS>(acc[r][j]), row_scale[r]), s), b);
            hs[r * W + t * bw + c0 + j] = activate<ACT>(y);
          }
        } else if (col0 + j < n) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < live) {
              const float y = __fadd_rn(
                  __fmul_rn(__fmul_rn((float)int_sum<BITS>(acc[r][j]), row_scale[r]), s), b);
              out[(size_t)r * n + col0 + j] = from_float<T>(y);
            }
          }
        }
      }
    }
  }
}

// Per-row symmetric absmax of the float32 hidden [ROWS][W] -> hidden
// scales and the int8 hidden, as `quantize_activations` computes them.
template <int ROWS>
__device__ void requantize(const float* hs, int8_t* hq, float* hscale, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += kWarps) {
    float m = 0.f;
    for (int i = lane; i < W; i += 32) m = fmaxf(m, fabsf(hs[r * W + i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) hscale[r] = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * W; idx += kThreads) {
    const int q = __float2int_rn(__fdiv_rn(hs[idx], hscale[idx / W]));
    hq[idx] = (int8_t)min(max(q, -128), 127);
  }
  __syncthreads();
}

template <typename T, int BITS, int ACT, int ROWS>
__device__ void ffn_rows(const int8_t* xs, const float* xscale, float* hs,
                         int8_t* hq, float* hscale, int W, const int8_t* we,
                         const float* sbe, int K, int kr, int bw, int t1,
                         int t2, T* out, int n, int live) {
  // fc1 reads only the packed rows that meet real inputs: the rest of each
  // half is zero padding in both x and the weights.
  const int prow1 = BITS == 4 ? K / 2 : K;
  int_phase<T, BITS, ACT, ROWS, true>(xs, xscale, W, we, sbe, 0, t1, prow1, kr,
                                      bw, hs, out, n, t1, live);
  __syncthreads();
  requantize<ROWS>(hs, hq, hscale, W);
  int_phase<T, BITS, ACT, ROWS, false>(hq, hscale, W, we, sbe, t1, t1 + t2, kr,
                                       kr, bw, hs, out, n, t1, live);
}

template <typename T, int BITS, int ACT>
__global__ void __launch_bounds__(kThreads)
fused_w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const int8_t* __restrict__ wstream,
                  const float* __restrict__ sb, const int* __restrict__ counts,
                  T* __restrict__ out, int C, int K, int kr, int bw, int t1,
                  int t2, int n, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (BITS == 4 ? 2 : 1) * kr;      // unpacked rows == H
  float* hs = reinterpret_cast<float*>(smem);
  int8_t* xs = reinterpret_cast<int8_t*>(hs + (size_t)tile_rows * W);
  int8_t* hq = xs + (size_t)tile_rows * W;
  float* xscale = reinterpret_cast<float*>(hq + (size_t)tile_rows * W);
  float* hscale = xscale + tile_rows;
  const int e = blockIdx.x;
  const int r0 = blockIdx.y * tile_rows;
  const int count = min(max(counts[e], 0), C);
  const int rows_here = min(tile_rows, C - r0);
  const int live = max(0, min(rows_here, count - r0));
  T* oe = out + ((size_t)e * C + r0) * n;

  for (int idx = threadIdx.x; idx < (rows_here - live) * n; idx += kThreads)
    oe[(size_t)live * n + idx] = from_float<T>(0.f);
  if (live == 0) return;

  // stage xq in the unpacked row order of the fc1 tiles; rows >= live are 0
  stage_x<BITS>(xs, xq + ((size_t)e * C + r0) * K, K, kr, W, tile_rows, live,
                (int8_t)0);
  for (int r = threadIdx.x; r < tile_rows; r += kThreads)
    xscale[r] = r < live ? sx[(size_t)e * C + r0 + r] : 1.f;
  __syncthreads();

  const int T_all = t1 + t2;
  const int8_t* we = wstream + (size_t)e * T_all * kr * bw;
  const float* sbe = sb + (size_t)e * T_all * 2 * bw;
  if (live <= 4)
    ffn_rows<T, BITS, ACT, 4>(xs, xscale, hs, hq, hscale, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
  else if (live <= 8)
    ffn_rows<T, BITS, ACT, 8>(xs, xscale, hs, hq, hscale, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
  else
    ffn_rows<T, BITS, ACT, 16>(xs, xscale, hs, hq, hscale, W, we, sbe, K, kr, bw, t1, t2, oe, n, live);
}

template <typename T, int BITS, int ACT>
cudaError_t launch(const int8_t* xq, const float* sx, const int8_t* wstream,
                   const float* sb, const int* counts, void* out, int E, int C,
                   int K, int kr, int bw, int t1, int t2, int n, int tile_rows,
                   cudaStream_t stream) {
  const size_t W = (BITS == 4 ? 2 : 1) * (size_t)kr;
  const size_t smem = (size_t)tile_rows * (6 * W + 8);
  auto kernel = fused_w8a8_kernel<T, BITS, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(E, (C + tile_rows - 1) / tile_rows);
  kernel<<<grid, kThreads, smem, stream>>>(xq, sx, wstream, sb, counts,
                                           static_cast<T*>(out), C, K, kr, bw,
                                           t1, t2, n, tile_rows);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_act(int act, const int8_t* xq, const float* sx,
                       const int8_t* wstream, const float* sb,
                       const int* counts, void* out, int E, int C, int K,
                       int kr, int bw, int t1, int t2, int n, int tile_rows,
                       cudaStream_t stream) {
  if (act == 0)
    return launch<T, BITS, 0>(xq, sx, wstream, sb, counts, out, E, C, K, kr,
                              bw, t1, t2, n, tile_rows, stream);
  if (act == 1)
    return launch<T, BITS, 1>(xq, sx, wstream, sb, counts, out, E, C, K, kr,
                              bw, t1, t2, n, tile_rows, stream);
  return launch<T, BITS, 2>(xq, sx, wstream, sb, counts, out, E, C, K, kr, bw,
                            t1, t2, n, tile_rows, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the output's type); act: 0 = relu,
// 1 = gelu (tanh), 2 = silu. tile_rows in {4, 8, 16}, with
// tile_rows * (6 * W + 8) bytes of shared memory allowed per block, W =
// (bits == 4 ? 2 : 1) * kr; bw % 4 == 0, kr % 4 == 0, K % 4 == 0 (K % 8
// for INT4). Returns a cudaError_t.
int fused_ffn_w8a8_launch(const int8_t* xq, const float* sx,
                          const int8_t* wstream, const float* sb,
                          const int* counts, void* out, int E, int C, int K,
                          int kr, int bw, int t1, int t2, int n, int bits,
                          int act, int dtype, int tile_rows, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = bits == 4
              ? launch_act<__nv_bfloat16, 4>(act, xq, sx, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s)
              : launch_act<__nv_bfloat16, 8>(act, xq, sx, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s);
  } else {
    err = bits == 4
              ? launch_act<float, 4>(act, xq, sx, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s)
              : launch_act<float, 8>(act, xq, sx, wstream, sb, counts, out, E, C, K, kr, bw, t1, t2, n, tile_rows, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
