// Fused quantized SwiGLU expert, (act(x @ W1) * (x @ W2)) @ W3 in one
// call (K4).
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
// and not read). Dots accumulate in float32.
//
// What bounds it on an H100: at decode, every live expert's weights are
// read once, (2*K*H + H*N)/2 bytes at INT4: 3 MB per expert, 96 MB for the
// LM's 32 experts at 1024 x 2048 x 1024, so it is bound by bytes; a
// prefill chunk of 16,384 routed rows does 2.1e11 operations and is bound
// by them.
//
// Design: the hidden split of ffn_common.cuh, as K2 (fused_ffn_quant.cu).
// Block (expert, slice, row tile) computes the gate of its hidden slice,
// T(act(x @ W1[:, slice] * s1)), into shared memory, multiplies it in
// place by x @ W2[:, slice] * s2 (rounding again), then computes the
// slice's partial of W3 over the N live columns. With S = 1 it writes the
// output rows, T(sum * s3); with S > 1 float32 partials of its live rows
// go to ws [S, E, C, N] and a second kernel sums them in slice order,
// scales once, rounds and writes the zeros past counts[e]. S and the row
// tiles are chosen as for K2. W1/W2 read only the packed rows that meet
// real inputs (K/2 of Kr at INT4) and W3 only the columns below n: the
// stream's padding is never read. Experts with no rows read no weights.
// Tensor cores are not used yet.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

// One block's slice of one row tile: gate and up into the hidden slice,
// then the slice's W3 partial (see ffn_slice in fused_ffn_quant.cu).
template <typename T, int BITS, int ROWS, int VEC>
__device__ void swiglu_slice(const T* __restrict__ xe,
                             const int8_t* __restrict__ we,
                             const float* __restrict__ sbe, T* __restrict__ oe,
                             float* __restrict__ wse, int K, int kr, int bw,
                             int t1, int n, int split, int s, int live, int act,
                             unsigned char* smem) {
  const SplitLayout L = split_layout<BITS>(K, kr, split, s);
  float* red = reinterpret_cast<float*>(smem);
  float* stage = reinterpret_cast<float*>(smem + kRedBytes);
  T* xs = reinterpret_cast<T*>(stage + 2 * split_stage(BITS, kr, n, split));
  T* hs = xs + ROWS * L.ldx;
  stage_rows<BITS>(xs, xe, K, L, ROWS, live);
  __syncthreads();

  const Cols hidden = hidden_cols<BITS>(L);
  split_pass<T, BITS, ROWS, VEC, false>(
      xs, L.ldx, L.kq, we, sbe, 0, kr, bw, 0, L.kq, hidden, red, stage,
      [&](int r, int j, float v, float sc, float) {
        hs[r * L.ldh + hidden_pos<BITS>(L, j)] =
            from_float<T>(activate(act, __fmul_rn(v, sc)));
      });
  __syncthreads();
  split_pass<T, BITS, ROWS, VEC, false>(
      xs, L.ldx, L.kq, we, sbe, t1, kr, bw, 0, L.kq, hidden, red, stage,
      [&](int r, int j, float v, float sc, float) {
        T& h = hs[r * L.ldh + hidden_pos<BITS>(L, j)];
        h = from_float<T>(__fmul_rn(to_float(h), __fmul_rn(v, sc)));
      });
  __syncthreads();
  split_pass<T, BITS, ROWS, VEC, false>(
      hs, L.ldh, L.len, we, sbe, 2 * t1, kr, bw, L.p0, L.len,
      Cols{0, n, n, n}, red, stage,
      [&](int r, int col, float v, float sc, float) {
        if (r >= live || col >= n) return;
        if (split == 1)
          oe[(size_t)r * n + col] = from_float<T>(__fmul_rn(v, sc));
        else
          wse[(size_t)r * n + col] = v;
      });
}

template <typename T, int BITS, bool DECODE>
__global__ void __launch_bounds__(kSplitThreads, DECODE ? 2 : 1)
fused_swiglu_kernel(const T* __restrict__ x, const int8_t* __restrict__ wstream,
                    const float* __restrict__ sb, const int* __restrict__ counts,
                    T* __restrict__ out, float* __restrict__ ws, int C, int K,
                    int kr, int bw, int t1, int t2, int n, int tile_rows,
                    int split, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.y, e = blockIdx.z, E = gridDim.z;
  const int r0 = blockIdx.x * tile_rows;
  const int count = min(max(counts[e], 0), C);
  const int rows_here = min(tile_rows, C - r0);
  const int live = max(0, min(rows_here, count - r0));
  T* oe = out + ((size_t)e * C + r0) * n;

  if (split == 1) {            // with S > 1 the combine writes the zeros
    for (int idx = threadIdx.x; idx < (rows_here - live) * n; idx += kSplitThreads)
      oe[(size_t)live * n + idx] = from_float<T>(0.f);
  }
  if (live == 0) return;

  const int T_all = 2 * t1 + t2;
  const T* xe = x + ((size_t)e * C + r0) * K;
  const int8_t* we = wstream + (size_t)e * T_all * kr * bw;
  const float* sbe = sb + (size_t)e * T_all * 2 * bw;
  float* wse = split == 1 ? nullptr : ws + (((size_t)s * E + e) * C + r0) * n;
  dispatch_rows<DECODE>(live, bw, [&](auto rows, auto v) {
    swiglu_slice<T, BITS, decltype(rows)::value, decltype(v)::value>(
        xe, we, sbe, oe, wse, K, kr, bw, t1, n, split, s, live, act, smem);
  });
}

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
fused_swiglu_combine(const float* __restrict__ ws, const float* __restrict__ sb,
                     const int* __restrict__ counts, T* __restrict__ out,
                     int split, int E, int C, int n, int t_down, int t_all,
                     int bw) {
  combine_body<T, false>(ws, sb, counts, out, split, E, C, n, t_down, t_all, bw);
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const int8_t* wstream, const float* sb,
                   const int* counts, void* out, float* ws, int E, int C,
                   int K, int kr, int bw, int t1, int t2, int n, int tile_rows,
                   int split, int act, cudaStream_t stream) {
  const size_t smem = split_smem(BITS, K, kr, n, split, tile_rows, sizeof(T));
  auto kernel = tile_rows == 4 ? fused_swiglu_kernel<T, BITS, true>
                               : fused_swiglu_kernel<T, BITS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((C + tile_rows - 1) / tile_rows, split, E);
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(x), wstream, sb, counts, static_cast<T*>(out), ws,
      C, K, kr, bw, t1, t2, n, tile_rows, split, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  fused_swiglu_combine<T><<<combine_blocks((size_t)E * C * n), kSplitThreads, 0, stream>>>(
      ws, sb, counts, static_cast<T*>(out), split, E, C, n, 2 * t1, 2 * t1 + t2, bw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = relu, 1 = gelu (tanh),
// 2 = silu. t1 = W1 tiles (== W2 tiles), t2 = W3 tiles. tile_rows, split,
// ws and bw as for fused_ffn_quant_launch. Returns a cudaError_t.
int fused_swiglu_quant_launch(const void* x, const int8_t* wstream,
                              const float* sb, const int* counts, void* out,
                              float* ws, int E, int C, int K, int kr, int bw,
                              int t1, int t2, int n, int bits, int act,
                              int dtype, int tile_rows, int split, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = bits == 4
              ? launch<__nv_bfloat16, 4>(x, wstream, sb, counts, out, ws, E, C, K, kr, bw, t1, t2, n, tile_rows, split, act, s)
              : launch<__nv_bfloat16, 8>(x, wstream, sb, counts, out, ws, E, C, K, kr, bw, t1, t2, n, tile_rows, split, act, s);
  } else {
    err = bits == 4
              ? launch<float, 4>(x, wstream, sb, counts, out, ws, E, C, K, kr, bw, t1, t2, n, tile_rows, split, act, s)
              : launch<float, 8>(x, wstream, sb, counts, out, ws, E, C, K, kr, bw, t1, t2, n, tile_rows, split, act, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
