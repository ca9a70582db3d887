// Fused quantized expert FFN, fc1 + activation + fc2 in one call (K2).
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
// scale row and the bias row of every tile. Dots accumulate in float32;
// scale, then bias, then the activation (0 = relu, 1 = tanh-approximated
// gelu) in float32.
//
// What bounds it on an H100: every live expert's weights are read once per
// call, (K*H + H*N)/2 bytes at INT4: 2 MB an expert, 64 MB for the LM's 32
// experts at 1024 x 2048 x 1024. At decode (a few rows an expert) it is
// bound by those bytes over HBM bandwidth; a prefill chunk of 16,384
// routed rows is bound by its operations.
//
// Design: the hidden split of ffn_common.cuh. The grid is (expert, slice,
// row tile): block (e, s) computes its slice of the hidden,
// act(x @ W1[:, slice] * s1 + b1) rounded to T, into shared memory, then
// that slice's partial of fc2 over the N live columns (the fc2 padding
// columns past n are never read, nor are fc1's packed rows past K/2 or
// K). With one slice (S = 1) the block writes the output rows itself;
// with S > 1 it writes float32 partials of its live rows to the workspace
// ws [S, E, C, N], and a second kernel on the same stream sums them in
// slice order, scales and biases once, rounds to T and writes the zeros
// past counts[e]. A decode call (`fused_ffn.split_plan`) takes tiles of
// 4 rows, run by a kernel instance of its own at two blocks per SM, and
// the most slices whose live tiles (as the routed rows lead it to expect
// them) fit in one wave of two blocks per SM, at least two where one slice
// would leave SMs idle; a prefill chunk fills the card with 16-row tiles
// and keeps S = 1.
// Experts with no live rows read no weights. Tensor cores are not used
// yet.

#include "ffn_common.cuh"

namespace {

using namespace ffn;

// One block's slice of one row tile: fc1 into the hidden slice, then the
// slice's fc2 partial. S == 1 writes out rows (oe, n apart), else the
// partial rows (wse, n apart).
template <typename T, int BITS, int ROWS, int VEC>
__device__ void ffn_slice(const T* __restrict__ xe, const int8_t* __restrict__ we,
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

  split_pass<T, BITS, ROWS, VEC, true>(
      xs, L.ldx, L.kq, we, sbe, 0, kr, bw, 0, L.kq, hidden_cols<BITS>(L), red,
      stage, [&](int r, int j, float v, float sc, float b) {
        hs[r * L.ldh + hidden_pos<BITS>(L, j)] =
            from_float<T>(activate(act, fmaf(v, sc, b)));
      });
  __syncthreads();
  split_pass<T, BITS, ROWS, VEC, true>(
      hs, L.ldh, L.len, we, sbe, t1, kr, bw, L.p0, L.len, Cols{0, n, n, n},
      red, stage, [&](int r, int col, float v, float sc, float b) {
        if (r >= live || col >= n) return;
        if (split == 1)
          oe[(size_t)r * n + col] = from_float<T>(fmaf(v, sc, b));
        else
          wse[(size_t)r * n + col] = v;
      });
}

template <typename T, int BITS, bool DECODE>
__global__ void __launch_bounds__(kSplitThreads, DECODE ? 2 : 1)
fused_ffn_kernel(const T* __restrict__ x, const int8_t* __restrict__ wstream,
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

  const int T_all = t1 + t2;
  const T* xe = x + ((size_t)e * C + r0) * K;
  const int8_t* we = wstream + (size_t)e * T_all * kr * bw;
  const float* sbe = sb + (size_t)e * T_all * 2 * bw;
  float* wse = split == 1 ? nullptr : ws + (((size_t)s * E + e) * C + r0) * n;
  dispatch_rows<DECODE>(live, bw, [&](auto rows, auto v) {
    ffn_slice<T, BITS, decltype(rows)::value, decltype(v)::value>(
        xe, we, sbe, oe, wse, K, kr, bw, t1, n, split, s, live, act, smem);
  });
}

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
fused_ffn_combine(const float* __restrict__ ws, const float* __restrict__ sb,
                  const int* __restrict__ counts, T* __restrict__ out,
                  int split, int E, int C, int n, int t_down, int t_all,
                  int bw) {
  combine_body<T, true>(ws, sb, counts, out, split, E, C, n, t_down, t_all, bw);
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const int8_t* wstream, const float* sb,
                   const int* counts, void* out, float* ws, int E, int C,
                   int K, int kr, int bw, int t1, int t2, int n, int tile_rows,
                   int split, int act, cudaStream_t stream) {
  const size_t smem = split_smem(BITS, K, kr, n, split, tile_rows, sizeof(T));
  auto kernel = tile_rows == 4 ? fused_ffn_kernel<T, BITS, true>
                               : fused_ffn_kernel<T, BITS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((C + tile_rows - 1) / tile_rows, split, E);
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(x), wstream, sb, counts, static_cast<T*>(out), ws,
      C, K, kr, bw, t1, t2, n, tile_rows, split, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  fused_ffn_combine<T><<<combine_blocks((size_t)E * C * n), kSplitThreads, 0, stream>>>(
      ws, sb, counts, static_cast<T*>(out), split, E, C, n, t1, t1 + t2, bw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = relu, 1 = gelu (tanh).
// tile_rows in {4, 8, 16}; split >= 1 slices of the hidden (split > 1
// needs kr % 32 == 0, split <= kr / 32, and ws: a float32 workspace of
// [split, E, C, n]); bw % 4 == 0 (4-row tiles load 16 bytes of a packed
// row where bw % 16 == 0). split_smem(bits, K, kr, n, split, tile_rows,
// sizeof(x)) bytes of shared memory must be allowed per block.
// Returns a cudaError_t.
int fused_ffn_quant_launch(const void* x, const int8_t* wstream, const float* sb,
                           const int* counts, void* out, float* ws, int E,
                           int C, int K, int kr, int bw, int t1, int t2, int n,
                           int bits, int act, int dtype, int tile_rows,
                           int split, int device, void* stream) {
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
