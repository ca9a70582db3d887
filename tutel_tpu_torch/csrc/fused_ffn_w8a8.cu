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
// Design: one block per (expert, row tile), the row tiles of one expert
// side by side in the grid, so they share its stream in L2. The per-row
// absmax runs over the whole hidden row, so a block holds all of it: the
// row tile's int8 x, its float32 hidden and the re-quantized int8 hidden
// live in shared memory (8 rows x 2048: 17 + 66 + 17 KB), and the stream
// is read in one pass from fc1 into fc2. The products run on the tensor
// cores: mma.sync m16n8k32 s8 with the weights as the M operand
// (gemm_tc.cuh). A tile of 4 or 8 rows is one n-block of the mma, a tile
// of 16 (where the experts are expected to hold more than 8 rows,
// fused_ffn.py `tile_rows_w8a8`) two. A phase deals column groups of
// 8 * VEC columns of its tiles (128 where bw allows 16-byte loads) to the
// warps: 16 at INT4 with one n-block (so at a decode step every column
// group of a packed row is read at once, and there are warps enough to
// hide the loads' latency on the one block an SM holds), else 8. A lane
// loads 16 bytes of each of its packed rows straight into registers, one
// load group ahead of the one it multiplies, and one 4 x 4 byte transpose
// (gemm_tc.cuh) per 4 packed rows of 4 columns makes the A registers,
// at INT4 with each nibble kept in the top half of its byte, so the int32
// sums are 16 x the true ones, exactly. B registers are 32-bit loads of
// the staged int8 rows, padded against bank conflicts. Between the phases
// each warp reduces the absmax of its rows with shuffles. fc1 reads only
// the packed rows that meet real inputs (K/2 of Kr at INT4) and fc2 only
// the columns below n; experts with no rows read no weights.

#include "ffn_common.cuh"
#include "gemm_tc.cuh"

namespace {

using namespace ffn;

// 8 warps a block; 16 at INT4 with one n-block (a decode step's tile of at
// most 8 rows), whose registers allow it: more warps to hide the latency
// of the weight loads on the one block an SM holds
template <int BITS, int NB> constexpr int kWarps = BITS == 4 && NB == 1 ? 16 : 8;
// bytes after each staged int8 row (x, hidden): B loads are free of bank
// conflicts (a row is 12 words mod 32 from the next) and a k-step past the
// phase's rows reads inside the row
constexpr int kXPad = 48;
constexpr int kHPad = 4;                       // floats after each hidden row

// k-steps per load group: two at INT4 with two n-blocks, else one
template <int BITS, int NB> constexpr int kGroupSteps = BITS == 4 && NB == 2 ? 2 : 1;

// One integer phase over stream tiles [t_begin, t_end): the int8 rows src
// [rows][W] (`xs` bytes apart) in shared memory times each tile's first
// `prow` packed rows, rescaled by the rows' scales. FC1 writes act(y) into
// the float32 hidden hs (`hsw` floats a row); otherwise y goes to the
// output rows below live and the columns below n. Each warp streams the
// column groups dealt to it, one load group ahead of the one it multiplies.
template <typename T, int BITS, int ACT, int VEC, int NB, bool FC1>
__device__ void mma_phase(const int8_t* src, int xs, const float* row_scale,
                          const int8_t* __restrict__ we,
                          const float* __restrict__ sbe, int t_begin,
                          int t_end, int prow, int kr, int bw, float* hs,
                          int hsw, T* __restrict__ out, int n, int t1,
                          int rows, int live) {
  constexpr int STRIP = 8 * VEC;
  constexpr int G = kGroupSteps<BITS, NB>;
  constexpr int WARPS = kWarps<BITS, NB>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int per_tile = (bw + STRIP - 1) / STRIP;
  const int nsteps = (prow + tc::k3_step_rows(BITS) - 1) / tc::k3_step_rows(BITS);
  const int8_t* xrow[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)             // rows past a 4-row tile: row 0
    xrow[nb] = src + (size_t)(8 * nb + g < rows ? 8 * nb + g : 0) * xs;

  for (int gi = warp; gi < (t_end - t_begin) * per_tile; gi += WARPS) {
    const int tt = t_begin + gi / per_tile;
    const int gc = (gi % per_tile) * STRIP;     // the group's first column
    if (!FC1 && (tt - t1) * bw + gc >= n) continue;   // padding: never read
    const int col = gc + VEC * g;
    const bool col_ok = col < bw;
    const int8_t* wl = we + (size_t)tt * kr * bw + col;
    const float* scale = sbe + (size_t)tt * 2 * bw;
    const float* bias = scale + bw;

    int acc[NB][VEC / 2][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nb][i][r] = 0;
    uint32_t fa[G][tc::k3_loads(BITS)][VEC / 4];
    uint32_t fb[G][tc::k3_loads(BITS)][VEC / 4];
    tc::s8_load_group<BITS, VEC, G>(fa, wl, 0, prow, bw, t, col_ok);
    for (int s = 0; s < nsteps; s += 2 * G) {
      tc::s8_load_group<BITS, VEC, G>(fb, wl, s + G, prow, bw, t, col_ok);
      tc::s8_mma_group<BITS, VEC, NB, G>(fa, xrow, s, nsteps, kr, t, acc);
      tc::s8_load_group<BITS, VEC, G>(fa, wl, s + 2 * G, prow, bw, t, col_ok);
      tc::s8_mma_group<BITS, VEC, NB, G>(fb, xrow, s + G, nsteps, kr, t, acc);
    }
    // d0, d1: column a_col(i, 0) at rows 2t, 2t + 1; d2, d3: a_col(i, 1)
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = gc + tc::a_col(VEC, g, i, h);
          const float sc = scale[c], b = bias[c];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int r = 8 * nb + 2 * t + q;
              if (r >= (FC1 ? rows : live)) continue;
              const float y = __fadd_rn(__fmul_rn(
                  __fmul_rn((float)int_sum<BITS>(acc[nb][i][2 * h + q]), row_scale[r]), sc), b);
              if constexpr (FC1) {
                hs[(size_t)r * hsw + tt * bw + c] = activate<ACT>(y);
              } else {
                const int ocol = (tt - t1) * bw + c;
                if (ocol < n) out[(size_t)r * n + ocol] = from_float<T>(y);
              }
            }
          }
        }
      }
    }
  }
}

// Per-row symmetric absmax of the float32 hidden [rows][W] -> hidden
// scales and the int8 hidden, as `quantize_activations` computes them.
__device__ void requantize(const float* hs, int hsw, int8_t* hq, int xs,
                           float* hscale, int W, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float m = 0.f;
    for (int i = lane; i < W; i += 32) m = fmaxf(m, fabsf(hs[(size_t)r * hsw + i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) hscale[r] = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
    const int r = idx / W, i = idx % W;
    const int q = __float2int_rn(__fdiv_rn(hs[(size_t)r * hsw + i], hscale[r]));
    hq[(size_t)r * xs + i] = (int8_t)min(max(q, -128), 127);
  }
  __syncthreads();
}

template <typename T, int BITS, int ACT, int VEC, int NB>
__device__ void ffn_rows(const int8_t* xsm, const float* xscale, float* hs,
                         int8_t* hq, float* hscale, int W, const int8_t* we,
                         const float* sbe, int K, int kr, int bw, int t1,
                         int t2, T* out, int n, int rows, int live) {
  const int xs = W + kXPad, hsw = W + kHPad;
  // fc1 reads only the packed rows that meet real inputs: the rest of each
  // half is zero padding in both x and the weights.
  const int prow1 = BITS == 4 ? K / 2 : K;
  mma_phase<T, BITS, ACT, VEC, NB, true>(xsm, xs, xscale, we, sbe, 0, t1, prow1,
                                         kr, bw, hs, hsw, out, n, t1, rows, live);
  __syncthreads();
  requantize(hs, hsw, hq, xs, hscale, W, rows);
  mma_phase<T, BITS, ACT, VEC, NB, false>(hq, xs, hscale, we, sbe, t1, t1 + t2,
                                          kr, kr, bw, hs, hsw, out, n, t1, rows,
                                          live);
}

// Shared memory of a block of `rows` rows: the float32 hidden, int8 x and
// hidden, two row scales (fused_ffn.py `w8a8_smem` mirrors it).
__host__ __device__ inline size_t w8a8_smem(int rows, int W) {
  return (size_t)rows * (2 * (W + kXPad) + 4 * (W + kHPad) + 8);
}

// Block (row tile, expert) of TILE rows: one n-block of the mma for 4 or 8
// rows, two for 16.
template <typename T, int BITS, int ACT, int VEC, int TILE>
__global__ void __launch_bounds__(32 * kWarps<BITS, TILE == 16 ? 2 : 1>)
fused_w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const int8_t* __restrict__ wstream,
                  const float* __restrict__ sb, const int* __restrict__ counts,
                  T* __restrict__ out, int C, int K, int kr, int bw, int t1,
                  int t2, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (BITS == 4 ? 2 : 1) * kr;      // unpacked rows == H
  float* hs = reinterpret_cast<float*>(smem);
  int8_t* xsm = reinterpret_cast<int8_t*>(hs + (size_t)TILE * (W + kHPad));
  int8_t* hq = xsm + (size_t)TILE * (W + kXPad);
  float* xscale = reinterpret_cast<float*>(hq + (size_t)TILE * (W + kXPad));
  float* hscale = xscale + TILE;
  const int e = blockIdx.y;
  const int r0 = blockIdx.x * TILE;
  const int count = min(max(counts[e], 0), C);
  const int rows_here = min(TILE, C - r0);
  const int live = max(0, min(rows_here, count - r0));
  T* oe = out + ((size_t)e * C + r0) * n;

  for (int idx = threadIdx.x; idx < (rows_here - live) * n; idx += blockDim.x)
    oe[(size_t)live * n + idx] = from_float<T>(0.f);
  if (live == 0) return;

  // stage xq in the unpacked row order of the fc1 tiles; rows >= live are 0
  stage_x<BITS>(xsm, xq + ((size_t)e * C + r0) * K, K, kr, W, W + kXPad,
                TILE, live, (int8_t)0);
  for (int r = threadIdx.x; r < TILE; r += blockDim.x)
    xscale[r] = r < live ? sx[(size_t)e * C + r0 + r] : 1.f;
  __syncthreads();

  const int T_all = t1 + t2;
  ffn_rows<T, BITS, ACT, VEC, TILE == 16 ? 2 : 1>(
      xsm, xscale, hs, hq, hscale, W, wstream + (size_t)e * T_all * kr * bw,
      sb + (size_t)e * T_all * 2 * bw, K, kr, bw, t1, t2, oe, n, TILE, live);
}

template <typename T, int BITS, int ACT, int VEC, int TILE>
cudaError_t launch_tile(const int8_t* xq, const float* sx,
                        const int8_t* wstream, const float* sb,
                        const int* counts, void* out, int E, int C, int K,
                        int kr, int bw, int t1, int t2, int n,
                        cudaStream_t stream) {
  const size_t smem = w8a8_smem(TILE, (BITS == 4 ? 2 : 1) * kr);
  auto kernel = fused_w8a8_kernel<T, BITS, ACT, VEC, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the row tiles of one expert side by side: they share its stream in L2
  dim3 grid((C + TILE - 1) / TILE, E);
  kernel<<<grid, 32 * kWarps<BITS, TILE == 16 ? 2 : 1>, smem, stream>>>(
      xq, sx, wstream, sb, counts, static_cast<T*>(out), C, K, kr, bw, t1, t2,
      n);
  return cudaGetLastError();
}

template <typename T, int BITS, int ACT, int VEC>
cudaError_t launch(const int8_t* xq, const float* sx, const int8_t* wstream,
                   const float* sb, const int* counts, void* out, int E, int C,
                   int K, int kr, int bw, int t1, int t2, int n, int tile_rows,
                   cudaStream_t stream) {
  if (tile_rows == 16)
    return launch_tile<T, BITS, ACT, VEC, 16>(xq, sx, wstream, sb, counts, out,
                                              E, C, K, kr, bw, t1, t2, n, stream);
  if (tile_rows == 8)
    return launch_tile<T, BITS, ACT, VEC, 8>(xq, sx, wstream, sb, counts, out,
                                             E, C, K, kr, bw, t1, t2, n, stream);
  return launch_tile<T, BITS, ACT, VEC, 4>(xq, sx, wstream, sb, counts, out, E,
                                           C, K, kr, bw, t1, t2, n, stream);
}

template <typename T, int BITS, int ACT>
cudaError_t launch_vec(const int8_t* xq, const float* sx, const int8_t* wstream,
                       const float* sb, const int* counts, void* out, int E,
                       int C, int K, int kr, int bw, int t1, int t2, int n,
                       int tile_rows, cudaStream_t stream) {
  // 16-byte weight loads where every packed row starts 16-byte aligned
  if (bw % 16 == 0 && (reinterpret_cast<uintptr_t>(wstream) & 15) == 0)
    return launch<T, BITS, ACT, 16>(xq, sx, wstream, sb, counts, out, E, C, K,
                                    kr, bw, t1, t2, n, tile_rows, stream);
  return launch<T, BITS, ACT, 4>(xq, sx, wstream, sb, counts, out, E, C, K, kr,
                                 bw, t1, t2, n, tile_rows, stream);
}

template <typename T, int BITS>
cudaError_t launch_act(int act, const int8_t* xq, const float* sx,
                       const int8_t* wstream, const float* sb,
                       const int* counts, void* out, int E, int C, int K,
                       int kr, int bw, int t1, int t2, int n, int tile_rows,
                       cudaStream_t stream) {
  if (act == 0)
    return launch_vec<T, BITS, 0>(xq, sx, wstream, sb, counts, out, E, C, K,
                                  kr, bw, t1, t2, n, tile_rows, stream);
  if (act == 1)
    return launch_vec<T, BITS, 1>(xq, sx, wstream, sb, counts, out, E, C, K,
                                  kr, bw, t1, t2, n, tile_rows, stream);
  return launch_vec<T, BITS, 2>(xq, sx, wstream, sb, counts, out, E, C, K, kr,
                                bw, t1, t2, n, tile_rows, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the output's type); act: 0 = relu,
// 1 = gelu (tanh), 2 = silu. tile_rows 4, 8 or 16, with
// w8a8_smem(tile_rows, W) bytes of shared memory allowed per block, W =
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
  if (tile_rows != 4 && tile_rows != 8 && tile_rows != 16)
    return (int)cudaErrorInvalidValue;
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
