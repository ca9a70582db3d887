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
// activations. It is bound by those bytes over HBM bandwidth, and reaching
// that rate leaves about 9 lane-instructions per weight byte.
//
// Two bodies, chosen by x's type:
//
// * bfloat16 x (the serving type): the tensor cores. `gmm_quant_kernel_tc`
//   takes one expert and a strip of 8 * VEC columns (128 where N allows
//   16-byte loads) per block of 4 warps; the warps split the expert's
//   packed rows in four and run mma.sync m16n8k16 with the weights as the
//   M operand (gemm_tc.cuh: one packed INT4 byte widens into one bf16x2 A
//   register with a byte permute, a lop3 and one bf16x2 subtraction; INT8
//   bytes go through a float). Each lane loads its weights with 16-byte
//   loads straight into registers, two k-steps per group, one group ahead
//   of the one it multiplies. Each warp stages the tile's x rows for its
//   k-steps in shared memory as the bf16 pairs the k order needs (one
//   32-bit load per B register), up to 32 k-steps at a time, so
//   shared memory does not grow with K. A tile holds 8 or 16 rows (one or two n-blocks of the mma):
//   the launch's tile (the wrapper's `tc_plan`) sets the registers and
//   shared memory, and a tile with at most 8 live rows runs one n-block.
//   Where an expert is expected to fill several tiles, up to 4 blocks side
//   by side take every groups-th (the plan's groups) and share the strip's
//   weights in L2. The four warps' float32 sums meet in shared memory and
//   are added in warp order, so the result does not depend on timing.
// * float32 x (the small engines held to the CPU at 1e-4, which a bf16
//   product cannot meet): the CUDA-core body `gmm_quant_kernel`: one block
//   per (expert, 512-column strip), 128 threads of 4 adjacent columns, x
//   staged as float a chunk of packed rows at a time, float FMAs.
//
// Both walk an expert's live rows tile by tile, so experts with no rows
// read no weights, and write zeros to the rows at or past counts[e].

#include "gemm_tc.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                       // columns per thread
constexpr int kStrip = kThreads * kCols;       // columns per block
constexpr int kMaxRows = 16;                   // largest row tile
constexpr int kChunk = 64;                     // packed rows per staging pass

// ---------------------------------------------------------------------------
// The CUDA-core body (float32 x).

// One row tile: rows [r0, r0 + live) of expert e, ROWS >= live.
template <int BITS, int ROWS>
__device__ void gemm_tile(const float* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scales, float* __restrict__ out,
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
        const float* xr = x + (size_t)(r0 + r) * K + kbase + p0 + i;
        xs_lo[r][i] = ok ? xr[0] : 0.f;
        if constexpr (BITS == 4) xs_hi[r][i] = ok ? xr[kb] : 0.f;
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
    float* o = out + (size_t)(r0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[j] = acc[r][j] * scales[n0 + j];
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
gmm_quant_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scales, const int* __restrict__ counts,
                 float* __restrict__ out, int C, int K, int N, int blocks) {
  __shared__ float xs_lo[kMaxRows][kChunk];
  __shared__ float xs_hi[BITS == 4 ? kMaxRows : 1][kChunk];
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  const int kp = BITS == 4 ? K / 2 : K;
  const int count = min(max(counts[e], 0), C);
  const float* xe = x + (size_t)e * C * K;
  const int8_t* we = w + (size_t)e * kp * N;
  const float* se = scales + (size_t)e * N;
  float* oe = out + (size_t)e * C * N;

  for (int r0 = 0; r0 < count; r0 += kMaxRows) {
    const int live = min(kMaxRows, count - r0);
    if (live <= 4)
      gemm_tile<BITS, 4>(xe, we, se, oe, r0, live, K, N, blocks, n0, xs_lo, xs_hi);
    else if (live <= 8)
      gemm_tile<BITS, 8>(xe, we, se, oe, r0, live, K, N, blocks, n0, xs_lo, xs_hi);
    else
      gemm_tile<BITS, 16>(xe, we, se, oe, r0, live, K, N, blocks, n0, xs_lo, xs_hi);
  }
  if (n0 < N) {
    for (int r = count; r < C; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) oe[(size_t)r * N + n0 + j] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (bfloat16 x).

constexpr int kTcWarps = 4;                    // split an expert's k-steps
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kDepth = 2;                      // k-steps per load group
constexpr int kPairPad = 4;                    // words after each staged row
static_assert(kTcWarps == tc::kSplitWarps && 4 % (2 * kDepth) == 0,
              "tc::chunk_steps deals k-steps to 4 warps in loop turns of 4");

using bf16 = __nv_bfloat16;

// Stage rows [0, rows) of the tile (rows >= live are zeros) as the bf16
// pairs [q0, q0 + npad) of gemm_tc.cuh (pairs past the packed rows are
// zeros), `stride` words a row; the 32 lanes of one warp. 16-byte loads
// where the halves allow.
template <int BITS>
__device__ void stage_pairs(uint32_t* xs, const bf16* __restrict__ x, int rows,
                            int live, int K, int kp, int kb, int q0, int npad,
                            int stride) {
  const int lane = threadIdx.x % 32;
  const int pairs = BITS == 4 ? kp : (K + 1) / 2;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (BITS == 4 ? K % 8 == 0 && kb % 8 == 0 : K % 16 == 0);
  if (vec) {
    const int groups = npad / 8;
    for (int idx = lane; idx < rows * groups; idx += 32) {
      const int r = idx / groups, j = 8 * (idx % groups), q = q0 + j;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (r < live && q < pairs) {
        const bf16* xr = x + (size_t)r * K;
        if constexpr (BITS == 4) {
          int lo, hi;
          tc::pair_k(BITS, q, kb, lo, hi);
          const uint4 l = *reinterpret_cast<const uint4*>(xr + lo);
          const uint4 h = *reinterpret_cast<const uint4*>(xr + hi);
          a = make_uint4(__byte_perm(l.x, h.x, 0x5410), __byte_perm(l.x, h.x, 0x7632),
                         __byte_perm(l.y, h.y, 0x5410), __byte_perm(l.y, h.y, 0x7632));
          b = make_uint4(__byte_perm(l.z, h.z, 0x5410), __byte_perm(l.z, h.z, 0x7632),
                         __byte_perm(l.w, h.w, 0x5410), __byte_perm(l.w, h.w, 0x7632));
        } else {
          a = *reinterpret_cast<const uint4*>(xr + 2 * q);
          b = *reinterpret_cast<const uint4*>(xr + 2 * q + 8);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)r * stride + j);
      dst[0] = a;
      dst[1] = b;
    }
  } else {
    for (int idx = lane; idx < rows * npad; idx += 32) {
      const int r = idx / npad, j = idx % npad, q = q0 + j;
      uint32_t v = 0u;
      if (r < live && q < pairs) {
        int lo, hi;
        tc::pair_k(BITS, q, kb, lo, hi);
        const unsigned short* xr =
            reinterpret_cast<const unsigned short*>(x + (size_t)r * K);
        v = (uint32_t)xr[lo] | (hi < K ? (uint32_t)xr[hi] << 16 : 0u);
      }
      xs[(size_t)r * stride + j] = v;
    }
  }
}

// One group of kDepth k-steps from step s on: the lane's loads. No load is
// predicated: a row past the packed rows reads the last one (it meets x
// pairs that are zero), a step past the warp's last is never multiplied,
// and a lane past N reads column 0 (its sums are never written).
template <int BITS, int VEC>
__device__ __forceinline__ void load_group(uint32_t (*f)[tc::k1_loads(BITS)][VEC / 4],
                                           const int8_t* wl, int s, int kp,
                                           int N, int t) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
#pragma unroll
    for (int l = 0; l < tc::k1_loads(BITS); ++l) {
      const int row = min((s + d) * tc::k1_step_rows(BITS) + tc::k1_load_row(BITS, t, l),
                          kp - 1);
      tc::load_weights<VEC>(wl + (size_t)row * N, true, f[d][l]);
    }
  }
}

// The mmas of one group: acc[nb][i] += widen(weights) . x pairs.
template <int BITS, int VEC, int NB>
__device__ __forceinline__ void mma_group(uint32_t (*f)[tc::k1_loads(BITS)][VEC / 4],
                                          const uint32_t* xw, int stride, int s,
                                          int s_end, float (*acc)[VEC / 2][4]) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (s + d >= s_end) break;
    uint32_t b[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        b[nb][r] = xw[8 * nb * stride + 8 * (s + d) + 4 * r];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const int j0 = (2 * i) % 4, w0 = (2 * i) / 4;    // bytes 2i, 2i + 1
      uint32_t a[4];
      if constexpr (BITS == 4) {
        a[0] = tc::widen_int4(f[d][0][w0], j0);
        a[1] = tc::widen_int4(f[d][0][w0], j0 + 1);
        a[2] = tc::widen_int4(f[d][1][w0], j0);
        a[3] = tc::widen_int4(f[d][1][w0], j0 + 1);
      } else {
        a[0] = tc::widen_int8(f[d][0][w0], f[d][1][w0], j0);
        a[1] = tc::widen_int8(f[d][0][w0], f[d][1][w0], j0 + 1);
        a[2] = tc::widen_int8(f[d][2][w0], f[d][3][w0], j0);
        a[3] = tc::widen_int8(f[d][2][w0], f[d][3][w0], j0 + 1);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) tc::mma_bf16(acc[nb][i], a, b[nb][0], b[nb][1]);
    }
  }
}

// One tile of NB n-blocks: rows [0, live) of x / out (offset by the caller).
// Warp w takes k-steps [w * nsteps / 4, (w + 1) * nsteps / 4) in chunks of
// `chunk` (`tc_warp_chunks`), staging each chunk's x pairs in its own
// region of shared memory (TILE rows of `stride` words) before its mmas.
template <int BITS, int VEC, int NB, int TILE>
__device__ void tc_tile(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scales, bf16* __restrict__ out,
                        int live, int K, int N, int kp, int kb, int nsteps,
                        int chunk, int c0, uint32_t* smem) {
  constexpr int STRIP = 8 * VEC;
  constexpr int RED = STRIP + 4;               // floats a row of partials
  const int stride = 8 * chunk + kPairPad;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  __syncthreads();                             // the last tile's reads done

  float acc[NB][VEC / 2][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nb][i][r] = 0.f;

  const int s_begin = warp * nsteps / kTcWarps;
  const int s_end = (warp + 1) * nsteps / kTcWarps;
  const int col = c0 + VEC * g;
  const int8_t* wl = w + (col < N ? col : 0);
  uint32_t* xs = smem + (size_t)warp * TILE * stride;
  const uint32_t* xw = xs + g * stride + tc::k1_b_pair(t, 0);
  uint32_t fa[kDepth][tc::k1_loads(BITS)][VEC / 4];
  uint32_t fb[kDepth][tc::k1_loads(BITS)][VEC / 4];
  load_group<BITS, VEC>(fa, wl, s_begin, kp, N, t);
  for (int c = s_begin; c < s_end; c += chunk) {
    const int ce = min(c + chunk, s_end);
    __syncwarp();                              // the last chunk's reads done
    stage_pairs<BITS>(xs, x, 8 * NB, live, K, kp, kb, 8 * c, 8 * (ce - c),
                      stride);
    __syncwarp();
    for (int s = c; s < ce; s += 2 * kDepth) {
      load_group<BITS, VEC>(fb, wl, s + kDepth, kp, N, t);
      mma_group<BITS, VEC, NB>(fa, xw, stride, s - c, ce - c, acc);
      load_group<BITS, VEC>(fa, wl, s + 2 * kDepth, kp, N, t);
      mma_group<BITS, VEC, NB>(fb, xw, stride, s - c + kDepth, ce - c, acc);
    }
  }

  // the warps' partials [warp][row][column] over the staged pairs
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const int cc = tc::a_col(VEC, g, i, 0);
      float* p = red + ((size_t)warp * 8 * NB + 8 * nb + 2 * t) * RED + cc;
      *reinterpret_cast<float2*>(p) = make_float2(acc[nb][i][0], acc[nb][i][2]);
      *reinterpret_cast<float2*>(p + RED) = make_float2(acc[nb][i][1], acc[nb][i][3]);
    }
  __syncthreads();
  // sum in warp order, scale, round: two adjacent columns a thread
  constexpr int PAIRS = STRIP / 2;
  for (int idx = threadIdx.x; idx < live * PAIRS; idx += kTcThreads) {
    const int r = idx / PAIRS, cc = 2 * (idx % PAIRS);
    if (c0 + cc >= N) continue;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int k = 0; k < kTcWarps; ++k) {
      const float2 p = *reinterpret_cast<const float2*>(
          red + ((size_t)k * 8 * NB + r) * RED + cc);
      v0 += p.x;
      v1 += p.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c0 + cc) =
        __floats2bfloat162_rn(v0 * scales[c0 + cc], v1 * scales[c0 + cc + 1]);
  }
}

// Shared memory of a tile of `rows` rows: each warp's staged pairs, or the
// warps' partials after them, whichever is larger; it does not grow with K
// (grouped_gemm_quant.py `tc_smem` mirrors it).
__host__ __device__ inline size_t tc_smem(int bits, int vec, int rows, int K) {
  const int kp = bits == 4 ? K / 2 : K;
  const int nsteps = (kp + tc::k1_step_rows(bits) - 1) / tc::k1_step_rows(bits);
  const size_t pairs =
      (size_t)kTcWarps * rows * (8 * tc::chunk_steps(nsteps) + kPairPad) * 4;
  const size_t red = (size_t)kTcWarps * rows * (8 * vec + 4) * 4;
  return pairs > red ? pairs : red;
}

// Block (z, strip, e): expert e's row tiles z, z + Z, z + 2Z, ... (Z =
// gridDim.x row-tile groups, the wrapper's `tc_plan`) over one strip of
// columns. The Z blocks of one strip are neighbours in the grid, so they
// run side by side and read its weights from memory about once.
template <int BITS, int VEC, int NB_MAX>
__global__ void __launch_bounds__(kTcThreads)
gmm_quant_kernel_tc(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scales,
                    const int* __restrict__ counts, bf16* __restrict__ out,
                    int C, int K, int N, int blocks) {
  extern __shared__ __align__(16) uint32_t smem_tc[];
  constexpr int TILE = 8 * NB_MAX;
  const int z = blockIdx.x, groups = gridDim.x;
  const int c0 = blockIdx.y * 8 * VEC;
  const int e = blockIdx.z;
  const int kp = BITS == 4 ? K / 2 : K;
  const int kb = kp / blocks;
  const int nsteps = (kp + tc::k1_step_rows(BITS) - 1) / tc::k1_step_rows(BITS);
  const int chunk = tc::chunk_steps(nsteps);
  const int count = min(max(counts[e], 0), C);
  const bf16* xe = x + (size_t)e * C * K;
  const int8_t* we = w + (size_t)e * kp * N;
  const float* se = scales + (size_t)e * N;
  bf16* oe = out + (size_t)e * C * N;

  for (int r0 = z * TILE; r0 < count; r0 += groups * TILE) {
    const int live = min(TILE, count - r0);
    if (NB_MAX == 1 || live <= 8)
      tc_tile<BITS, VEC, 1, TILE>(xe + (size_t)r0 * K, we, se,
                                  oe + (size_t)r0 * N, live, K, N, kp, kb,
                                  nsteps, chunk, c0, smem_tc);
    else
      tc_tile<BITS, VEC, NB_MAX, TILE>(xe + (size_t)r0 * K, we, se,
                                       oe + (size_t)r0 * N, live, K, N, kp,
                                       kb, nsteps, chunk, c0, smem_tc);
  }
  // rows at or past the count (every groups-th of them here): zeros, 4
  // columns (8 bytes) a store
  constexpr int QUADS = 2 * VEC;
  const int dead = (C - count + groups - 1 - z) / groups;
  for (int idx = threadIdx.x; idx < dead * QUADS; idx += kTcThreads) {
    const int r = count + z + groups * (idx / QUADS), cc = c0 + 4 * (idx % QUADS);
    if (cc < N) *reinterpret_cast<uint2*>(oe + (size_t)r * N + cc) = make_uint2(0u, 0u);
  }
}

template <int BITS, int VEC, int NB_MAX>
cudaError_t launch_tc(const void* x, const int8_t* w, const float* scales,
                      const int* counts, void* out, int E, int C, int K, int N,
                      int blocks, int groups, cudaStream_t stream) {
  auto kernel = gmm_quant_kernel_tc<BITS, VEC, NB_MAX>;
  const size_t smem = tc_smem(BITS, VEC, 8 * NB_MAX, K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(groups, (N + 8 * VEC - 1) / (8 * VEC), E);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, scales, counts, static_cast<bf16*>(out),
      C, K, N, blocks);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t dispatch_tc(const void* x, const int8_t* w, const float* scales,
                        const int* counts, void* out, int E, int C, int K,
                        int N, int blocks, int tile_rows, int groups,
                        cudaStream_t s) {
  // 16-byte weight loads where every packed row starts 16-byte aligned
  const bool wide = N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (tile_rows == 8)
    return wide ? launch_tc<BITS, 16, 1>(x, w, scales, counts, out, E, C, K, N, blocks, groups, s)
                : launch_tc<BITS, 4, 1>(x, w, scales, counts, out, E, C, K, N, blocks, groups, s);
  return wide ? launch_tc<BITS, 16, 2>(x, w, scales, counts, out, E, C, K, N, blocks, groups, s)
              : launch_tc<BITS, 4, 2>(x, w, scales, counts, out, E, C, K, N, blocks, groups, s);
}

template <int BITS>
cudaError_t launch_f32(const void* x, const int8_t* w, const float* scales,
                       const int* counts, void* out, int E, int C, int K,
                       int N, int blocks, cudaStream_t stream) {
  dim3 grid((N + kStrip - 1) / kStrip, E);
  gmm_quant_kernel<BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), w, scales, counts,
      static_cast<float*>(out), C, K, N, blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body: tile_rows 8 or 16, groups >= 1 row-tile groups per strip).
// Requires N % 4 == 0, (K/2 or K) % blocks == 0, contiguous tensors on
// `device`. Returns a cudaError_t.
int grouped_gemm_quant_launch(const void* x, const int8_t* w, const float* scales,
                              const int* counts, void* out, int E, int C, int K,
                              int N, int bits, int blocks, int dtype,
                              int tile_rows, int groups, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if ((tile_rows != 8 && tile_rows != 16) || groups < 1)
      return (int)cudaErrorInvalidValue;
    err = bits == 4 ? dispatch_tc<4>(x, w, scales, counts, out, E, C, K, N, blocks, tile_rows, groups, s)
                    : dispatch_tc<8>(x, w, scales, counts, out, E, C, K, N, blocks, tile_rows, groups, s);
  } else {
    err = bits == 4 ? launch_f32<4>(x, w, scales, counts, out, E, C, K, N, blocks, s)
                    : launch_f32<8>(x, w, scales, counts, out, E, C, K, N, blocks, s);
  }
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
