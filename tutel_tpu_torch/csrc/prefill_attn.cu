// Causal attention of a prompt chunk over the KV cache prefix, GQA,
// float / INT8 / INT4 caches (K7).
//
// Replaces the Pallas kernel `prefill_attn` (tutel_tpu/ops/decode_attn_pallas
// .py:493, body `_prefill_attn_kernel` :413). The chunk's TQ queries sit at
// global positions start + i. For batch row b, query i and head
// h = m * KVH + g (KV group g = h % KVH), over cache positions t < W:
//   s[t]  = (q[b, i, h] . K[b, t, g]) * HD^-0.5 (* k_scale[b, g, t])
//   live  = t <= start + i
//   out   = sum_t e[t] * v_scale[b, g, t] * V[b, t, g] / sum_t e[t]
// with the online softmax in float32 and the softmax weights rounded to
// the query's type before the combine, as the Pallas kernel does. The
// query rows of one group are kept group-major (row r = i * mq + m, so the
// mask is by start + r / mq), as in the Pallas kernel: one K/V tile serves
// every head of the group.
//
// What bounds it on an H100: at the serving shape (64 rows, TQ = 128,
// 8 heads of 128, 2 groups, a window of up to 2048) the arithmetic,
// 4 * HD operations per (query, head, live position): up to 69 GFLOP a
// call against 54 MB of K/V, so the tensor-core rate bounds it.
//
// Two kernels behind one entry, picked by the query's type:
//
// bfloat16 queries (the serving type), `prefill_attn_kernel_tc`, on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate), in the
// FlashAttention-2 way. One block per (query tile, group, batch row), 8
// warps and 128 query rows, 16 per warp (one m16 tile). Each K/V tile
// then serves 128 rows: against 4 warps of 64 rows (two blocks an SM) it
// halves the K/V copies and the widening per product, and it was the
// faster of the two on the H100 in every cache (PERF.md); more rows a
// warp would not fit the registers (HD 128: 32 of Q fragments, 64 of
// output, 32 of scores a thread). Q is copied once into shared memory
// and held in registers as A fragments (ldmatrix) for the whole walk. The
// walk over the causal prefix goes in K/V tiles of 64 positions (32 at
// HD 256), copied with 16-byte cp.async into a second stage while the
// current one computes, one barrier a tile. A bf16 cache lands straight
// in the tile; INT8 and INT4 (split-half) bytes land in a staging buffer
// one tile further ahead, and the block widens them into the bf16 tile
// (int8 and int4 values are exact in bf16, as the twin's cast) after its
// products, so one warp's widening overlaps another's products; the
// tile's K and V scales move beside it. S = Q K^T takes K [position][HD]
// as the .col B operand (plain ldmatrix); the scores are scaled by the K
// scale, masked and folded into the running max and sum per row (a row
// sits in a quad of lanes: two shuffles), with HD^-0.5 * log2(e) applied
// inside one FFMA before ex2; P = e * v_scale is rounded to bf16 and
// repacked from the C fragments into A fragments in registers; O += P V
// takes V through ldmatrix.trans. Tile rows are 16-byte chunks
// XOR-swizzled by row % 8 against bank conflicts. The output goes out
// through shared memory in 16-byte stores.
//
// float32 queries, `prefill_attn_kernel` (CUDA cores, simple first): TF32
// would round q and K to 10 bits, so float32 stays off the tensor cores.
// One block per (query tile, group, batch row), 256 threads as a 16 x 16
// grid. A tile holds 64 query rows (64 / mq query positions x mq heads).
// The block streams the K/V window up to its last query's position in
// tiles of 64 positions through shared memory as floats (K transposed,
// nibbles and int8 widened on the way), computes the 64 x 64 score tile
// with 4 x 4 register tiles, keeps each row's running max and sum in
// registers (a row's 64 scores lie in one half-warp, reduced by
// shuffles), and accumulates the 64 x HD output in registers. INT4 caches
// need no split into one call per nibble in either kernel: each run of
// values unpacks its own nibble.

#include "attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // query rows per block
constexpr int kCols = 64;       // cache positions per tile
// values per vector load of a cache row: 16, but 8 for INT4 at HD 16,
// whose packed rows (8 * KVH bytes) hold a group's 16 values as the low
// nibbles of 8 bytes, then the high ones, where KVH is odd
template <int MODE, int HD> __host__ __device__ constexpr int run() {
  return MODE == 2 && HD == 16 ? 8 : 16;
}
constexpr int kRun = 16;        // values per vector load of q

struct Args {
  const void* q;                // [B, TQ, NH, HD] of T
  const char* k;                // [B, Tc, row] stored
  const char* v;
  const float* ks;              // [B, KVH, Tc] or null (float cache)
  const float* vs;
  void* out;                    // [B, TQ, NH, HD] of T
  int TQ, NH, KVH, Tc, W, start;
  float scale;
};

template <typename T, int MODE, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(const Args a, int mq) {
  constexpr int DV = HD / 16;                      // output dims per thread
  constexpr int RUN = run<MODE, HD>();
  constexpr bool kQuant = MODE != 0;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                                // [HD][kRows]
  float* kt = qt + HD * kRows;                     // [HD][kCols]
  float* vt = kt + HD * kCols;                     // [kCols][HD]
  float* pt = vt + kCols * HD;                     // [kCols][kRows]
  float* ksc = pt + kCols * kRows;                 // [kCols]
  float* vsc = ksc + kCols;                        // [kCols]

  const int g = blockIdx.y, b = blockIdx.z;
  const int qpt = kRows / mq;                      // query positions per tile
  const int q0 = blockIdx.x * qpt;
  const int nq = min(qpt, a.TQ - q0);
  const int rows = nq * mq;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int D = a.KVH * HD;
  const size_t rb = attn::row_bytes<T, MODE>(D);
  const int n_pos = min(a.W, a.start + q0 + nq);   // positions any row reads

  // queries, transposed: qt[k][r] for row r = i * mq + m
  for (int idx = threadIdx.x; idx < kRows * (HD / kRun); idx += kThreads) {
    const int r = idx / (HD / kRun), c = (idx % (HD / kRun)) * kRun;
    float vals[kRun];
    if (r < rows) {
      const int i = r / mq, m = r % mq;
      const char* qrow = static_cast<const char*>(a.q) +
          (((size_t)b * a.TQ + q0 + i) * a.NH + m * a.KVH + g) * HD * sizeof(T);
      attn::load_run<T, 0, kRun>(qrow, c, HD, vals);
    } else {
#pragma unroll
      for (int u = 0; u < kRun; ++u) vals[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRun; ++u) qt[(c + u) * kRows + r] = vals[u];
  }

  float mrow[4], z[4], o[4][DV];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    mrow[i] = attn::kMaskedScore;
    z[i] = 0.f;
    qpos[i] = r < rows ? a.start + q0 + r / mq : -1;
#pragma unroll
    for (int j = 0; j < DV; ++j) o[i][j] = 0.f;
  }

  const char* kb = a.k + (size_t)b * a.Tc * rb;
  const char* vb = a.v + (size_t)b * a.Tc * rb;
  const float* ksb = kQuant ? a.ks + ((size_t)b * a.KVH + g) * a.Tc : nullptr;
  const float* vsb = kQuant ? a.vs + ((size_t)b * a.KVH + g) * a.Tc : nullptr;

  for (int t0 = 0; t0 < n_pos; t0 += kCols) {
    __syncthreads();                               // previous tile consumed
    for (int idx = threadIdx.x; idx < kCols * (HD / RUN); idx += kThreads) {
      const int col = idx / (HD / RUN), c = (idx % (HD / RUN)) * RUN;
      const int t = t0 + col;
      float kv[RUN], vv[RUN];
      if (t < n_pos) {
        attn::load_run<T, MODE, RUN>(kb + (size_t)t * rb, g * HD + c, D, kv);
        attn::load_run<T, MODE, RUN>(vb + (size_t)t * rb, g * HD + c, D, vv);
      } else {
#pragma unroll
        for (int u = 0; u < RUN; ++u) kv[u] = vv[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < RUN; ++u) kt[(c + u) * kCols + col] = kv[u];
      float4* vrow = reinterpret_cast<float4*>(vt + col * HD + c);
#pragma unroll
      for (int u = 0; u < RUN / 4; ++u)
        vrow[u] = make_float4(vv[4 * u], vv[4 * u + 1], vv[4 * u + 2], vv[4 * u + 3]);
    }
    if (threadIdx.x < kCols) {
      const int t = t0 + threadIdx.x;
      ksc[threadIdx.x] = (kQuant && t < n_pos) ? ksb[t] : 1.f;
      vsc[threadIdx.x] = (kQuant && t < n_pos) ? vsb[t] : 1.f;
    }
    __syncthreads();

    // scores: rows tr*4 + i, positions t0 + tc*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < HD; ++k) {
      const float4 qq = *reinterpret_cast<const float4*>(qt + k * kRows + tr * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kt + k * kCols + tc * 4);
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // online softmax per row; a row's 64 positions live in one half-warp
    float ev[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = attn::kMaskedScore;
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tc * 4 + j;
        live[j] = t < n_pos && t <= qpos[i];
        float sc = s[i][j] * a.scale;
        if (kQuant) sc *= ksc[tc * 4 + j];
        s[i][j] = live[j] ? sc : attn::kMaskedScore;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[i], mx);
      const float corr = expf(mrow[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        ev[i][j] = attn::round_to<T>(kQuant ? e * vsc[tc * 4 + j] : e);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      z[i] = z[i] * corr + sum;
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV; ++j) o[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tc * 4 + j) * kRows + tr * 4) =
          make_float4(ev[0][j], ev[1][j], ev[2][j], ev[3][j]);
    __syncthreads();

    // combine: o[rows, dims tc*DV ..] += P[rows, cols] . V[cols, dims]
    const int n_cols = min(kCols, n_pos - t0);
#pragma unroll 4
    for (int col = 0; col < n_cols; ++col) {
      const float4 pp = *reinterpret_cast<const float4*>(pt + col * kRows + tr * 4);
      const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
      float vv[DV];
      if constexpr (DV % 4 == 0) {
#pragma unroll
        for (int u = 0; u < DV / 4; ++u) {
          const float4 v4 = *reinterpret_cast<const float4*>(vt + col * HD + tc * DV + 4 * u);
          vv[4 * u] = v4.x; vv[4 * u + 1] = v4.y; vv[4 * u + 2] = v4.z; vv[4 * u + 3] = v4.w;
        }
      } else {                                     // HD 16 and 32
#pragma unroll
        for (int u = 0; u < DV; ++u) vv[u] = vt[col * HD + tc * DV + u];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DV; ++j) o[i][j] = fmaf(pa[i], vv[j], o[i][j]);
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= rows) continue;
    const int qi = q0 + r / mq, h = (r % mq) * a.KVH + g;
    T* orow = out + (((size_t)b * a.TQ + qi) * a.NH + h) * HD + tc * DV;
    const float inv = 1.f / fmaxf(z[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV; ++j) orow[j] = attn::from_float<T>(o[i][j] * inv);
  }
}

template <typename T, int MODE, int HD>
cudaError_t launch(const Args& a, int B, int mq, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)HD * kRows + (size_t)HD * kCols + (size_t)kCols * HD +
       (size_t)kCols * kRows + 2 * kCols);
  auto kernel = prefill_attn_kernel<T, MODE, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qpt = kRows / mq;
  dim3 grid((a.TQ + qpt - 1) / qpt, a.KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(a, mq);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_hd(const Args& a, int B, int HD, int mq, cudaStream_t s) {
  switch (HD) {
    case 16: return launch<T, MODE, 16>(a, B, mq, s);
    case 32: return launch<T, MODE, 32>(a, B, mq, s);
    case 64: return launch<T, MODE, 64>(a, B, mq, s);
    case 128: return launch<T, MODE, 128>(a, B, mq, s);
    case 256: return launch<T, MODE, 256>(a, B, mq, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mode(const Args& a, int B, int HD, int mq, int mode,
                        cudaStream_t s) {
  switch (mode) {
    case 0: return launch_hd<T, 0>(a, B, HD, mq, s);
    case 1: return launch_hd<T, 1>(a, B, HD, mq, s);
    case 2: return launch_hd<T, 2>(a, B, HD, mq, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- bfloat16 queries on the tensor cores --------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;                 // query rows per block

// cache positions per K/V tile: 32 at HD 256 keep the score fragments small
template <int HD> __host__ __device__ constexpr int cols() {
  return HD == 256 ? 32 : 64;
}

// bytes of dynamic shared memory: Q, two stages of bf16 K/V tiles with
// their K and V scales, and for INT8/INT4 two stages of stored bytes and
// scales as they arrive
template <int MODE, int HD> constexpr size_t smem_bytes() {
  constexpr size_t tile = (size_t)cols<HD>() * HD * 2;
  constexpr size_t raw = (size_t)cols<HD>() * HD;
  constexpr size_t scales = 2 * cols<HD>() * sizeof(float);
  return (size_t)kRows * HD * 2 + 2 * (2 * tile + scales) +
         (MODE == 0 ? 0 : 2 * (2 * raw + scales));
}

using attn::cp_async16;
using attn::cp_async4;
using attn::cp_async8;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::smem_u32;

// byte offset of 16-byte chunk c of row r in a [rows][HD] bf16 tile; the
// chunks of a row are XOR-swizzled by r % 8, so the 8 rows one ldmatrix
// phase reads fall in 8 different bank groups. A row of HD 16 or 32 holds
// 2 or 4 chunks, and 8 / chunks rows share a 128-byte line: there the
// chunks are swizzled by the line's index instead, to the same end.
template <int HD> __device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kC = HD / 8;                       // chunks a row
  if constexpr (kC >= 8) return r * (HD * 2) + ((c ^ (r & 7)) << 4);
  else return r * (HD * 2) + ((c ^ ((r / (8 / kC)) & (kC - 1))) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU instruction (flushes denormals, about 2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 stored values (16 int8 bytes, or one nibble of 16 int4 bytes) ->
// 16 bf16 as two 16-byte chunks. Each byte u, offset to unsigned, becomes
// the float 2^23 + u (its bits 0x4b0000uu), minus 2^23 + offset: exact.
template <int MODE>
__device__ __forceinline__ void widen16(uint4 raw, bool high, uint4& lo,
                                        uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  constexpr float kOff = 8388608.f + (MODE == 1 ? 128.f : 8.f);
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = MODE == 1
        ? w[i] ^ 0x80808080u
        : ((high ? w[i] >> 4 : w[i]) & 0x0f0f0f0fu) ^ 0x08080808u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 | j)) - kOff;
    out[2 * i] = pack_bf16(f[0], f[1]);
    out[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

template <int MODE, int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attn_kernel_tc(const Args a, int mq) {
  constexpr int kCols = cols<HD>();              // positions per K/V tile
  constexpr bool kQuant = MODE != 0;
  constexpr int kChunks = HD / 8;                // 16-byte chunks, bf16 row
  constexpr int RUN = run<MODE, HD>();           // values a stored run
  constexpr int kRuns = kQuant ? HD / RUN : HD / 8;  // runs a stored row
  constexpr int kTile = kCols * HD * 2;          // bytes of a bf16 tile
  constexpr int kRaw = kCols * HD;               // bytes of a stored tile
  constexpr int kScales = 2 * kCols * 4;         // K then V scales, f32
  constexpr int kStage = 2 * kTile + kScales;    // bf16 K, V, scales
  constexpr int kRawStage = 2 * kRaw + kScales;  // stored K, V, scales
  extern __shared__ __align__(128) char tc_smem[];
  char* const qs = tc_smem;                      // [kRows][HD] bf16
  char* const tiles = qs + kRows * HD * 2;       // stage s at s * kStage
  char* const raw = tiles + 2 * kStage;          // stage s at s * kRawStage

  const int g = blockIdx.y, b = blockIdx.z;
  const int qpt = kRows / mq;                    // query positions per tile
  const int q0 = blockIdx.x * qpt;
  const int nq = min(qpt, a.TQ - q0);
  const int rows = nq * mq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.KVH * HD;
  const size_t rb = attn::row_bytes<__nv_bfloat16, MODE>(D);
  const int n_pos = min(a.W, a.start + q0 + nq);  // positions any row reads
  const int n_tiles = (n_pos + kCols - 1) / kCols;
  const char* kb = a.k + (size_t)b * a.Tc * rb;
  const char* vb = a.v + (size_t)b * a.Tc * rb;
  const float* ksb = kQuant ? a.ks + ((size_t)b * a.KVH + g) * a.Tc : nullptr;
  const float* vsb = kQuant ? a.vs + ((size_t)b * a.KVH + g) * a.Tc : nullptr;

  // start copying positions [tile * kCols, +kCols) into stage `stage`:
  // a bf16 cache straight into the bf16 tiles, INT8/INT4 bytes and the
  // scales into the staging buffers; positions past n_pos are zero-filled
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * kCols;
    for (int idx = threadIdx.x; idx < kCols * kRuns; idx += kThreads) {
      const int p = idx / kRuns, j = idx % kRuns;
      const bool live = t0 + p < n_pos;
      size_t off = (size_t)(live ? t0 + p : 0) * rb;
      uint32_t dk;
      if constexpr (kQuant) {
        const int c0 = g * HD + RUN * j;         // first logical value
        off += MODE == 2 && c0 >= D / 2 ? c0 - D / 2 : c0;
        dk = smem_u32(raw + stage * kRawStage) + p * HD + RUN * j;
      } else {
        off += ((size_t)g * HD + 8 * j) * 2;
        dk = smem_u32(tiles + stage * kStage) + swz<HD>(p, j);
      }
      if constexpr (kQuant && RUN == 8) {
        cp_async8(dk, kb + off, live);
        cp_async8(dk + kRaw, vb + off, live);
      } else {
        cp_async16(dk, kb + off, live);
        cp_async16(dk + (kQuant ? kRaw : kTile), vb + off, live);
      }
    }
    if constexpr (kQuant) {
      const uint32_t sc = smem_u32(raw + stage * kRawStage + 2 * kRaw);
      for (int idx = threadIdx.x; idx < 2 * kCols; idx += kThreads) {
        const int p = idx % kCols, isv = idx / kCols;
        const bool live = t0 + p < n_pos;
        cp_async4(sc + 4 * idx, (isv ? vsb : ksb) + (live ? t0 + p : 0),
                  live);
      }
    }
    cp_async_commit();
  };

  // INT8/INT4: widen the stored tile of stage `stage` into the bf16 tiles
  // of the same stage, and move its scales beside them
  auto widen_tile = [&](int stage) {
    const char* rk = raw + stage * kRawStage;
    char* dst = tiles + stage * kStage;
    for (int idx = threadIdx.x; idx < kCols * kRuns; idx += kThreads) {
      const int p = idx / kRuns, j = idx % kRuns;
      const bool high = MODE == 2 && g * HD + RUN * j >= D / 2;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const char* src = rk + kv * kRaw + p * HD + RUN * j;
        if constexpr (RUN == 16) {
          uint4 lo, hi;
          widen16<MODE>(*reinterpret_cast<const uint4*>(src), high, lo, hi);
          *reinterpret_cast<uint4*>(dst + kv * kTile + swz<HD>(p, 2 * j)) = lo;
          *reinterpret_cast<uint4*>(dst + kv * kTile + swz<HD>(p, 2 * j + 1)) =
              hi;
        } else {                                 // 8 values: one chunk
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          uint4 lo, hi;
          widen16<MODE>(make_uint4(w.x, w.y, 0u, 0u), high, lo, hi);
          *reinterpret_cast<uint4*>(dst + kv * kTile + swz<HD>(p, j)) = lo;
        }
      }
    }
    for (int idx = threadIdx.x; idx < 2 * kCols; idx += kThreads)
      reinterpret_cast<float*>(dst + 2 * kTile)[idx] =
          reinterpret_cast<const float*>(rk + 2 * kRaw)[idx];
  };

  // queries, row r = i * mq + m (padding rows zero-filled)
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool live = r < rows;
    const int i = live ? r / mq : 0, m = live ? r % mq : 0;
    const char* src = static_cast<const char*>(a.q) +
        ((((size_t)b * a.TQ + q0 + i) * a.NH + m * a.KVH + g) * HD + 8 * c) * 2;
    cp_async16(smem_u32(qs) + swz<HD>(r, c), src, live);
  }
  cp_async_commit();
  load_tile(0, 0);
  if (kQuant && n_tiles > 1) load_tile(1, 1);   // one ahead of the widening
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kQuant) {
    widen_tile(0);
    __syncthreads();
  }
  uint32_t qf[HD / 16][4];                       // A fragments of the warp's rows
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qf[kk], smem_u32(qs) +
                        swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  // this thread's two rows: r_lo (C fragment values 0, 1) and r_lo + 8
  const int r_lo = warp * 16 + lane / 4, r_hi = r_lo + 8;
  const int qpos_lo = r_lo < rows ? a.start + q0 + r_lo / mq : -1;
  const int qpos_hi = r_hi < rows ? a.start + q0 + r_hi / mq : -1;
  const int q_first = a.start + q0;              // every row reads t <= q_first
  const float sl2 = a.scale * 1.4426950408889634f;  // HD^-0.5 * log2(e)
  float m_lo = attn::kMaskedScore, m_hi = attn::kMaskedScore;
  float z_lo = 0.f, z_hi = 0.f;                  // this thread's columns only
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // One barrier a tile: after it, tile `tile` is complete in bf16 in its
  // stage, the other stage (tile - 1) is free, and what was copied before
  // has landed. A bf16 cache then copies tile + 1 into the free stage
  // while this one computes; INT8/INT4 copy tile + 2 into the staging
  // buffer that tile held, and after computing widen tile + 1 (landed)
  // into the free bf16 stage, so one warp's widening overlaps another's
  // products.
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile > 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const int next = tile + 1 + kQuant;          // the next tile to copy
    if (next < n_tiles) load_tile(next, next & 1);
    const char* kt = tiles + stage * kStage;
    const char* vt = kt + kTile;
    const float* ksc = reinterpret_cast<const float*>(kt + 2 * kTile);
    const float* vsc = ksc + kCols;

    // S = Q K^T: [16 rows x kCols] per warp, n-tile j = positions 8j..8j+7
    float s[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < kCols / 16; ++p) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(kt) + swz<HD>(16 * p + (lane & 7) + ((lane >> 4) << 3),
                                          2 * kk + ((lane >> 3) & 1)));
        mma(s[2 * p], qf[kk], bk[0], bk[1]);
        mma(s[2 * p + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // K scale and mask, then the online softmax per row; the running max
    // is kept without the factor sl2, which one FFMA applies in exp2
    const int t0 = tile * kCols;
    const bool edge = t0 + kCols - 1 > q_first;  // some position is masked
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        float lo = s[j][e], hi = s[j][2 + e];
        if (kQuant) {
          lo *= ksc[c];
          hi *= ksc[c];
        }
        if (edge) {
          lo = t0 + c <= qpos_lo ? lo : attn::kMaskedScore;
          hi = t0 + c <= qpos_hi ? hi : attn::kMaskedScore;
        }
        s[j][e] = lo;
        s[j][2 + e] = hi;
        mx_lo = fmaxf(mx_lo, lo);
        mx_hi = fmaxf(mx_hi, hi);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float corr_lo = ex2((m_lo - mx_lo) * sl2);
    const float corr_hi = ex2((m_hi - mx_hi) * sl2);
    m_lo = mx_lo;
    m_hi = mx_hi;
    z_lo *= corr_lo;
    z_hi *= corr_hi;
    if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {   // some row's max moved
        o[d][0] *= corr_lo; o[d][1] *= corr_lo;
        o[d][2] *= corr_hi; o[d][3] *= corr_hi;
      }
    }
    const float mb_lo = m_lo * sl2, mb_hi = m_hi * sl2;
    // P = e * v_scale, rounded to bf16, repacked from C into A fragments:
    // k-step kv covers n-tiles 2kv (A regs 0, 1) and 2kv + 1 (regs 2, 3)
    uint32_t pf[kCols / 16][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // a masked score is -1e30 below a finite running max: e = 0
        e[u] = ex2(fmaf(s[j][u], sl2, -(u < 2 ? mb_lo : mb_hi)));
        if (u < 2) z_lo += e[u]; else z_hi += e[u];
        if (kQuant) e[u] *= vsc[8 * j + 2 * (lane & 3) + (u & 1)];
      }
      pf[j / 2][2 * (j & 1)] = pack_bf16(e[0], e[1]);
      pf[j / 2][2 * (j & 1) + 1] = pack_bf16(e[2], e[3]);
    }

    // O += P V: V [position][HD] through ldmatrix.trans
#pragma unroll
    for (int kv = 0; kv < kCols / 16; ++kv) {
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_u32(vt) +
                              swz<HD>(16 * kv + (lane & 7) + (((lane >> 3) & 1) << 3),
                                      2 * d + (lane >> 4)));
        mma(o[2 * d], pf[kv], bv[0], bv[1]);
        mma(o[2 * d + 1], pf[kv], bv[2], bv[3]);
      }
    }
    if constexpr (kQuant) {
      if (tile + 1 < n_tiles) widen_tile(stage ^ 1);
    }
  }

  // epilogue: each warp rounds its 16 rows into its part of qs (read only
  // before the walk), then stores them with 16-byte writes
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    z_lo += __shfl_xor_sync(0xffffffffu, z_lo, off);
    z_hi += __shfl_xor_sync(0xffffffffu, z_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(z_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(z_hi, 1e-30f);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    *reinterpret_cast<uint32_t*>(qs + swz<HD>(r_lo, d) + 4 * (lane & 3)) =
        pack_bf16(o[d][0] * inv_lo, o[d][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(qs + swz<HD>(r_hi, d) + 4 * (lane & 3)) =
        pack_bf16(o[d][2] * inv_hi, o[d][3] * inv_hi);
  }
  __syncwarp();
  char* out = static_cast<char*>(a.out);
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = warp * 16 + idx / kChunks, c = idx % kChunks;
    if (r >= rows) continue;
    const int qi = q0 + r / mq, h = (r % mq) * a.KVH + g;
    *reinterpret_cast<uint4*>(
        out + ((((size_t)b * a.TQ + qi) * a.NH + h) * HD + 8 * c) * 2) =
        *reinterpret_cast<const uint4*>(qs + swz<HD>(r, c));
  }
}

template <int MODE, int HD>
cudaError_t launch(const Args& a, int B, int mq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<MODE, HD>();
  auto kernel = prefill_attn_kernel_tc<MODE, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qpt = kRows / mq;
  dim3 grid((a.TQ + qpt - 1) / qpt, a.KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(a, mq);
  return cudaGetLastError();
}

cudaError_t launch_mode(const Args& a, int B, int HD, int mq, int mode,
                        cudaStream_t s) {
#define TT_PREFILL_HD(MODE)                          \
  switch (HD) {                                      \
    case 16: return launch<MODE, 16>(a, B, mq, s);   \
    case 32: return launch<MODE, 32>(a, B, mq, s);   \
    case 64: return launch<MODE, 64>(a, B, mq, s);   \
    case 128: return launch<MODE, 128>(a, B, mq, s); \
    case 256: return launch<MODE, 256>(a, B, mq, s); \
    default: return cudaErrorInvalidValue;           \
  }
  switch (mode) {
    case 0: TT_PREFILL_HD(0)
    case 1: TT_PREFILL_HD(1)
    case 2: TT_PREFILL_HD(2)
    default: return cudaErrorInvalidValue;
  }
#undef TT_PREFILL_HD
}

}  // namespace tc

}  // namespace

extern "C" {

// mode: 0 = float cache (of q's type), 1 = int8, 2 = int4 split-half;
// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); HD in {16, 32, 64, 128, 256}; NH / KVH <= 64; start + TQ <= W <= Tc;
// q, k, v 16-byte aligned. Returns a cudaError_t.
int prefill_attn_launch(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, void* out, int B,
                        int TQ, int NH, int KVH, int HD, int Tc, int W,
                        int start, int mode, int dtype, int device,
                        void* stream) {
  if (KVH <= 0 || NH % KVH || NH / KVH > kRows || B <= 0 || TQ <= 0 ||
      start < 0 || start + TQ > W || W > Tc)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, static_cast<const char*>(k), static_cast<const char*>(v), ks, vs,
         out, TQ, NH, KVH, Tc, W, start, (float)(1.0 / sqrt((double)HD))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_mode<float>(a, B, HD, NH / KVH, mode, s);
    case 1: return (int)tc::launch_mode(a, B, HD, NH / KVH, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
