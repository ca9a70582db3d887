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
// mask is by start + r / mq), as in the Pallas kernel.
//
// What bounds it on an H100: at the serving shape (64 rows, TQ = 128,
// 8 heads of 128, 2 groups, a window of up to 2048) the arithmetic,
// 4 * HD operations per (query, head, live position): up to 69 GFLOP a
// call against 54 MB of K/V, so the tensor-core rate bounds it.
//
// Design (simple first, CUDA cores): one block per (query tile, group,
// batch row), 256 threads as a 16 x 16 grid. A tile holds 64 query rows
// (64 / mq query positions x mq heads). The block streams the K/V window
// up to its last query's position in tiles of 64 positions through shared
// memory as floats (K transposed, nibbles and int8 widened on the way),
// computes the 64 x 64 score tile with 4 x 4 register tiles, keeps each
// row's running max and sum in registers (a row's 64 scores lie in one
// half-warp, reduced by shuffles), and accumulates the 64 x HD output in
// registers. INT4 caches need no split into one call per nibble: each run
// of values unpacks its own nibble. Tensor cores (mma / wgmma) are a later
// step.

#include "attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // query rows per block
constexpr int kCols = 64;       // cache positions per tile
constexpr int kRun = 16;        // values per vector load

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
    for (int idx = threadIdx.x; idx < kCols * (HD / kRun); idx += kThreads) {
      const int col = idx / (HD / kRun), c = (idx % (HD / kRun)) * kRun;
      const int t = t0 + col;
      float kv[kRun], vv[kRun];
      if (t < n_pos) {
        attn::load_run<T, MODE, kRun>(kb + (size_t)t * rb, g * HD + c, D, kv);
        attn::load_run<T, MODE, kRun>(vb + (size_t)t * rb, g * HD + c, D, vv);
      } else {
#pragma unroll
        for (int u = 0; u < kRun; ++u) kv[u] = vv[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) kt[(c + u) * kCols + col] = kv[u];
      float4* vrow = reinterpret_cast<float4*>(vt + col * HD + c);
#pragma unroll
      for (int u = 0; u < kRun / 4; ++u)
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
#pragma unroll
      for (int u = 0; u < DV / 4; ++u) {
        const float4 v4 = *reinterpret_cast<const float4*>(vt + col * HD + tc * DV + 4 * u);
        vv[4 * u] = v4.x; vv[4 * u + 1] = v4.y; vv[4 * u + 2] = v4.z; vv[4 * u + 3] = v4.w;
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

}  // namespace

extern "C" {

// mode: 0 = float cache (of q's type), 1 = int8, 2 = int4 split-half;
// dtype: 0 = float32, 1 = bfloat16; HD in {64, 128, 256}; NH / KVH <= 64;
// start + TQ <= W <= Tc. Returns a cudaError_t.
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
  err = dtype == 1
            ? launch_mode<__nv_bfloat16>(a, B, HD, NH / KVH, mode, s)
            : launch_mode<float>(a, B, HD, NH / KVH, mode, s);
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
