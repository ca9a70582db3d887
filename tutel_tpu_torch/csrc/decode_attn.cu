// One-token (decode) attention over a KV cache, GQA, float / INT8 / INT4
// caches, with optional fresh-row injection (K6).
//
// Replaces the Pallas kernel `decode_attn` (tutel_tpu/ops/decode_attn_pallas
// .py:171, body `_decode_attn_kernel` :58). For batch row b, query head
// h = m * KVH + g (KV group g = h % KVH) and window positions t < W:
//   s[t]   = (q[b, h] . K[b, t, g]) * HD^-0.5 (* k_scale[b, g, t])
//   live   = t <= pos[b]  (t < pos[b] with a fresh row)
//   out    = sum_t e[t] * v_scale[b, g, t] * V[b, t, g] / sum_t e[t]
// with e the softmax weights, rounded to the query's type before the
// combine (as the Pallas kernel does). With a fresh row (k_new, v_new in
// the cache's stored form, plus their scales) position pos[b] is not read
// from the cache: its score and V row seed the online softmax
// (m = s_new, z = 1, acc = v_new_scale * v_new), so the caller can write
// the cache after the step (kernel K8).
//
// What bounds it on an H100: the K/V window's bytes. At 64 rows x 2048
// positions x 2 groups x 128 dims, INT8, that is 67 MB plus 2 MB of scales
// per call, 21 us at 3.35 TB/s; the arithmetic (4 dot products of 128 per
// position and group) is far below the card's rate.
//
// Design (simple first): one block per (group g, batch row b), 8 warps.
// Only positions t < pos[b] (+1) are read, so a short row costs little.
// Each warp walks its own tiles of 32 positions and keeps its own online
// softmax state per query head (m, z, acc over HD) in registers. In a tile,
// lane l scores position tile + l against the group's query heads (q
// staged in shared memory as floats), reading its whole K row with vector
// loads; the warp then takes the tile's max and sum by shuffles, and
// combines the tile's 32 V rows, each lane owning HD/32 dims. At the end
// the 8 warp states merge through shared memory.
//
// The shuffles must run where the compiler can prove the warp converged,
// or it turns each into a slow warp-collective sequence: so the number of
// query heads per group is a template parameter (rounded up to 1, 2, 4 or
// 8, with zero heads as padding), every warp runs the same number of
// tiles, and a tile's body has no branch. Measured on the H100 this made
// the kernel 3x faster (PERF.md). One block per row and group still
// leaves it at about a quarter of the memory rate; splitting the window over more
// blocks is the next step. The TPU kernel's block-diagonal q packing (a
// device for its matrix unit) and its window chunk ladder are not needed.
// CUDA cores only; no tensor cores yet.

#include "attn_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxMq = 8;        // query heads per KV group, at most
constexpr int kRun = 16;         // K values per vector load in the score

struct Args {
  const void* q;                 // [B, NH, HD] of T
  const char* k;                 // [B, Tc, row] stored
  const char* v;
  const float* ks;               // [B, KVH, Tc] or null (float cache)
  const float* vs;
  const int* pos;                // [B]
  const char* kn;                // [B, row] stored, or null (no fresh row)
  const char* vn;
  const float* kns;              // [B, KVH] or null
  const float* vns;
  void* out;                     // [B, NH, HD] of T
  int NH, KVH, Tc, W;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int MODE, int DPL, int MQ>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const Args a, int mq) {
  constexpr int HD = 32 * DPL;
  constexpr bool kQuant = MODE != 0;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // [MQ][HD]
  float* wm = qs + MQ * HD;                          // [warps][MQ]
  float* wz = wm + kWarps * MQ;                      // [warps][MQ]
  float* wacc = wz + kWarps * MQ;                    // [warps][MQ][HD]

  const int g = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.KVH * HD;
  const size_t rb = attn::row_bytes<T, MODE>(D);
  const bool fresh = a.kn != nullptr;
  const int p = a.pos[b];
  const int n_live = max(0, min(fresh ? p : p + 1, a.W));
  const T* q = static_cast<const T*>(a.q);

  // the group's query heads m < mq; heads mq <= m < MQ are zero padding
  for (int i = threadIdx.x; i < MQ * HD; i += kThreads) {
    const int m = i / HD, d = i % HD;
    qs[i] = m < mq ? attn::to_float(q[((size_t)b * a.NH + m * a.KVH + g) * HD + d])
                   : 0.f;
  }
  __syncthreads();

  float mrun[MQ], z[MQ], acc[MQ][DPL];
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    mrun[m] = attn::kMaskedScore;
    z[m] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[m][i] = 0.f;
  }
  const int c_lane = g * HD + lane * DPL;             // this lane's V dims
  if (fresh) {             // every warp scores it; warp 0 keeps it
    float kv[DPL], vv[DPL];
    attn::load_run<T, MODE, DPL>(a.kn + b * rb, c_lane, D, kv);
    attn::load_run<T, MODE, DPL>(a.vn + b * rb, c_lane, D, vv);
    const float ksn = kQuant ? a.kns[b * a.KVH + g] : 1.f;
    const float vsn = kQuant ? a.vns[b * a.KVH + g] : 1.f;
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s = fmaf(qs[m * HD + lane * DPL + i], kv[i], s);
      s = warp_sum(s) * a.scale;
      if (kQuant) s *= ksn;
      if (warp == 0) {
        mrun[m] = s;
        z[m] = 1.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[m][i] = vsn * vv[i];
      }
    }
  }

  const char* kb = a.k + (size_t)b * a.Tc * rb;
  const char* vb = a.v + (size_t)b * a.Tc * rb;
  const float* ksb = kQuant ? a.ks + ((size_t)b * a.KVH + g) * a.Tc : nullptr;
  const float* vsb = kQuant ? a.vs + ((size_t)b * a.KVH + g) * a.Tc : nullptr;

  // Every warp runs the same number of tiles and a tile's body has no
  // branch: a lane past the live window reads the last live row and is
  // masked (its softmax weight is 0). So the compiler sees every shuffle on
  // a converged warp, and a tile's loads are issued together.
  const int n_tiles = (n_live + kWarps * 32 - 1) / (kWarps * 32);
  for (int it = 0; it < n_tiles; ++it) {
    const int tile = (it * kWarps + warp) * 32;
    const int t = tile + lane;
    const bool live = t < n_live;
    const int row = min(t, n_live - 1);
    float s[MQ];
#pragma unroll
    for (int m = 0; m < MQ; ++m) s[m] = 0.f;
    const char* krow = kb + (size_t)row * rb;
#pragma unroll
    for (int c = 0; c < HD; c += kRun) {
      float kv[kRun];
      attn::load_run<T, MODE, kRun>(krow, g * HD + c, D, kv);
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + m * HD + c);
#pragma unroll
        for (int j = 0; j < kRun / 4; ++j) {
          const float4 qq = q4[j];
          s[m] = fmaf(qq.x, kv[4 * j], s[m]);
          s[m] = fmaf(qq.y, kv[4 * j + 1], s[m]);
          s[m] = fmaf(qq.z, kv[4 * j + 2], s[m]);
          s[m] = fmaf(qq.w, kv[4 * j + 3], s[m]);
        }
      }
    }
    const float ksc = kQuant ? ksb[row] : 1.f;
    const float vsc = kQuant ? vsb[row] : 1.f;
    float ev[MQ];
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      float sm = s[m] * a.scale;
      if (kQuant) sm *= ksc;
      sm = live ? sm : attn::kMaskedScore;
      const float m_new = fmaxf(mrun[m], warp_max(sm));
      const float corr = expf(mrun[m] - m_new);
      const float e = live ? expf(sm - m_new) : 0.f;
      z[m] = z[m] * corr + warp_sum(e);
      mrun[m] = m_new;
      ev[m] = attn::round_to<T>(kQuant ? e * vsc : e);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[m][i] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float vv[DPL];
      attn::load_run<T, MODE, DPL>(
          vb + (size_t)min(tile + j, n_live - 1) * rb, c_lane, D, vv);
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        const float e = __shfl_sync(0xffffffffu, ev[m], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[m][i] = fmaf(e, vv[i], acc[m][i]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    if (lane == 0) {
      wm[warp * MQ + m] = mrun[m];
      wz[warp * MQ + m] = z[m];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      wacc[(warp * MQ + m) * HD + lane * DPL + i] = acc[m][i];
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < mq * HD; i += kThreads) {
    const int m = i / HD, d = i % HD;
    float mx = attn::kMaskedScore;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * MQ + m]);
    float zt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * MQ + m] - mx);
      zt = fmaf(wz[w * MQ + m], f, zt);
      at = fmaf(wacc[(w * MQ + m) * HD + d], f, at);
    }
    out[((size_t)b * a.NH + m * a.KVH + g) * HD + d] =
        attn::from_float<T>(at / fmaxf(zt, 1e-30f));
  }
}

template <typename T, int MODE, int DPL, int MQ>
cudaError_t launch(const Args& a, int B, int mq, cudaStream_t stream) {
  constexpr int HD = 32 * DPL;
  const size_t smem = sizeof(float) * (size_t)MQ * (HD + 2 * kWarps + kWarps * HD);
  auto kernel = decode_attn_kernel<T, MODE, DPL, MQ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.KVH, B), kThreads, smem, stream>>>(a, mq);
  return cudaGetLastError();
}

// the group's query heads, rounded up to a power of two (MQ)
template <typename T, int MODE, int DPL>
cudaError_t launch_mq(const Args& a, int B, int mq, cudaStream_t s) {
  if (mq <= 1) return launch<T, MODE, DPL, 1>(a, B, mq, s);
  if (mq <= 2) return launch<T, MODE, DPL, 2>(a, B, mq, s);
  if (mq <= 4) return launch<T, MODE, DPL, 4>(a, B, mq, s);
  return launch<T, MODE, DPL, 8>(a, B, mq, s);
}

template <typename T, int MODE>
cudaError_t launch_hd(const Args& a, int B, int HD, int mq, cudaStream_t s) {
  switch (HD) {
    case 64: return launch_mq<T, MODE, 2>(a, B, mq, s);
    case 128: return launch_mq<T, MODE, 4>(a, B, mq, s);
    case 256: return launch_mq<T, MODE, 8>(a, B, mq, s);
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
// dtype: 0 = float32, 1 = bfloat16; HD in {64, 128, 256}; NH / KVH <= 8.
// kn == null runs without a fresh row (then vn, kns, vns are ignored).
// Returns a cudaError_t.
int decode_attn_launch(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* pos,
                       const void* kn, const void* vn, const float* kns,
                       const float* vns, void* out, int B, int NH, int KVH,
                       int HD, int Tc, int W, int mode, int dtype, int device,
                       void* stream) {
  if (KVH <= 0 || NH % KVH || NH / KVH > kMaxMq || W > Tc || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, static_cast<const char*>(k), static_cast<const char*>(v), ks, vs,
         pos, static_cast<const char*>(kn), static_cast<const char*>(vn), kns,
         vns, out, NH, KVH, Tc, W, (float)(1.0 / sqrt((double)HD))};
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
