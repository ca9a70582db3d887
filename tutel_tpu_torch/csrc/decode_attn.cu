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
// position and group) is far below the card's rate, but its issue is not:
// 1,024 FMAs and 256 widened values per (position, group) are 48 warp
// instructions at the least, 12 us at 1.98 GHz.
//
// Design (flash-decoding). The grid is (group g, batch row b, slice s):
// slice s of S covers a contiguous run of the window's 32-position tiles
// (`slice_tiles`, mirrored by ops/decode_attn.py split_slices), and
// ops/decode_attn.py split_plan picks S from B, KVH, the window and the SM
// count: the most slices whose blocks fit one wave at the block's
// residency, S = 1 where B * KVH blocks already fill the card. Row b
// reads only its live positions (pos[b] is a device value): a block whose
// slice starts past them writes a neutral partial (m = -1e30, z = 0,
// acc = 0) and returns.
// The fresh row is folded in once, by slice 0.
//
// A block has up to 4 warps (fewer where 4 warps' buffers do not fit in
// shared memory). Warp w walks tiles w, w + nw, ... of its slice through
// its own double-buffered cp.async pipeline: the tile's K and V rows of
// group g (neighbouring lanes on neighbouring 16 bytes) and their scales
// land in shared memory while the warp computes on the previous tile.
// Within a warp, LP = HD / DL lanes share a position and each owns DL
// dims (16, or 8 with 8 query heads a group; fewer at HD 16 and 32, see
// Lanes), so q stays in registers and a lane reads a staged row as one
// chunk of DL values (16 bytes of INT8 at DL 16): the
// warp covers 32 / LP positions an instruction, each lane LP positions a
// tile, 8 at a time. A position's MQ partial dots are summed over its LP
// lanes by a reduce-scatter (lane r keeps head rs_owner(r): 4 shuffles
// for 4 heads over 8 lanes, not 12), so the softmax works on one
// (position, head) a lane. The warp takes the max of its 8-position steps
// by shuffles and keeps its online softmax state (running max and sums
// per head, acc [MQ][DL] a lane over its positions); the weights, rounded
// to q's type against the running max, reach the combine of the V rows by
// shuffles from the lanes that own their heads. At the end the position
// groups, then the warps,
// merge their states. With S = 1 the
// block writes out; else it writes float32 partials (acc
// [B, KVH, S, mq, HD] unnormalised, m and z [B, KVH, S, mq]) to a
// workspace the wrapper allocates, and decode_attn_merge, one block per
// (g, b), merges them in slice order: no atomics, so a result is bitwise
// repeatable. Both kernels launch from the one C entry.
//
// Quantized values become floats with a byte permute (and a mask for a
// nibble) and one subtraction, 2^23 + u - (2^23 + bias), instead of an
// int-to-float conversion, which issues at a quarter of the FMA rate.
//
// The shuffles must run where the compiler can prove the warp converged,
// or it turns each into a slow warp-collective sequence: so the number of
// query heads per group is a template parameter (rounded up to 1, 2, 4 or
// 8, with zero heads as padding), every warp of a block runs the same
// number of tiles (a tile past the slice's live positions is zero-filled
// and masked), and a tile's body has no branch. The TPU kernel's
// block-diagonal q packing (a device for its matrix unit) and its window
// chunk ladder are not needed. CUDA cores only; no tensor cores.

#include <algorithm>
#include <cmath>
#include <cstddef>

#include "attn_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async4;
using attn::cp_async8;
using attn::smem_u32;

constexpr int kWarps = 4;                // warps of a block, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                // positions of a warp's tile
constexpr int kMaxMq = 8;                // query heads per KV group, at most
constexpr int kMaxSplit = 256;           // slices of a window, at most
constexpr size_t kSmemBlock = 232448;    // shared memory a block can use
constexpr int kStages = 2;               // a warp's tiles in its pipeline

// How a warp covers a tile: DL dims a lane, LP lanes a position, PPW
// positions an instruction, NP = LP positions a lane. DL is 16 (8 with 8
// query heads a group), and smaller at HD 16 and 32 so that a position's
// LP lanes still hold its MQ heads; an INT4 row at HD 16 takes DL <= 8,
// since with an odd KVH a group's 16 values straddle the packed row's
// halves (the low nibbles of its first 8 bytes, then the high nibbles).
template <int MODE, int HD, int MQ> struct Lanes {
  static constexpr int kBase = MQ <= 4 ? 16 : 8;
  static constexpr int kCap = MODE == 2 && HD == 16 ? 8 : 16;
  static constexpr int DL = kBase < HD / MQ
      ? (kBase < kCap ? kBase : kCap)
      : (HD / MQ < kCap ? HD / MQ : kCap);
  static constexpr int LP = HD / DL;
  static constexpr int PPW = 32 / LP;
  static constexpr int NP = kTile / PPW;
  static_assert(LP >= MQ && LP <= 32, "a position's lanes hold its heads");
  static_assert(DL >= 2 && HD % DL == 0, "a lane's run of dims");
};

// The launch record (ops/decode_attn.py _RECORD): every pointer, then
// every int, in one struct the wrapper packs with struct.pack.
struct Record {
  const void* q;                 // [B, NH, HD] of T
  const void* k;                 // [B, Tc, row] stored
  const void* v;
  const float* ks;               // [B, KVH, Tc] or null (float cache)
  const float* vs;
  const int* pos;                // [B]
  const void* kn;                // [B, row] stored, or null (no fresh row)
  const void* vn;
  const float* kns;              // [B, KVH] or null
  const float* vns;
  void* out;                     // [B, NH, HD] of T
  float* ws;                     // split > 1: the partials (see the top)
  void* stream;
  int B, NH, KVH, HD, Tc, W, mode, dtype, split, device;
};
static_assert(offsetof(Record, q) == 0, "record layout");
static_assert(offsetof(Record, out) == 80, "record layout");
static_assert(offsetof(Record, ws) == 88, "record layout");
static_assert(offsetof(Record, stream) == 96, "record layout");
static_assert(offsetof(Record, B) == 104, "record layout");
static_assert(offsetof(Record, split) == 136, "record layout");
static_assert(offsetof(Record, device) == 140, "record layout");
static_assert(sizeof(Record) == 144, "record layout");

struct Args {
  const void* q;
  const char* k;
  const char* v;
  const float* ks;
  const float* vs;
  const int* pos;
  const char* kn;
  const char* vn;
  const float* kns;
  const float* vns;
  void* out;
  float* ws;
  int B, NH, KVH, Tc, W, split, mq;
  int row;                       // bytes a staged row holds (staged_row)
  float scale;
};

// Tiles [t0, t1) of slice s of `split` over n tiles, dealt out evenly and
// in order (ops/decode_attn.py split_slices).
__host__ __device__ __forceinline__ void slice_tiles(int n, int split, int s,
                                                     int& t0, int& t1) {
  t0 = (int)((long long)s * n / split);
  t1 = (int)((long long)(s + 1) * n / split);
}

// Bytes [lo, lo + nb) of a stored row hold group g's HD values. INT4
// (split-half packing): a group lies in the low or the high nibbles of HD
// bytes, except with one group (both nibbles of HD / 2 bytes) and the
// middle group of an odd KVH > 1 (the whole packed row).
template <typename T, int MODE>
__host__ __device__ __forceinline__ void group_bytes(int g, int KVH, int HD,
                                                     int& lo, int& nb) {
  if constexpr (MODE != 2) {
    lo = g * HD * attn::Storage<T, MODE>::kBytes;
    nb = HD * attn::Storage<T, MODE>::kBytes;
  } else {
    const int half = KVH * HD / 2, c0 = g * HD;
    if (c0 + HD <= half) { lo = c0; nb = HD; }
    else if (c0 >= half) { lo = c0 - half; nb = HD; }
    else { lo = 0; nb = half; }
  }
}

// The largest group_bytes of a cache: the row stride of a staged tile
// (mirrored by kernel_geometry in tests/test_torch_attn_split.py).
template <typename T, int MODE>
__host__ __forceinline__ int staged_row(int KVH, int HD) {
  if constexpr (MODE == 2) return KVH % 2 == 0 ? HD : KVH * HD / 2;
  return HD * attn::Storage<T, MODE>::kBytes;
}

// Shared memory of one warp: kStages stages of a K tile, a V tile and
// both tiles' scales.
__host__ __device__ __forceinline__ size_t stage_bytes(int row) {
  return (size_t)kTile * 2 * row + 2 * kTile * sizeof(float);
}

// N values of a staged row starting at logical column c0 (of the cache's
// D), as floats; the row holds the stored bytes [lo, lo + nb).
template <typename T, int MODE, int N>
__device__ __forceinline__ void load_staged(const char* row, int c0, int D,
                                            int lo, float* out) {
  constexpr int kBytes = N * attn::Storage<T, MODE>::kBytes;
  uint32_t w[(kBytes + 3) / 4];
  if constexpr (MODE == 2) {
    const int half = D / 2;
    const bool high = c0 >= half;
    attn::load_words<kBytes>(row + (high ? c0 - half : c0) - lo, w);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      // nibble u = value + 8 in the low 4 bits of byte i % 4
      const uint32_t x = (w[i / 4] ^ 0x88888888u) >> (high ? 4 : 0);
      out[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | (i % 4)) &
                               0x4B00000Fu) - 8388616.f;
    }
  } else if constexpr (MODE == 1) {
    attn::load_words<kBytes>(row + c0 - lo, w);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t x = w[i / 4] ^ 0x80808080u;     // byte u = value + 128
      out[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | (i % 4))) -
               8388736.f;
    }
  } else {
    attn::load_run<T, 0, N>(row - lo, c0, D, out);
  }
}

// Sums v[0..N) over the lanes whose index differs in bits O, O / 2, ...,
// 1 (a position's lanes): while N > 1 a lane keeps half of its values and
// adds its partner's other half, then the lanes butterfly. Returns the
// sum of value rs_owner<O, N>(lane) (the others are spent).
template <int O, int N>
__device__ __forceinline__ float rs_sum(float* v, int lane) {
  if constexpr (O == 0) {
    return v[0];
  } else if constexpr (N == 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return rs_sum<O / 2, 1>(v, lane);
  } else {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return rs_sum<O / 2, N / 2>(v, lane);
  }
}
template <int O, int N>
__host__ __device__ constexpr int rs_owner(int r) {
  if constexpr (O == 0 || N == 1) return 0;
  else return ((r & O) ? N / 2 : 0) + rs_owner<O / 2, N / 2>(r);
}
// the first of a position's lanes that keeps head m
template <int LP, int MQ>
__host__ __device__ constexpr int rs_lane(int m) {
  int r = 0;
  while (rs_owner<LP / 2, MQ>(r) != m) ++r;
  return r;
}

template <typename T, int MODE, int HD, int MQ>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const Args a) {
  using L = Lanes<MODE, HD, MQ>;
  constexpr int DL = L::DL, LP = L::LP, PPW = L::PPW,
                NP = L::NP, NPS = NP < 8 ? NP : 8;
  constexpr bool kQuant = MODE != 0;
  extern __shared__ __align__(16) char smem[];

  const int g = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % LP, pg = lane / LP;        // dims, position group
  const int my_m = rs_owner<LP / 2, MQ>(sub);       // the head this lane keeps
  const int base = lane - sub;                      // the group's first lane
  const int D = a.KVH * HD;
  const size_t rb = attn::row_bytes<T, MODE>(D);
  const bool fresh = a.kn != nullptr && s == 0;
  const int p = a.pos[b];
  const int n_live = max(0, min(a.kn != nullptr ? p : p + 1, a.W));
  int t0, t1;
  slice_tiles((a.W + kTile - 1) / kTile, a.split, s, t0, t1);
  const int end = min(n_live, t1 * kTile);           // positions < end
  const int count = max(0, (end + kTile - 1) / kTile - t0);
  const size_t pair = (size_t)b * a.KVH + g;
  const int mq = a.mq;

  if (count == 0 && !fresh && a.split > 1) {       // a neutral partial
    float* acc = a.ws + (pair * a.split + s) * mq * HD;
    for (int i = threadIdx.x; i < mq * HD; i += blockDim.x) acc[i] = 0.f;
    const size_t parts = (size_t)a.B * a.KVH * a.split * mq;
    float* pm = a.ws + parts * HD + (pair * a.split + s) * mq;
    for (int m = threadIdx.x; m < mq; m += blockDim.x) {
      pm[m] = attn::kMaskedScore;
      pm[parts + m] = 0.f;
    }
    return;
  }

  // this warp's buffers: two stages of {K [kTile][row], V [kTile][row],
  // K scales, V scales}
  int lo, nb;
  group_bytes<T, MODE>(g, a.KVH, HD, lo, nb);
  // a compile-time stride but for INT4, whose staged row depends on KVH
  const int row = MODE == 2 ? a.row : HD * attn::Storage<T, MODE>::kBytes;
  const size_t stage = stage_bytes(row);
  char* wbuf = smem + warp * kStages * stage;
  const char* kb = a.k + (size_t)b * a.Tc * rb + lo;
  const char* vb = a.v + (size_t)b * a.Tc * rb + lo;
  const float* ksb = kQuant ? a.ks + pair * a.Tc : nullptr;
  const float* vsb = kQuant ? a.vs + pair * a.Tc : nullptr;
  // the row's copy chunks: 16 bytes, but 8 for INT4 at HD 16, whose rows
  // (8 * KVH bytes) are 16-byte aligned only with an even KVH
  constexpr int CB = MODE == 2 && HD == 16 ? 8 : 16;
  const int cpr = nb / CB;                            // chunks a row
  const uint32_t cpr_inv = 0xffffffffu / cpr + 1;     // c / cpr = umulhi

  // copy this warp's i-th tile into stage st; positions past `end`
  // (and a tile past the slice) are zero-filled, reading nothing
  auto issue = [&](int i, int st) {
    const int tile = (t0 + i * nw + warp) * kTile;
    char* kd = wbuf + st * stage;
    char* vd = kd + kTile * row;
    for (int c = lane; c < kTile * cpr; c += 32) {
      const int r = MODE == 2 ? (int)__umulhi(c, cpr_inv) : c / cpr;
      const int ch = c - r * cpr;
      const bool ok = tile + r < end;
      const size_t off = (size_t)(ok ? tile + r : 0) * rb + ch * CB;
      if constexpr (CB == 16) {
        cp_async16(smem_u32(kd + r * row + ch * CB), kb + off, ok);
        cp_async16(smem_u32(vd + r * row + ch * CB), vb + off, ok);
      } else {
        cp_async8(smem_u32(kd + r * row + ch * CB), kb + off, ok);
        cp_async8(smem_u32(vd + r * row + ch * CB), vb + off, ok);
      }
    }
    if constexpr (kQuant) {
      float* sd = reinterpret_cast<float*>(vd + kTile * row);
      const bool ok = tile + lane < end;
      cp_async4(smem_u32(sd + lane), ksb + (ok ? tile + lane : 0), ok);
      cp_async4(smem_u32(sd + kTile + lane), vsb + (ok ? tile + lane : 0), ok);
    }
    attn::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)   // in flight while q and the fresh
    issue(i, i);                          // row load

  // this lane's dims of the group's query heads (m >= mq: zero padding)
  const T* q = static_cast<const T*>(a.q);
  const int c_lane = g * HD + sub * DL;               // this lane's dims
  float qv[MQ][DL];
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    if (m < mq) {
      attn::load_run<T, 0, DL>(reinterpret_cast<const char*>(
          q + ((size_t)b * a.NH + m * a.KVH + g) * HD), sub * DL, HD, qv[m]);
    } else {
#pragma unroll
      for (int i = 0; i < DL; ++i) qv[m][i] = 0.f;
    }
  }

  // online softmax state: the running max and sum of head my_m (a lane's
  // sum covers its positions), acc over this lane's dims and positions
  float mrun = attn::kMaskedScore, z = 0.f, acc[MQ][DL];
#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[m][i] = 0.f;
  if (fresh) {             // every warp scores it; warp 0 keeps it
    float kv[DL], vv[DL], part[MQ];
    attn::load_run<T, MODE, DL>(a.kn + b * rb, c_lane, D, kv);
    attn::load_run<T, MODE, DL>(a.vn + b * rb, c_lane, D, vv);
    const float ksn = kQuant ? a.kns[b * a.KVH + g] : 1.f;
    const float vsn = kQuant ? a.vns[b * a.KVH + g] : 1.f;
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      part[m] = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) part[m] = fmaf(qv[m][i], kv[i], part[m]);
    }
    float sn = rs_sum<LP / 2, MQ>(part, lane) * a.scale;
    if (kQuant) sn *= ksn;
    if (warp == 0) {
      mrun = sn;
      z = pg == 0 ? 1.f : 0.f;          // the groups' sums add up at the end
#pragma unroll
      for (int m = 0; m < MQ; ++m)
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[m][i] = pg == 0 ? vsn * vv[i] : 0.f;
    }
  }

  const int n_iter = (count + nw - 1) / nw;           // the same for every warp
  for (int it = 0; it < n_iter; ++it) {
    issue(it + kStages - 1, (it + kStages - 1) % kStages);
    attn::cp_async_wait<kStages - 1>();
    __syncwarp();
    const char* kt = wbuf + (it % kStages) * stage;
    const char* vt = kt + kTile * row;
    const float* sc = reinterpret_cast<const float*>(vt + kTile * row);
    const int tile = (t0 + it * nw + warp) * kTile;

    // NPS positions a lane at a time (a bounded unrolled body): scores of
    // position j * PPW + pg of the tile for head my_m, the online softmax
    // step, the combine
#pragma unroll 1
    for (int h = 0; h < NP; h += NPS) {
      float sj[NPS];
#pragma unroll
      for (int j = 0; j < NPS; ++j) {
        const int r = (h + j) * PPW + pg;
        float kv[DL], part[MQ];
        load_staged<T, MODE, DL>(kt + r * row, c_lane, D, lo, kv);
#pragma unroll
        for (int m = 0; m < MQ; ++m) {
          part[m] = 0.f;
#pragma unroll
          for (int i = 0; i < DL; ++i) part[m] = fmaf(qv[m][i], kv[i], part[m]);
        }
        float x = rs_sum<LP / 2, MQ>(part, lane) * a.scale;
        if (kQuant) x *= sc[r];
        sj[j] = tile + r < end ? x : attn::kMaskedScore;
      }
      float mx = sj[0];
#pragma unroll
      for (int j = 1; j < NPS; ++j) mx = fmaxf(mx, sj[j]);
#pragma unroll
      for (int o = LP; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(mrun, mx);
      const float corr = expf(mrun - m_new);
      mrun = m_new;
      float zt = 0.f;
#pragma unroll
      for (int j = 0; j < NPS; ++j) {       // sj becomes the rounded weight
        const int r = (h + j) * PPW + pg;
        const float e = tile + r < end ? expf(sj[j] - m_new) : 0.f;
        zt += e;
        sj[j] = attn::round_to<T>(kQuant ? e * sc[kTile + r] : e);
      }
      z = z * corr + zt;
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        const float cm = __shfl_sync(0xffffffffu, corr,
                                     base + rs_lane<LP, MQ>(m));
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[m][i] *= cm;
      }
#pragma unroll
      for (int j = 0; j < NPS; ++j) {
        float vv[DL];
        load_staged<T, MODE, DL>(vt + ((h + j) * PPW + pg) * row, c_lane, D,
                                 lo, vv);
#pragma unroll
        for (int m = 0; m < MQ; ++m) {
          const float e = __shfl_sync(0xffffffffu, sj[j],
                                      base + rs_lane<LP, MQ>(m));
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[m][i] = fmaf(e, vv[i], acc[m][i]);
        }
      }
    }
    __syncwarp();
  }
  attn::cp_async_wait<0>();       // the last (empty) stage's zero fill
  __syncthreads();                // the stages become the merge area

  // the position groups' sums, then the warps' states through shared memory
#pragma unroll
  for (int o = LP; o < 32; o <<= 1) {
    z += __shfl_xor_sync(0xffffffffu, z, o);
#pragma unroll
    for (int m = 0; m < MQ; ++m)
#pragma unroll
      for (int i = 0; i < DL; ++i)
        acc[m][i] += __shfl_xor_sync(0xffffffffu, acc[m][i], o);
  }
  float* wm = reinterpret_cast<float*>(smem);        // [nw][MQ]
  float* wz = wm + nw * MQ;                          // [nw][MQ]
  float* wacc = wz + nw * MQ;                        // [nw][MQ][HD]
  if (lane < LP) {
    if (sub == rs_lane<LP, MQ>(my_m)) {
      wm[warp * MQ + my_m] = mrun;
      wz[warp * MQ + my_m] = z;
    }
#pragma unroll
    for (int m = 0; m < MQ; ++m)
#pragma unroll
      for (int i = 0; i < DL; ++i)
        wacc[(warp * MQ + m) * HD + sub * DL + i] = acc[m][i];
  }
  __syncthreads();

  // each warp's weight exp(m_w - max) and the sum z, once per head
  float* wf = wacc + nw * MQ * HD;                   // [nw][MQ]
  float* wmax = wf + nw * MQ;                        // [MQ]
  float* wzt = wmax + MQ;                            // [MQ]
  if (threadIdx.x < mq) {
    const int m = threadIdx.x;
    float mx = attn::kMaskedScore;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, wm[w * MQ + m]);
    float zt = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float f = expf(wm[w * MQ + m] - mx);
      wf[w * MQ + m] = f;
      zt = fmaf(wz[w * MQ + m], f, zt);
    }
    wmax[m] = mx;
    wzt[m] = zt;
  }
  __syncthreads();

  const size_t parts = (size_t)a.B * a.KVH * a.split * mq;
  for (int i = threadIdx.x; i < mq * HD; i += blockDim.x) {
    const int m = i / HD, d = i % HD;
    float at = 0.f;
    for (int w = 0; w < nw; ++w)
      at = fmaf(wacc[(w * MQ + m) * HD + d], wf[w * MQ + m], at);
    if (a.split == 1) {
      static_cast<T*>(a.out)[((size_t)b * a.NH + m * a.KVH + g) * HD + d] =
          attn::from_float<T>(at / fmaxf(wzt[m], 1e-30f));
    } else {
      const size_t part = (pair * a.split + s) * mq + m;
      a.ws[part * HD + d] = at;
      if (d == 0) {
        a.ws[parts * HD + part] = wmax[m];
        a.ws[parts * HD + parts + part] = wzt[m];
      }
    }
  }
}

// The S partials of every (g, b), merged in slice order. The slices' m
// and z land in shared memory first (one load each, all at once); their
// weights exp(m_s - max) and the sum z come next, once per head; then
// thread d sums dims d, d + blockDim.x, ... of every head over the
// slices, loads independent of each other.
template <typename T, int HD, int MQ>
__global__ void __launch_bounds__(kThreads)
decode_attn_merge(const float* __restrict__ ws, T* __restrict__ out, int B,
                  int NH, int KVH, int split, int mq) {
  __shared__ float wf[kMaxSplit * MQ];       // [split][MQ]: m, then weights
  __shared__ float zs[kMaxSplit * MQ];       // [split][MQ]
  __shared__ float wz[MQ];
  const int g = blockIdx.x, b = blockIdx.y;
  const size_t pair = (size_t)b * KVH + g;
  const size_t parts = (size_t)B * KVH * split * mq;
  const float* acc = ws + pair * split * mq * HD;
  const float* pm = ws + parts * HD + pair * split * mq;
  for (int i = threadIdx.x; i < split * mq; i += blockDim.x) {
    wf[i / mq * MQ + i % mq] = pm[i];
    zs[i / mq * MQ + i % mq] = pm[parts + i];
  }
  __syncthreads();
  if (threadIdx.x < mq) {
    const int m = threadIdx.x;
    float mx = attn::kMaskedScore;
    for (int s = 0; s < split; ++s) mx = fmaxf(mx, wf[s * MQ + m]);
    float zt = 0.f;
    for (int s = 0; s < split; ++s) {
      const float f = expf(wf[s * MQ + m] - mx);
      wf[s * MQ + m] = f;
      zt = fmaf(zs[s * MQ + m], f, zt);
    }
    wz[m] = fmaxf(zt, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    if (m >= mq) break;
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      float at = 0.f;
#pragma unroll 8
      for (int s = 0; s < split; ++s)
        at = fmaf(acc[((size_t)s * mq + m) * HD + d], wf[s * MQ + m], at);
      out[((size_t)b * NH + m * KVH + g) * HD + d] =
          attn::from_float<T>(at / wz[m]);
    }
  }
}

// Warps of a block and its dynamic shared memory: the warps' buffers or,
// after the loop, the merge of their states in the same bytes (mirrored
// by kernel_geometry in tests/test_torch_attn_split.py).
inline void block_shape(int row, int HD, int MQ, int& warps, size_t& smem) {
  warps = (int)std::min<size_t>(kWarps,
                                kSmemBlock / (kStages * stage_bytes(row)));
  const size_t merge = sizeof(float) * (warps * MQ * (HD + 3) + 2 * MQ);
  smem = std::max(warps * kStages * stage_bytes(row), merge);
}

// Launch the instance on `stream`, or with `blocks` set, write how many of
// its blocks an SM holds at once instead (the split plan's residency).
template <typename T, int MODE, int HD, int MQ>
cudaError_t launch(const Record& r, cudaStream_t stream, int* blocks) {
  const int row = staged_row<T, MODE>(r.KVH, HD);
  int warps;
  size_t smem;
  block_shape(row, HD, MQ, warps, smem);
  if (warps < 1) return cudaErrorInvalidValue;
  auto kernel = decode_attn_kernel<T, MODE, HD, MQ>;
  // the attributes are set once per device: the most dynamic shared
  // memory, and the SM's whole carveout as shared memory
  static bool wide[64] = {};
  if (smem > 48 * 1024 && !(r.device < 64 && wide[r.device])) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBlock);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (r.device < 64) wide[r.device] = true;
  }
  if (blocks)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         32 * warps, smem);
  const Args a{r.q, static_cast<const char*>(r.k), static_cast<const char*>(r.v),
               r.ks, r.vs, r.pos, static_cast<const char*>(r.kn),
               static_cast<const char*>(r.vn), r.kns, r.vns, r.out, r.ws,
               r.B, r.NH, r.KVH, r.Tc, r.W, r.split, r.NH / r.KVH, row,
               (float)(1.0 / sqrt((double)HD))};
  kernel<<<dim3(r.KVH, r.B, r.split), 32 * warps, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || r.split == 1) return err;
  decode_attn_merge<T, HD, MQ><<<dim3(r.KVH, r.B), kThreads, 0, stream>>>(
      r.ws, static_cast<T*>(r.out), r.B, r.NH, r.KVH, r.split, r.NH / r.KVH);
  return cudaGetLastError();
}

// the group's query heads, rounded up to a power of two (MQ)
template <typename T, int MODE, int HD>
cudaError_t launch_mq(const Record& r, cudaStream_t s, int* blocks) {
  const int mq = r.NH / r.KVH;
  if (mq <= 1) return launch<T, MODE, HD, 1>(r, s, blocks);
  if (mq <= 2) return launch<T, MODE, HD, 2>(r, s, blocks);
  if (mq <= 4) return launch<T, MODE, HD, 4>(r, s, blocks);
  return launch<T, MODE, HD, 8>(r, s, blocks);
}

template <typename T, int MODE>
cudaError_t launch_hd(const Record& r, cudaStream_t s, int* blocks) {
  switch (r.HD) {
    case 16: return launch_mq<T, MODE, 16>(r, s, blocks);
    case 32: return launch_mq<T, MODE, 32>(r, s, blocks);
    case 64: return launch_mq<T, MODE, 64>(r, s, blocks);
    case 128: return launch_mq<T, MODE, 128>(r, s, blocks);
    case 256: return launch_mq<T, MODE, 256>(r, s, blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mode(const Record& r, cudaStream_t s, int* blocks) {
  switch (r.mode) {
    case 0: return launch_hd<T, 0>(r, s, blocks);
    case 1: return launch_hd<T, 1>(r, s, blocks);
    case 2: return launch_hd<T, 2>(r, s, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Validate a record, switch to its device only when it must, run, switch
// back.
int run(const char* record, int* blocks) {
  const Record* r = reinterpret_cast<const Record*>(record);
  const int n_tiles = (r->W + kTile - 1) / kTile;
  if (r->KVH <= 0 || r->NH % r->KVH || r->NH / r->KVH > kMaxMq ||
      r->W > r->Tc || r->B <= 0 || r->split < 1 || r->split > kMaxSplit ||
      r->split > std::max(n_tiles, 1) || (r->split > 1 && !r->ws && !blocks))
    return (int)cudaErrorInvalidValue;
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (caller != r->device && (err = cudaSetDevice(r->device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(r->stream);
  err = r->dtype == 1 ? launch_mode<__nv_bfloat16>(*r, s, blocks)
                      : launch_mode<float>(*r, s, blocks);
  if (caller != r->device) cudaSetDevice(caller);
  return (int)err;
}

}  // namespace

extern "C" {

// One launch record (Record; ops/decode_attn.py packs it). mode: 0 =
// float cache (of q's type), 1 = int8, 2 = int4 split-half; dtype: 0 =
// float32, 1 = bfloat16; HD in {16, 32, 64, 128, 256}; NH / KVH <= 8; split >= 1
// slices of the window's tiles (ws holds the partials when split > 1).
// kn == null runs without a fresh row (then vn, kns, vns are ignored).
// Returns a cudaError_t.
int decode_attn_launch(const char* record) { return run(record, nullptr); }

// The blocks an SM holds at once of the kernel instance and block shape a
// record selects (its pointers are not read), into *blocks.
int decode_attn_occupancy(const char* record, int* blocks) {
  return run(record, blocks);
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
