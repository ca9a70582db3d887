// The routing's location scan: each routing's slot inside its expert's
// buffer, and the tokens routed to each expert.
//
// Replaces no TPU kernel. The JAX package computes this with `jnp.cumsum`
// over the k-major [K*S, E] one-hot (tutel_tpu/ops/routing.py
// `compute_locations`), which XLA fuses; the reference had a hand CUDA
// cumsum (`warp_cumsum`). The port's plain form (ops/routing.py
// `compute_locations_reference`) builds that one-hot as int64 and runs
// aten's cumsum over its dim 0, whose kernel walks the rows in series:
// ~200 ms at [8 x 65,536, 64] on an H100. This kernel never builds the
// one-hot.
//
// The stream: routing (k, j), of expert ids[k, j], sits at position
// k * S + r, where j = order[r] under batch-prioritized routing and j = r
// without it. Its location is the number of earlier positions routed to
// the same expert; a masked token (mask[j] == 0) gets location -1 and
// counts nowhere; counts[e] is the number of unmasked routings to e. An
// id outside [0, E) gets location 0 and counts nowhere, as its all-zero
// one-hot row does in the plain form.
//
// What bounds it on an H100: bytes. It reads K*S ids and writes K*S
// locations (8 MB at [8, 65,536]: ~2.5 us at 3.35 TB/s); the ids are a
// strided view of the sort's [S, E] index buffer, read through L2.
//
// Design: a tile of kTile = 4,096 stream positions is one block of 16
// warps; a warp owns 256 consecutive positions, 8 rounds of 32 lanes. In
// a round the lanes of one id find each other with __match_any_sync; a
// lane's rank is its warp's running count of that id plus the lower lanes
// of its group, and the group's lowest lane adds the group's size to the
// count. The block then scans the warps' counts per expert in warp order:
// a position's location is its tile's base for its expert, plus the
// earlier warps' count, plus its rank in the warp.
//   One tile (K*S <= 4,096, as at decode): one launch, base 0, the
//   block's totals are the counts.
//   More tiles: pass 1 writes each tile's per-expert totals, pass 2 scans
//   them over the tiles per expert (each tile's base, and the counts),
//   pass 3 ranks again and writes the locations.
// The warps' counters, 16 x E int32, live in shared memory while they fit
// in 48 KB (E <= 768), else in a slice of the global scratch per tile.
//
// The launch record (ops/routing.py _RECORD): a Record.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 8;                        // positions a lane holds
constexpr int kTile = kThreads * kPer;         // positions a block ranks
constexpr int kSharedInts = 48 * 1024 / 4;     // counters in shared memory
constexpr int kScanThreads = 256;
// keys of positions that take no counter (ids are >= 0)
constexpr int kMasked = -1, kStray = -2, kPast = -3;

struct Record {                // ops/routing.py _RECORD
  void* stream;
  const int64_t* ids;          // [K, S] at (stride_k, stride_s) elements
  const uint8_t* mask;         // [S] bool, or null
  const int64_t* order;        // [S] permutation, or null
  int64_t* locations;          // [K, S] contiguous
  int* counts;                 // [E]
  int* scratch;                // scratch_ints int32, or null
  long long stride_k, stride_s, scratch_ints;
  int k, s, e, device;
};
static_assert(offsetof(Record, stride_k) == 56, "record layout");
static_assert(offsetof(Record, k) == 80, "record layout");
static_assert(sizeof(Record) == 96, "record layout");

struct Args {
  const int64_t* ids;
  const uint8_t* mask;
  const int64_t* order;
  int64_t* locations;
  int* counts;
  int* tile_counts;            // [tiles, E]: totals (pass 1), bases (pass 3)
  int* spill;                  // [tiles, kWarps, E] counters, or null
  long long stride_k, stride_s;
  unsigned s, n;
  int e;
};

enum Pass { kSingle, kCount, kRank };

template <int P>
__global__ void __launch_bounds__(kThreads)
route_tile_kernel(const Args a) {
  extern __shared__ int shared[];
  const int e = a.e;
  int* cnt = a.spill ? a.spill + (size_t)blockIdx.x * kWarps * e : shared;
  for (int i = threadIdx.x; i < kWarps * e; i += kThreads) cnt[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned first = blockIdx.x * kTile + warp * (32 * kPer) + lane;
  int key[kPer];
  unsigned out[kPer];          // k * S + j: the position's output index
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const unsigned p = first + v * 32;
    key[v] = kPast;
    out[v] = 0;
    if (p < a.n) {
      const unsigned k = p / a.s, r = p - k * a.s;
      const unsigned j = a.order ? (unsigned)a.order[r] : r;
      out[v] = k * a.s + j;
      if (a.mask && !a.mask[j]) {
        key[v] = kMasked;
      } else {
        const int64_t id = a.ids[k * a.stride_k + j * a.stride_s];
        key[v] = id >= 0 && id < e ? (int)id : kStray;
      }
    }
  }

  const unsigned lower = (1u << lane) - 1;
  int* mine = cnt + warp * e;
  int rank[kPer];
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int id = key[v];
    const unsigned group = __match_any_sync(0xffffffffu, id);
    rank[v] = id >= 0 ? mine[id] + __popc(group & lower) : 0;
    __syncwarp();
    if (id >= 0 && (group & lower) == 0) mine[id] += __popc(group);
    __syncwarp();
  }
  __syncthreads();

  // per expert: the warps' exclusive prefix (from the tile's base) in
  // place, and the tile's total
  for (int x = threadIdx.x; x < e; x += kThreads) {
    int sum = P == kRank ? a.tile_counts[(size_t)blockIdx.x * e + x] : 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * e + x];
      cnt[w * e + x] = sum;
      sum += c;
    }
    if (P == kCount) a.tile_counts[(size_t)blockIdx.x * e + x] = sum;
    if (P == kSingle) a.counts[x] = sum;
  }
  if (P == kCount) return;
  __syncthreads();

#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int id = key[v];
    if (id == kPast) continue;
    a.locations[out[v]] = id >= 0 ? (int64_t)(mine[id] + rank[v])
                                  : (id == kMasked ? -1 : 0);
  }
}

// Pass 2: per expert, the exclusive scan of the tiles' totals in place
// (each tile's base) and the grand total.
__global__ void __launch_bounds__(kScanThreads)
route_scan_kernel(int* __restrict__ tile_counts, int* __restrict__ counts,
                  int tiles, int e) {
  const int x = blockIdx.x * kScanThreads + threadIdx.x;
  if (x >= e) return;
  int sum = 0;
  for (int t0 = 0; t0 < tiles; t0 += 8) {
    int c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      c[i] = t0 + i < tiles ? tile_counts[(size_t)(t0 + i) * e + x] : 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (t0 + i < tiles) tile_counts[(size_t)(t0 + i) * e + x] = sum;
      sum += c[i];
    }
  }
  counts[x] = sum;
}

// Scratch int32s a stream of n positions over e experts needs.
long long scratch_ints(long long n, int e) {
  const long long tiles = (n + kTile - 1) / kTile;
  return (tiles > 1 ? tiles * e : 0) +
         ((long long)kWarps * e > kSharedInts ? tiles * kWarps * e : 0);
}

}  // namespace

extern "C" {

// One routing's locations and counts (see the top of the file). Switches
// to the record's device only when it must, and back. Returns a
// cudaError_t (cudaErrorInvalidValue for a record it does not take).
int route_locations_launch(const char* record) {
  const Record* r = reinterpret_cast<const Record*>(record);
  const long long n = (long long)r->k * r->s;
  if (r->k <= 0 || r->s <= 0 || r->e <= 0 || n >= (1ll << 31) ||
      !r->ids || !r->locations || !r->counts ||
      r->scratch_ints < scratch_ints(n, r->e) ||
      (r->scratch_ints > 0 && !r->scratch))
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)((n + kTile - 1) / kTile);
  const bool spill = (long long)kWarps * r->e > kSharedInts;
  Args a{r->ids, r->mask, r->order, r->locations, r->counts,
         r->scratch, nullptr, r->stride_k, r->stride_s,
         (unsigned)r->s, (unsigned)n, r->e};
  if (spill) a.spill = r->scratch + (tiles > 1 ? (size_t)tiles * r->e : 0);
  const size_t shared = spill ? 0 : (size_t)kWarps * r->e * sizeof(int);

  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (caller != r->device && (err = cudaSetDevice(r->device)) != cudaSuccess)
    return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(r->stream);
  if (tiles == 1) {
    route_tile_kernel<kSingle><<<1, kThreads, shared, st>>>(a);
    err = cudaGetLastError();
  } else {
    route_tile_kernel<kCount><<<tiles, kThreads, shared, st>>>(a);
    err = cudaGetLastError();
    if (err == cudaSuccess) {
      route_scan_kernel<<<(r->e + kScanThreads - 1) / kScanThreads,
                          kScanThreads, 0, st>>>(r->scratch, r->counts,
                                                 tiles, r->e);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess) {
      route_tile_kernel<kRank><<<tiles, kThreads, shared, st>>>(a);
      err = cudaGetLastError();
    }
  }
  if (caller != r->device) cudaSetDevice(caller);
  return (int)err;
}

// The scratch int32s the record's routing needs, from its k, s and e
// alone (the wrapper allocates them and passes them in the launch's
// record). Returns 0.
int route_locations_scratch(const char* record, long long* ints) {
  const Record* r = reinterpret_cast<const Record*>(record);
  *ints = scratch_ints((long long)r->k * r->s, r->e);
  return 0;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
