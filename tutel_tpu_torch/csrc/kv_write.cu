// One decode step's KV-cache writes, every tensor in one launch (K8).
//
// Replaces the Pallas kernel `write_step` (tutel_tpu/ops/kv_write_pallas.py
// :146, body `_rmw_kernel` :46). For every batch row b with 0 <= pos[b] < T:
//   row cache i:  cache[b, pos[b], :] = src[b, :]     ([B, T, D] caches)
//   col cache j:  cache[b, :, pos[b]] = src[b, :]     ([B, H, T] caches)
// in place. Rows whose pos is outside [0, T) are left alone, as an XLA
// scatter drops an out-of-range update.
//
// What bounds it on an H100: the bytes are tiny (one row per tensor per
// batch row: 135 KB a step at 64 rows x 4 layers x {K, V int8 [.., 256],
// K/V scales f32 [.., 2]}), so the bound is launch latency, not memory.
// One launch for all tensors is the point.
//
// Design: the TPU kernel's 8-row / 128-lane read-modify-write windows were
// a workaround for Mosaic, which cannot address one row of a tiled memref;
// here the write is a direct scatter. The host passes a table of tensor
// descriptors by value (kernel parameter space, no copy to the device);
// block (b, i) copies tensor i's fresh row b. A row copy moves 16-byte
// words when the row width and both addresses allow it, else bytes; a
// column copy writes H strided elements.
//
// The launch record (ops/kv_write.py): a Head, the n caches' CacheDescs
// (packed once per set of caches by the prepared writer), then the n
// fresh tensors' addresses (packed every step).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 128;

struct Desc {
  char* cache;        // [B, T, width] (row) or [B, width, T] (col)
  const char* src;    // [B, width]
  int kind;           // 0 = row cache, 1 = col cache
  int itemsize;       // bytes per element: 1, 2 or 4
  int t;              // cache length T
  int width;          // D (row) or H (col)
};

struct Table {
  Desc d[kMaxTensors];
};

struct Head {                   // ops/kv_write.py _HEAD
  void* stream;
  const int* pos;               // device int32 [B]
  int n, B, device, pad;
};
struct CacheDesc {              // ops/kv_write.py _CACHE
  char* cache;
  int kind, itemsize, t, width;
};
static_assert(offsetof(Head, pos) == 8, "record layout");
static_assert(offsetof(Head, n) == 16, "record layout");
static_assert(offsetof(Head, device) == 24, "record layout");
static_assert(sizeof(Head) == 32, "record layout");
static_assert(offsetof(CacheDesc, kind) == 8, "record layout");
static_assert(offsetof(CacheDesc, width) == 20, "record layout");
static_assert(sizeof(CacheDesc) == 24, "record layout");

__device__ __forceinline__ void copy_elem(char* dst, const char* src,
                                          int itemsize) {
  if (itemsize == 4)
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  else if (itemsize == 2)
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  else
    *dst = *src;
}

__global__ void __launch_bounds__(kThreads)
kv_write_kernel(const Table table, const int* __restrict__ pos) {
  const int b = blockIdx.x;
  const Desc d = table.d[blockIdx.y];
  const int p = pos[b];
  if (p < 0 || p >= d.t) return;
  const size_t row_bytes = (size_t)d.width * d.itemsize;
  const char* src = d.src + (size_t)b * row_bytes;
  if (d.kind == 0) {
    char* dst = d.cache + ((size_t)b * d.t + p) * row_bytes;
    const bool vec = row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0;
    if (vec) {
      const int n = (int)(row_bytes / 16);
      for (int i = threadIdx.x; i < n; i += kThreads)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (size_t i = threadIdx.x; i < row_bytes; i += kThreads) dst[i] = src[i];
    }
  } else {
    for (int h = threadIdx.x; h < d.width; h += kThreads) {
      char* dst = d.cache + (((size_t)b * d.width + h) * d.t + p) * d.itemsize;
      copy_elem(dst, src + (size_t)h * d.itemsize, d.itemsize);
    }
  }
}

}  // namespace

extern "C" {

// record: a Head, then n CacheDescs, then n source addresses (each [B,
// width] on the device), n <= 64. Switches to the record's device only
// when it must, and back. Returns a cudaError_t (cudaErrorInvalidValue
// for a table it does not take).
int kv_write_launch(const char* record) {
  const Head* h = reinterpret_cast<const Head*>(record);
  const int n = h->n;
  if (n <= 0 || n > kMaxTensors || h->B <= 0)
    return (int)cudaErrorInvalidValue;
  const CacheDesc* c = reinterpret_cast<const CacheDesc*>(record + sizeof(Head));
  const char* const* src =
      reinterpret_cast<const char* const*>(record + sizeof(Head) + n * sizeof(CacheDesc));
  Table table;
  for (int i = 0; i < n; ++i) {
    const int is = c[i].itemsize;
    if ((is != 1 && is != 2 && is != 4) || (c[i].kind != 0 && c[i].kind != 1))
      return (int)cudaErrorInvalidValue;
    table.d[i] = Desc{c[i].cache, src[i], c[i].kind, is, c[i].t, c[i].width};
  }
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (caller != h->device && (err = cudaSetDevice(h->device)) != cudaSuccess)
    return (int)err;
  kv_write_kernel<<<dim3(h->B, n), kThreads, 0,
                    static_cast<cudaStream_t>(h->stream)>>>(table, h->pos);
  err = cudaGetLastError();
  if (caller != h->device) cudaSetDevice(caller);
  return (int)err;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
