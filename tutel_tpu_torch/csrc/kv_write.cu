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

#include <cuda_runtime.h>
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

// desc: host array of n x 6 int64 (cache pointer, source pointer, kind,
// itemsize, T, width), n <= 64; pos: device int32 [B]. Returns a
// cudaError_t (cudaErrorInvalidValue for a table it does not take).
int kv_write_launch(const int64_t* desc, int n, const int* pos, int B,
                    int device, void* stream) {
  if (n <= 0 || n > kMaxTensors || B <= 0) return (int)cudaErrorInvalidValue;
  Table table;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = desc + 6 * i;
    table.d[i].cache = reinterpret_cast<char*>(r[0]);
    table.d[i].src = reinterpret_cast<const char*>(r[1]);
    table.d[i].kind = (int)r[2];
    table.d[i].itemsize = (int)r[3];
    table.d[i].t = (int)r[4];
    table.d[i].width = (int)r[5];
    const int is = table.d[i].itemsize;
    if ((is != 1 && is != 2 && is != 4) || (r[2] != 0 && r[2] != 1))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, n);
  kv_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, pos);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
