// Shared by the attention kernels K6 (decode_attn.cu) and K7
// (prefill_attn.cu): reading runs of KV-cache values in every storage mode.
//
// A cache row holds D = KVH * HD logical values (flat, group-major):
//   MODE 0  float cache of the query's type T, D elements;
//   MODE 1  int8, D bytes;
//   MODE 2  int4 split-half packed, D / 2 bytes: byte c holds value c in
//           its low nibble and value c + D/2 in its high nibble
//           (tutel_tpu/ops/decode_attn_pallas.py:43-55).
// A run of N values starting at logical column c0 (c0 % N == 0, and for
// MODE 2 a run never straddles D/2) is one vector load of N elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kMaskedScore = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round a float to T and back: the Pallas kernels cast the softmax weights
// to the compute type before the combine dot
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled unless `full`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// BYTES (2, 4, 8 or a multiple of 16) bytes at p into 32-bit words.
template <int BYTES>
__device__ __forceinline__ void load_words(const char* p, uint32_t* w) {
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(BYTES == 2, "unsupported run width");
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

template <typename T, int MODE> struct Storage;
template <typename T> struct Storage<T, 0> {
  static constexpr int kBytes = sizeof(T);
};
template <typename T> struct Storage<T, 1> { static constexpr int kBytes = 1; };
template <typename T> struct Storage<T, 2> { static constexpr int kBytes = 1; };

// Bytes of one stored cache row of D logical values.
template <typename T, int MODE>
__host__ __device__ __forceinline__ size_t row_bytes(int D) {
  return MODE == 2 ? (size_t)D / 2 : (size_t)D * Storage<T, MODE>::kBytes;
}

// N values of a stored row, starting at logical column c0, as floats.
template <typename T, int MODE, int N>
__device__ __forceinline__ void load_run(const char* row, int c0, int D,
                                         float* out) {
  constexpr int kBytes = N * Storage<T, MODE>::kBytes;
  uint32_t w[(kBytes + 3) / 4];
  if constexpr (MODE == 2) {
    const int half = D / 2;
    const bool high = c0 >= half;
    load_words<kBytes>(row + (high ? c0 - half : c0), w);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xff;
      out[i] = high ? (float)((int)(int8_t)byte >> 4)
                    : (float)((int)(int8_t)(byte << 4) >> 4);
    }
  } else if constexpr (MODE == 1) {
    load_words<kBytes>(row + c0, w);
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = (float)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xff);
  } else if constexpr (sizeof(T) == 2) {
    load_words<kBytes>(row + 2 * (size_t)c0, w);
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __uint_as_float(((w[i / 2] >> (16 * (i % 2))) & 0xffff) << 16);
  } else {
    load_words<kBytes>(row + 4 * (size_t)c0, w);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __uint_as_float(w[i]);
  }
}

}  // namespace attn
