// out = fn(x) elementwise, for a function lifted by jit.pallas_kernel (K10).
//
// Replaces the Pallas kernel `pallas_kernel` (tutel_tpu/jit.py:74, body
// `kernel` :79, pallas_call :85): the result has x's shape and dtype.
//
// This file is a template. jit.py puts four definitions in front of it and
// its launch trampoline (the one every injected kernel gets, K9, with the
// occupancy query) behind it, and compiles the text at run time
// (csrc/build.py `load_source`):
//   TT_DTYPE    the element type of x and out: 0 float32, 1 bfloat16,
//               2 float16;
//   TT_THREADS  threads a block (jit.py `_THREADS`, which sizes the grid);
//   TT_UNROLL   16-byte vectors a thread loads a step (jit.py `_UNROLL`);
//   TT_BODY     the lifted function as statements over `float v`, ending
//               in a return, each a call of one tt_* function below
//               (jit.py `_OPS` holds each one's PyTorch twin).
//
// What bounds it on an H100: bytes. Each element is read once and written
// once; the few dozen float operations an element takes stay far below the
// CUDA cores' rate.
//
// Design: blocks of kThreads threads, each step of a block kUnroll *
// kThreads consecutive 16-byte vectors (4 float32, 8 bf16 or 8 f16
// elements); a thread issues its kUnroll independent vector loads before
// it computes any, so that enough bytes are in flight to cover the
// memory's latency. Where the output fits in the 50 MB L2 the wrapper
// launches at most as many blocks as this body's occupancy keeps resident
// (`tt_jit_occupancy`, queried once per type and device) and they stride
// over the steps; where it does not, one block per step, which keeps the
// card nearer its memory rate at 2 GB moved (PERF.md, the findings on
// K10's grid). The tail, and tensors not aligned to 16 bytes, go one
// element at a time. The arithmetic is float32 with one rounding at the
// store (to nearest even), without fast-math: expf, tanhf and erff are
// the full-precision functions.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(TT_DTYPE) || !defined(TT_THREADS) || !defined(TT_UNROLL) || \
    !defined(TT_BODY)
#error "elementwise.cu is a template: jit.py defines its four TT_ macros"
#endif
// a lifted body calls only a few of the tt_* functions
#pragma nv_diag_suppress 177

namespace {

#if TT_DTYPE == 0
typedef float T;
__device__ __forceinline__ float tt_load(T v) { return v; }
__device__ __forceinline__ T tt_store(float v) { return v; }
#elif TT_DTYPE == 1
typedef __nv_bfloat16 T;
__device__ __forceinline__ float tt_load(T v) { return __bfloat162float(v); }
__device__ __forceinline__ T tt_store(float v) { return __float2bfloat16_rn(v); }
#elif TT_DTYPE == 2
typedef __half T;
__device__ __forceinline__ float tt_load(T v) { return __half2float(v); }
__device__ __forceinline__ T tt_store(float v) { return __float2half_rn(v); }
#else
#error "TT_DTYPE must be 0, 1 or 2"
#endif

constexpr int kThreads = TT_THREADS;
constexpr int kVec = 16 / sizeof(T);
constexpr int kUnroll = TT_UNROLL;     // 16-byte loads a thread has in flight

// Comparisons give 1 or 0; tt_where takes any value other than 0 as true.
// relu, maximum and minimum pass a NaN on, as PyTorch's do.
__device__ __forceinline__ float tt_add(float a, float b) { return a + b; }
__device__ __forceinline__ float tt_sub(float a, float b) { return a - b; }
__device__ __forceinline__ float tt_mul(float a, float b) { return a * b; }
__device__ __forceinline__ float tt_div(float a, float b) { return a / b; }
__device__ __forceinline__ float tt_neg(float a) { return -a; }
__device__ __forceinline__ float tt_pow(float a, float b) { return powf(a, b); }
// a ** n for an integer n: a left-to-right chain of products
__device__ __forceinline__ float tt_powi(float a, int n) {
  const int m = n < 0 ? -n : n;
  float r = m == 0 ? 1.f : a;
  for (int i = 1; i < m; ++i) r = r * a;
  return n < 0 ? 1.f / r : r;
}
__device__ __forceinline__ float tt_gt(float a, float b) { return a > b ? 1.f : 0.f; }
__device__ __forceinline__ float tt_ge(float a, float b) { return a >= b ? 1.f : 0.f; }
__device__ __forceinline__ float tt_lt(float a, float b) { return a < b ? 1.f : 0.f; }
__device__ __forceinline__ float tt_le(float a, float b) { return a <= b ? 1.f : 0.f; }
__device__ __forceinline__ float tt_eq(float a, float b) { return a == b ? 1.f : 0.f; }
__device__ __forceinline__ float tt_ne(float a, float b) { return a != b ? 1.f : 0.f; }
__device__ __forceinline__ float tt_where(float c, float a, float b) {
  return c != 0.f ? a : b;
}
__device__ __forceinline__ float tt_maximum(float a, float b) {
  return a != a ? a : (a > b ? a : b);
}
__device__ __forceinline__ float tt_minimum(float a, float b) {
  return a != a ? a : (a < b ? a : b);
}
__device__ __forceinline__ float tt_relu(float a) { return a < 0.f ? 0.f : a; }
__device__ __forceinline__ float tt_abs(float a) { return fabsf(a); }
__device__ __forceinline__ float tt_exp(float a) { return expf(a); }
__device__ __forceinline__ float tt_log(float a) { return logf(a); }
__device__ __forceinline__ float tt_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float tt_rsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ float tt_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ float tt_erf(float a) { return erff(a); }
__device__ __forceinline__ float tt_sigmoid(float a) { return 1.f / (1.f + expf(-a)); }
__device__ __forceinline__ float tt_silu(float a) { return a / (1.f + expf(-a)); }
// gelu(approximate="none") and (approximate="tanh"), in PyTorch's order
__device__ __forceinline__ float tt_gelu(float a) {
  return a * 0.5f * (1.f + erff(a * 0.70710678118654752f));
}
__device__ __forceinline__ float tt_gelu_tanh(float a) {
  const float inner = 0.79788456080286536f * (a + 0.044715f * (a * a * a));
  return 0.5f * a * (1.f + tanhf(inner));
}

__device__ __forceinline__ float tt_fn(float v) { TT_BODY }

}  // namespace

__global__ void __launch_bounds__(kThreads)
tt_elementwise(const T* __restrict__ x, T* __restrict__ out, long long n) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const long long nvec = aligned ? n / kVec : 0;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  // a block's step: kUnroll * kThreads consecutive vectors, thread t taking
  // t, t + kThreads, ..., all loaded before any is computed; the grid
  // strides over the steps
  constexpr long long kStep = (long long)kUnroll * kThreads;
  for (long long i = blockIdx.x * kStep + threadIdx.x; i < nvec;
       i += gridDim.x * kStep) {
    alignas(16) T buf[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kThreads < nvec)
        *reinterpret_cast<uint4*>(buf[u]) = xv[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * kThreads < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          buf[u][j] = tt_store(tt_fn(tt_load(buf[u][j])));
        ov[i + u * kThreads] = *reinterpret_cast<const uint4*>(buf[u]);
      }
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = nvec * kVec + blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = tt_store(tt_fn(tt_load(x[i])));
}
