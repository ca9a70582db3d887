// CPU reference dispatch kernels + batch sampler (host code; a copy of
// tutel_tpu/csrc/dispatch_cpu.cpp).
//
// Native counterpart of the reference's CPU dispatch path
// (reference tutel/custom/custom_kernel.cpp:280-323 invoke_cpu<dtype>,
// kernel_type 0/1/2 = forward / backward_data / backward_gate): the
// executable specification the port's dispatch (ops/dispatch.py) is tested
// against, exactly as the reference tests CPU==CUDA
// (reference tests/test_tutel.py:85-92).
//
// Also provides a batch sampler for the LM example's binary corpus
// (contiguous int32 tokens): fills [batch, seq+1] windows from given
// offsets without Python-loop overhead.
//
// Build (csrc/native.py does it on first use):
//   g++ -O3 -shared -fPIC -o dispatch_cpu-<hash>.so dispatch_cpu.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// dispatched[(expert*capacity + loc) * M + j] = gate * input[s * M + j]
// over (k, s); locations < 0 or >= capacity are dropped.
// gates/indices/locations are [K, S] row-major; input [S, M];
// dispatched [E*C, M] (pre-zeroed by the caller).
void dispatch_forward_f32(
    const float* gates, const int32_t* indices, const int32_t* locations,
    const float* input, float* dispatched,
    int64_t k, int64_t s, int64_t m, int64_t capacity, int64_t experts,
    int use_gates) {
  for (int64_t ki = 0; ki < k; ++ki) {
    for (int64_t si = 0; si < s; ++si) {
      const int64_t t = ki * s + si;
      const int32_t loc = locations[t];
      const int32_t e = indices[t];
      if (loc < 0 || loc >= capacity || e < 0 || e >= experts) continue;
      const float g = use_gates ? gates[t] : 1.0f;
      float* dst = dispatched + ((int64_t)e * capacity + loc) * m;
      const float* src = input + si * m;
      for (int64_t j = 0; j < m; ++j) dst[j] += g * src[j];
    }
  }
}

// grad_input[s * M + j] += gate * dispatched[(e*C + loc) * M + j]
void dispatch_backward_data_f32(
    const float* gates, const int32_t* indices, const int32_t* locations,
    const float* dispatched, float* grad_input,
    int64_t k, int64_t s, int64_t m, int64_t capacity, int64_t experts,
    int use_gates) {
  for (int64_t ki = 0; ki < k; ++ki) {
    for (int64_t si = 0; si < s; ++si) {
      const int64_t t = ki * s + si;
      const int32_t loc = locations[t];
      const int32_t e = indices[t];
      if (loc < 0 || loc >= capacity || e < 0 || e >= experts) continue;
      const float g = use_gates ? gates[t] : 1.0f;
      const float* src = dispatched + ((int64_t)e * capacity + loc) * m;
      float* dst = grad_input + si * m;
      for (int64_t j = 0; j < m; ++j) dst[j] += g * src[j];
    }
  }
}

// grad_gates[k, s] = <dispatched[(e*C + loc)], input[s]>
void dispatch_backward_gate_f32(
    float* grad_gates, const int32_t* indices, const int32_t* locations,
    const float* dispatched, const float* input,
    int64_t k, int64_t s, int64_t m, int64_t capacity, int64_t experts) {
  for (int64_t ki = 0; ki < k; ++ki) {
    for (int64_t si = 0; si < s; ++si) {
      const int64_t t = ki * s + si;
      const int32_t loc = locations[t];
      const int32_t e = indices[t];
      if (loc < 0 || loc >= capacity || e < 0 || e >= experts) {
        grad_gates[t] = 0.0f;
        continue;
      }
      const float* a = dispatched + ((int64_t)e * capacity + loc) * m;
      const float* b = input + si * m;
      double acc = 0.0;  // f64 accumulation (reference uses fp32 atomics;
                         // the oracle is allowed to be more precise)
      for (int64_t j = 0; j < m; ++j) acc += (double)a[j] * b[j];
      grad_gates[t] = (float)acc;
    }
  }
}

// Exclusive-cumsum-minus-one per expert column over the k-major token
// stream: the location assignment
// (reference custom_kernel.cpp:822-872 warp_cumsum semantics).
void cumsum_locations(
    const int32_t* indices, int32_t* locations, int32_t* counts,
    int64_t k, int64_t s, int64_t experts) {
  for (int64_t e = 0; e < experts; ++e) counts[e] = 0;
  for (int64_t t = 0; t < k * s; ++t) {
    const int32_t e = indices[t];
    if (e < 0 || e >= experts) { locations[t] = -1; continue; }
    locations[t] = counts[e]++;
  }
}

// Batch sampler: out[b, j] = corpus[offsets[b] + j], j < window.
void sample_windows_i32(
    const int32_t* corpus, const int64_t* offsets, int32_t* out,
    int64_t batch, int64_t window) {
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out + b * window, corpus + offsets[b],
                window * sizeof(int32_t));
  }
}

}  // extern "C"
