// Kernel K2: the slice peel, int8 planes of pre-scaled values.
//
// Replaces the TPU kernel diaglib_tpu/ops/slicing.py::_make_peel_kernel
// (launched by _peel_rows_pallas).  Wrapper: diaglib_tpu_torch/ops/slicing.py
// ::peel_rows; plain version: peel_rows_plain beside it.
//
// For every element t (|t| <= 1/2 on its row's power-of-two grid) it writes
// nx planes q_i with t ~= sum_i q_i 2^{-bits (i+1)}: q = rint(rem 2^{b(i+1)}),
// rem -= q 2^{-b(i+1)}, on the exact float32 triple (hi, mid, lo) of t, the
// mid part joining once b(i+1) >= 24 and the lo part once b(i+1) >= 48.
// Every step is exact in float32, so the planes are bit-identical to the
// plain version as long as the compiler keeps IEEE semantics: rintf rounds
// half to even like jnp.round, the products and differences use the _rn
// intrinsics (no multiply-add contraction), and the build keeps denormals.
//
// On the H100 it is bound by device memory: 8 (f64) or 4 (f32) bytes in and
// nx bytes out per element, and a handful of float operations.  One thread
// per element, consecutive threads on consecutive elements, so every load
// and every plane's store is coalesced; the float64 input is split into its
// float32 triple in registers, so the triple is never stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "peel.cuh"

namespace {

constexpr int kThreads = 256;

// mode 0: float64 t; mode 1: float32 t (mid = lo = 0); mode 2: float32
// components (hi, mid, lo) already split.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
peel_kernel(const void* __restrict__ src, const float* __restrict__ mid_in,
            const float* __restrict__ lo_in, int8_t* __restrict__ out,
            long long numel, int nx, int bits) {
  const long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (idx >= numel) return;
  float hi, mid, lo;
  if (MODE == 0) {
    peel::split_f64(static_cast<const double*>(src)[idx], hi, mid, lo);
  } else if (MODE == 1) {
    hi = static_cast<const float*>(src)[idx];
    mid = 0.0f;
    lo = 0.0f;
  } else {
    hi = static_cast<const float*>(src)[idx];
    mid = mid_in[idx];
    lo = lo_in[idx];
  }
  for (int i = 0; i < nx; ++i) {
    // bits * (i + 1) < 127, checked by the caller
    const float q = peel::step(bits * (i + 1), hi, mid, lo);
    out[i * numel + idx] = static_cast<int8_t>(__float2int_rn(q));
  }
}

template <int MODE>
int launch(const void* src, const float* mid, const float* lo, int8_t* out,
           long long numel, int nx, int bits, cudaStream_t stream) {
  if (numel > 0) {
    const long long blocks = (numel + kThreads - 1) / kThreads;
    peel_kernel<MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, mid, lo, out, numel, nx, bits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// t: numel float64; out: (nx, numel) int8.
int peel_f64(const double* t, int8_t* out, long long numel, int nx, int bits,
             void* stream) {
  return launch<0>(t, nullptr, nullptr, out, numel, nx, bits,
                   static_cast<cudaStream_t>(stream));
}

// t: numel float32 (mid = lo = 0).
int peel_f32(const float* t, int8_t* out, long long numel, int nx, int bits,
             void* stream) {
  return launch<1>(t, nullptr, nullptr, out, numel, nx, bits,
                   static_cast<cudaStream_t>(stream));
}

// hi, mid, lo: numel float32 each, the pre-scaled components.
int peel_f32x3(const float* hi, const float* mid, const float* lo,
               int8_t* out, long long numel, int nx, int bits, void* stream) {
  return launch<2>(hi, mid, lo, out, numel, nx, bits,
                   static_cast<cudaStream_t>(stream));
}

const char* peel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
