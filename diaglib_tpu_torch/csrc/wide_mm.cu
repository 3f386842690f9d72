// Kernel K3: the exact float64 wide-output product y = a(m, K) @ b(K, n)
// through 7-bit integer slices, for small K and wide n (the solvers' Ritz
// rotations and ortho projections).
//
// Replaces the TPU kernel diaglib_tpu/ops/slicing.py::_wide_kernel (launched
// by sliced_wide_mm).  Wrapper: diaglib_tpu_torch/ops/slicing.py
// ::sliced_wide_mm; plain version: sliced_wide_mm_plain beside it.
//
// a arrives as its 8 int8 planes on a per-row power-of-two grid sa (peeled
// by kernel K2 in the wrapper, K zero-padded to a multiple of 4); b arrives
// as raw float64 with its per-column grid sb.  Each thread owns one column j
// of one tile of kMT output rows.  It cuts b[k, j] / sb[j] into 8 planes in
// registers, with the peel chain of K2 (peel.cuh), packs four consecutive k
// of a plane into one int32 word and dots it against the a planes staged in
// shared memory with __dp4a.  Only the pairs (i, p) with level i + p < 9 are
// formed; level sums are exact int32 (|q| <= 64, at most 8 pairs a level,
// K <= 4096 on the solvers' route: below 2^28).  The levels are combined
// straight to float64, deepest first, sum_L v_L 2^{-7(L+2)}, then scaled by
// sa[r] sb[j]: the products by powers of two are exact and the sums round
// as the plain version's do, so the two agree bit for bit.  (The TPU kernel
// wrote an exact float32 triple instead, for VMEM reasons only.)
//
// What bounds it on the H100: integer dot throughput on the CUDA cores
// (43 pairs x m x K x n byte products) and the float32 peel of b, repeated
// once per row tile; b is read from device memory once per row tile
// (8 K n bytes).  At (15, 165) @ (165, 65536) that is 7 G byte products on
// __dp4a and 87 MB of b per tile, so the kernel is compute bound; a cuBLAS
// DGEMM of the same product is bound by reading b once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "peel.cuh"

namespace {

constexpr int kThreads = 128;   // columns per CTA, one per thread
constexpr int kMT = 8;          // output rows per CTA
constexpr int kNS = 8;          // planes of each operand
constexpr int kNLev = 9;        // levels kept: i + p < 9
constexpr int kBits = 7;
constexpr int kKC = 256;        // contraction chunk staged in shared memory
constexpr int kWC = kKC / 4;    // int32 words per staged row

__global__ void __launch_bounds__(kThreads)
wide_mm_kernel(const int8_t* __restrict__ a_sl, const double* __restrict__ sa,
               const double* __restrict__ b, const double* __restrict__ sb,
               double* __restrict__ out, int m, int K, int kp, int n) {
  __shared__ int32_t a_s[kNS][kMT][kWC];          // 16 KB
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int r0 = blockIdx.y * kMT;
  const bool live = j < n;
  // 1/sb is a power of two, so b * (1/sb) is the correctly rounded b / sb
  const double inv_sb = live ? __drcp_rn(sb[j]) : 1.0;

  int32_t acc[kNLev][kMT];
#pragma unroll
  for (int L = 0; L < kNLev; ++L) {
#pragma unroll
    for (int r = 0; r < kMT; ++r) acc[L][r] = 0;
  }

  for (int k0 = 0; k0 < kp; k0 += kKC) {
    const int wc = min(kKC, kp - k0) / 4;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kNS * kMT * kWC; idx += kThreads) {
      const int w = idx % kWC;
      const int r = (idx / kWC) % kMT;
      const int i = idx / (kWC * kMT);
      int32_t v = 0;
      if (r0 + r < m && w < wc) {
        v = *reinterpret_cast<const int32_t*>(
            a_sl + ((size_t)i * m + r0 + r) * kp + k0 + 4 * w);
      }
      a_s[i][r][w] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int w = 0; w < wc; ++w) {
      uint32_t qp[kNS];
#pragma unroll
      for (int p = 0; p < kNS; ++p) qp[p] = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * w + t;
        const double v =
            k < K ? __dmul_rn(b[(size_t)k * n + j], inv_sb) : 0.0;
        float hi, mid, lo;
        peel::split_f64(v, hi, mid, lo);
#pragma unroll
        for (int p = 0; p < kNS; ++p) {
          const int q = __float2int_rn(peel::step(kBits * (p + 1), hi, mid,
                                                  lo));
          qp[p] |= (uint32_t)(q & 0xff) << (8 * t);
        }
      }
#pragma unroll
      for (int r = 0; r < kMT; ++r) {
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int32_t aw = a_s[i][r][w];
#pragma unroll
          for (int p = 0; p < kNS; ++p) {
            if (i + p < kNLev) {
              acc[i + p][r] = __dp4a(aw, (int)qp[p], acc[i + p][r]);
            }
          }
        }
      }
    }
  }
  if (!live) return;
  const double sbj = sb[j];
#pragma unroll
  for (int r = 0; r < kMT; ++r) {
    if (r0 + r >= m) break;
    double y = 0.0;
#pragma unroll
    for (int L = kNLev - 1; L >= 0; --L) {
      // 2^{-7(L+2)}, exact
      const double wl = __longlong_as_double(
          (long long)(1023 - kBits * (L + 2)) << 52);
      y = __dadd_rn(y, __dmul_rn((double)acc[L][r], wl));
    }
    out[(size_t)(r0 + r) * n + j] = __dmul_rn(__dmul_rn(y, sa[r0 + r]), sbj);
  }
}

}  // namespace

extern "C" {

// a_sl: (8, m, kp) int8, kp % 4 == 0, columns >= K zero; sa: (m,) float64;
// b: (K, n) float64 row-major; sb: (n,) float64; out: (m, n) float64.
int wide_mm(const int8_t* a_sl, const double* sa, const double* b,
            const double* sb, double* out, int m, int K, int kp, int n,
            void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, (m + kMT - 1) / kMT);
    wide_mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a_sl, sa, b, sb, out, m, K, kp, n);
  }
  return (int)cudaGetLastError();
}

const char* wide_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
