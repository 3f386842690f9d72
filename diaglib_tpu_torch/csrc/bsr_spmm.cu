// Kernel K4: the plain block-sparse-row SpMM y = x @ A^T, float32 or
// bfloat16, accumulated in float32.
//
// Replaces the TPU kernel diaglib_tpu/ops/bsr.py::_spmm_kernel (launched by
// _spmm_pallas).  Wrapper: diaglib_tpu_torch/ops/bsr.py::bsr_spmm; plain
// version: bsr_spmm_plain beside it.
//
// Vectors are rows: y[:, rB:(r+1)B] = sum over the entries e of block row r
// of x[:, c_e B:(c_e+1)B] @ T_e, with T_e = blocks_t[e] stored transposed.
// The TPU kernel took one sequential grid step per entry and zeroed its
// output tile at a row's first entry.  Here one CTA owns one (block row,
// tile of output columns, tile of kTK rows of x): it walks its row's
// entries from row_start, so it needs no "first" flag, and an empty row
// writes zeros by construction.  Each thread owns one output column and
// kTK float32 accumulators; x's block column is staged in shared memory a
// chunk at a time and read as a broadcast, T_e is read once, coalesced, by
// the row of threads.  The products are IEEE float32 fused multiply-adds on
// the CUDA cores; bfloat16 inputs are widened on load and the output is
// rounded once at the end.  Each thread issues kLU loads of T_e before it
// uses them, so that enough bytes are in flight to cover device-memory
// latency at the few CTAs a block row gives.
//
// What bounds it on the H100: reading the blocks from device memory (B^2
// elements per entry, once per kTK rows of x); at k <= 16 the float32
// arithmetic is about 8 FMAs a byte, under the CUDA cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 16;    // rows of x per CTA
constexpr int kLC = 128;   // contraction chunk staged in shared memory
constexpr int kLU = 8;     // block rows loaded ahead of their products
constexpr int kMaxThreads = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kMaxThreads)
bsr_spmm_kernel(const TX* __restrict__ x, const TB* __restrict__ blocks_t,
                const int32_t* __restrict__ cols,
                const int32_t* __restrict__ row_start, TX* __restrict__ y,
                int k, int n, int B, int nbr, int nnzb) {
  __shared__ float xs[kLC][kTK];                  // 8 KB
  const int r = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int k0 = blockIdx.z * kTK;
  const bool live = j < B;
  float acc[kTK];
#pragma unroll
  for (int kk = 0; kk < kTK; ++kk) acc[kk] = 0.0f;

  const int e0 = row_start[r];
  const int e1 = r + 1 < nbr ? row_start[r + 1] : nnzb;
  for (int e = e0; e < e1; ++e) {
    const size_t xcol = (size_t)cols[e] * B;
    const TB* blk = blocks_t + (size_t)e * B * B;
    for (int l0 = 0; l0 < B; l0 += kLC) {
      const int lc = min(kLC, B - l0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kTK * kLC; idx += blockDim.x) {
        const int kk = idx / kLC;
        const int l = idx % kLC;
        float v = 0.0f;
        if (k0 + kk < k && l < lc) {
          v = widen(x[(size_t)(k0 + kk) * n + xcol + l0 + l]);
        }
        xs[l][kk] = v;
      }
      __syncthreads();
      if (!live) continue;
      for (int l = 0; l < lc; l += kLU) {
        // kLU independent loads in flight before their products
        float t[kLU];
#pragma unroll
        for (int u = 0; u < kLU; ++u) {
          t[u] = l + u < lc ? widen(blk[(size_t)(l0 + l + u) * B + j])
                            : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kLU; ++u) {
#pragma unroll
          for (int kk = 0; kk < kTK; ++kk) {
            acc[kk] = __fmaf_rn(xs[l + u][kk], t[u], acc[kk]);
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int kk = 0; kk < kTK; ++kk) {
    if (k0 + kk < k) {
      y[(size_t)(k0 + kk) * n + (size_t)r * B + j] = narrow<TX>(acc[kk]);
    }
  }
}

template <typename TX, typename TB>
int launch(const void* x, const void* blocks_t, const int32_t* cols,
           const int32_t* row_start, void* y, int k, int n, int B, int nbr,
           int nnzb, cudaStream_t stream) {
  if (k > 0 && nbr > 0) {
    const int threads = min(kMaxThreads, (B + 31) / 32 * 32);
    const dim3 grid(nbr, (B + threads - 1) / threads, (k + kTK - 1) / kTK);
    bsr_spmm_kernel<TX, TB><<<grid, threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TB*>(blocks_t), cols,
        row_start, static_cast<TX*>(y), k, n, B, nbr, nnzb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (k, n) of type x_type; blocks_t: (nnzb, B, B) of type b_type
// (0 float32, 1 bfloat16); cols: (nnzb,) int32; row_start: (nbr,) int32,
// n = nbr * B.  Returns a cudaError_t, or -1 for an unknown type.
int bsr_spmm(int x_type, int b_type, const void* x, const void* blocks_t,
             const int32_t* cols, const int32_t* row_start, void* y, int k,
             int n, int B, int nbr, int nnzb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == 0 && b_type == 0)
    return launch<float, float>(x, blocks_t, cols, row_start, y, k, n, B,
                                nbr, nnzb, s);
  if (x_type == 0 && b_type == 1)
    return launch<float, __nv_bfloat16>(x, blocks_t, cols, row_start, y, k,
                                        n, B, nbr, nnzb, s);
  if (x_type == 1 && b_type == 0)
    return launch<__nv_bfloat16, float>(x, blocks_t, cols, row_start, y, k,
                                        n, B, nbr, nnzb, s);
  if (x_type == 1 && b_type == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, blocks_t, cols, row_start,
                                                y, k, n, B, nbr, nnzb, s);
  return -1;
}

const char* bsr_spmm_error_string(int err) {
  if (err == -1) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
