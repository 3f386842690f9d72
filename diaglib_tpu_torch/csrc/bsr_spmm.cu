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
// output tile at a row's first entry.  Here a work item is (block row, tile
// of kTN output columns, tile of kTK rows of x); one CTA owns an item and
// walks its row's entries from row_start, so it needs no "first" flag, no
// atomics, and an empty row writes zeros by construction.
//
// What bounds it on the H100: reading the blocks from device memory (B^2
// elements an entry, once per kTK rows of x).  The design keeps HBM busy:
//   - persistent CTAs, two an SM, walk the items (blockIdx.x, + gridDim.x);
//   - every item is a sequence of stages, kSL rows of T_e's column tile and
//     the matching kSL columns of x's block column (kTK rows); each thread
//     copies its share of a stage with 16-byte cp.async into a ring of kNS
//     stages, so kNS - 1 stages (about 85 KB a CTA at float32) are in
//     flight while one is consumed, across entries and items alike: the
//     copies of the next entry's T and x go out while the current one is
//     summed, and the one barrier a stage never waits for a later copy;
//   - a thread owns 2 output columns x kTK rows (32 float32 accumulators)
//     and sums each one in the order l = 0, 1, ... of every entry in turn,
//     as one chain of IEEE float32 fused multiply-adds on the CUDA cores
//     (the order of the earlier version of this kernel, so its results are
//     unchanged); x's values for 4 rows l come as one shared load
//     (a broadcast) a row of x.
// At k = 15 that is about 7.5 FMAs a byte of float32 blocks, under the CUDA
// cores' rate.  bfloat16 inputs are widened on load and the output is
// rounded once.  Where B * itemsize is not a multiple of 16 bytes (or a
// pointer is not 16-byte aligned) the same stages are filled with ordinary
// loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTN = 2 * kThreads;   // output columns an item (2 a thread)
constexpr int kTK = 16;         // rows of x an item
constexpr int kSL = 16;         // rows of T_e a stage
constexpr int kNS = 6;          // stages in the ring

template <typename TX, typename TB>
struct Layout {
  static constexpr int kTBytes = kSL * kTN * (int)sizeof(TB);
  static constexpr int kXBytes = kTK * kSL * (int)sizeof(TX);
  static constexpr int kStage = kTBytes + kXBytes;
  static constexpr int kSmem = kNS * kStage;
};

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two consecutive values from shared memory, widened
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four consecutive values from shared memory, widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 16 bytes of `live` elements from src, the rest zero: cp.async when
// aligned, ordinary loads otherwise
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int live,
                                       bool aligned) {
  constexpr int kE = 16 / (int)sizeof(T);
  if (aligned) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(live * (int)sizeof(T))
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i) dst[i] = i < live ? src[i] : T(0.0f);
  }
}

struct Problem {
  int k, n, B, nbr, nnzb;
  int nct, nkt, items, stages;   // column tiles, x tiles, items, stages/entry
};

// The producer's place in the CTA's sequence of (item, entry, stage).
struct Cursor {
  int it, e, e1, s;
};

__device__ __forceinline__ void row_range(const int32_t* row_start,
                                          const Problem& p, int r, int& e0,
                                          int& e1) {
  e0 = row_start[r];
  e1 = r + 1 < p.nbr ? row_start[r + 1] : p.nnzb;
}

// move to the first stage of the first item at or after c.it with entries
__device__ __forceinline__ void seek(Cursor& c, const int32_t* row_start,
                                     const Problem& p) {
  for (; c.it < p.items; c.it += gridDim.x) {
    int e0, e1;
    row_range(row_start, p, c.it / (p.nct * p.nkt), e0, e1);
    if (e0 < e1) {
      c.e = e0;
      c.e1 = e1;
      c.s = 0;
      return;
    }
  }
}

__device__ __forceinline__ void advance(Cursor& c, const int32_t* row_start,
                                        const Problem& p) {
  if (++c.s < p.stages) return;
  c.s = 0;
  if (++c.e < c.e1) return;
  c.it += gridDim.x;
  seek(c, row_start, p);
}

// issue this thread's copies of the cursor's stage into `stage`
template <typename TX, typename TB>
__device__ __forceinline__ void issue(const Cursor& c, unsigned char* stage,
                                      const TX* x, const TB* blocks_t,
                                      const int32_t* cols, const Problem& p,
                                      bool aligned) {
  using Lay = Layout<TX, TB>;
  constexpr int kEB = 16 / (int)sizeof(TB);     // elements a copy
  constexpr int kEX = 16 / (int)sizeof(TX);
  constexpr int kCT = kTN / kEB;                // copies a T row
  constexpr int kCX = kSL / kEX;                // copies an x row
  const int ct = (c.it / p.nkt) % p.nct;
  const int k0 = (c.it % p.nkt) * kTK;
  const int l0 = c.s * kSL;
  TB* ts = reinterpret_cast<TB*>(stage);
  TX* xs = reinterpret_cast<TX*>(stage + Lay::kTBytes);
  const TB* blk = blocks_t + (size_t)c.e * p.B * p.B;
#pragma unroll
  for (int q = 0; q < kSL * kCT / kThreads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int row = i / kCT, col = (i % kCT) * kEB;
    const int l = l0 + row, j = ct * kTN + col;
    const int live = l < p.B ? max(0, min(kEB, p.B - j)) : 0;
    copy16(ts + row * kTN + col, live ? blk + (size_t)l * p.B + j : blk, live,
           aligned);
  }
  if (threadIdx.x < kTK * kCX) {
    const int kk = threadIdx.x / kCX, col = (threadIdx.x % kCX) * kEX;
    const int l = l0 + col;
    const int live = k0 + kk < p.k ? max(0, min(kEX, p.B - l)) : 0;
    const TX* src = x + (size_t)(k0 + kk) * p.n + (size_t)cols[c.e] * p.B + l;
    copy16(xs + kk * kSL + col, live ? src : x, live, aligned);
  }
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_kernel(const TX* __restrict__ x, const TB* __restrict__ blocks_t,
                const int32_t* __restrict__ cols,
                const int32_t* __restrict__ row_start, TX* __restrict__ y,
                Problem p, bool aligned) {
  using Lay = Layout<TX, TB>;
  extern __shared__ __align__(16) unsigned char smem[];

  Cursor prod{(int)blockIdx.x, 0, 0, 0};
  seek(prod, row_start, p);
  for (int i = 0; i < kNS - 1; ++i) {
    if (prod.it < p.items) {
      issue(prod, smem + i * Lay::kStage, x, blocks_t, cols, p, aligned);
      advance(prod, row_start, p);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  int slot = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int r = it / (p.nct * p.nkt);
    const int ct = (it / p.nkt) % p.nct;
    const int k0 = (it % p.nkt) * kTK;
    int e0, e1;
    row_range(row_start, p, r, e0, e1);
    float acc[kTK][2];
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) acc[kk][0] = acc[kk][1] = 0.0f;

    for (int step = 0; step < (e1 - e0) * p.stages; ++step) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kNS - 2) : "memory");
      __syncthreads();
      // refill the slot every thread finished with at the last step
      if (prod.it < p.items) {
        issue(prod, smem + (slot == 0 ? kNS - 1 : slot - 1) * Lay::kStage, x,
              blocks_t, cols, p, aligned);
        advance(prod, row_start, p);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");

      const TB* ts = reinterpret_cast<const TB*>(smem + slot * Lay::kStage) +
                     2 * threadIdx.x;
      const TX* xs = reinterpret_cast<const TX*>(smem + slot * Lay::kStage +
                                                 Lay::kTBytes);
#pragma unroll
      for (int u0 = 0; u0 < kSL; u0 += 4) {
        float xv[kTK][4];                      // x[kk][l0 + u0 + u]
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
          const float4 v = load4(xs + kk * kSL + u0);
          xv[kk][0] = v.x;
          xv[kk][1] = v.y;
          xv[kk][2] = v.z;
          xv[kk][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 t = load2(ts + (u0 + u) * kTN);
#pragma unroll
          for (int kk = 0; kk < kTK; ++kk) {
            acc[kk][0] = __fmaf_rn(xv[kk][u], t.x, acc[kk][0]);
            acc[kk][1] = __fmaf_rn(xv[kk][u], t.y, acc[kk][1]);
          }
        }
      }
      slot = slot + 1 == kNS ? 0 : slot + 1;
    }

    const int j = ct * kTN + 2 * threadIdx.x;
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      if (k0 + kk >= p.k) break;
      TX* yrow = y + (size_t)(k0 + kk) * p.n + (size_t)r * p.B;
      if (j < p.B) yrow[j] = narrow<TX>(acc[kk][0]);
      if (j + 1 < p.B) yrow[j + 1] = narrow<TX>(acc[kk][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename TX, typename TB>
int launch(const void* x, const void* blocks_t, const int32_t* cols,
           const int32_t* row_start, void* y, int k, int n, int B, int nbr,
           int nnzb, cudaStream_t stream) {
  using Lay = Layout<TX, TB>;
  static int per_sm = 0;
  static int sms = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Lay::kSmem);
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bsr_spmm_kernel<TX, TB>, kThreads, Lay::kSmem);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  if (k > 0 && nbr > 0) {
    Problem p;
    p.k = k;
    p.n = n;
    p.B = B;
    p.nbr = nbr;
    p.nnzb = nnzb;
    p.nct = (B + kTN - 1) / kTN;
    p.nkt = (k + kTK - 1) / kTK;
    p.stages = (B + kSL - 1) / kSL;
    const long long items = (long long)nbr * p.nct * p.nkt;
    if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    p.items = (int)items;
    const bool aligned =
        (B * sizeof(TX)) % 16 == 0 && (B * sizeof(TB)) % 16 == 0 &&
        (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(blocks_t) & 15) == 0;
    const int grid = (int)std::min<long long>(items, (long long)sms * per_sm);
    bsr_spmm_kernel<TX, TB><<<grid, kThreads, Lay::kSmem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TB*>(blocks_t), cols,
        row_start, static_cast<TX*>(y), p, aligned);
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
