// Kernel K2: the x side of the sliced matvec, from x to its int8 planes and
// row scales in one launch; and the peel of pre-scaled values.
//
// Replaces the TPU kernel diaglib_tpu/ops/slicing.py::_make_peel_kernel
// (launched by _peel_rows_pallas) together with the work the JAX package
// does around it outside the kernel (diaglib_tpu/ops/bsr_sliced.py::_slice_x:
// the row max, the grid and the division, because Mosaic has no float64).
// Wrappers: diaglib_tpu_torch/ops/slicing.py::slice_rows (the fused entry)
// and ::peel_rows (pre-scaled values); plain versions slice_rows_plain and
// peel_rows_plain beside them.
//
// slice_rows_kernel: a thread block cluster of C CTAs a row of x (C = 8 for
// long rows, fewer for short ones), each CTA on a contiguous piece of the
// row, each thread on quads of 4 consecutive elements.
//   1. Every thread loads its quads (16-byte loads where x is aligned),
//      casts them to the accumulation type, multiplies them by the column
//      grid u where one is given (the symmetric store's separable grid),
//      casts them to the working type, keeps up to kKeep quads in registers
//      of that type (float32 on the float32 tier: conversions to and from
//      float64 issue at an eighth of the float32 rate) and takes the
//      NaN-propagating max of their absolute values.  The CTA's max goes
//      through warp shuffles into shared memory, and the cluster's CTAs
//      read each other's through distributed shared memory.
//   2. Every CTA applies pow2_grid's rule to the row's max (peel::grid2, as
//      K3 does), CTA 0 writes the row's scale, and every thread multiplies
//      its values by the grid's reciprocal (exact: a power of two), cuts
//      them into planes and writes 4 bytes a plane a quad, so that a warp
//      stores 128 contiguous bytes of a plane.  Quads past kKeep a thread
//      are read again from device memory (L2) here.
// A row whose max is finite has |t| <= 1/2 and takes peel::peel8 (the
// float32 pipe's rint).  A row whose max is inf or NaN holds NaN or values
// beyond 1/2; it takes the plain chain's own steps (peel::step) and casts
// each plane to int8 as torch does, so it too equals the plain version.
//
// peel_kernel: the pre-scaled entry (the grid pinned to 1) at any bit
// width, with peel::step, on float64 or float32 values or a (hi, mid, lo)
// float32 triple; the same quads and stores, no cluster.
//
// What bounds it on the H100: device memory.  x is read once (8 or 4 bytes
// an element), u once (a column, shared by the rows), nx bytes an element
// are written: at (15, 65536) float64 with u, 16.3 MB, 4.9 us at 3.35
// TB/s.  The float64 tier's peel is about 70 instructions an element (5 of
// them float64 conversions, the triple's split), issued after the row's
// max is known; one CTA an SM does it for 8192 elements.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "peel.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKeep = 4;          // quads a thread keeps in registers
constexpr int kPortable = 8;      // the largest portable cluster
constexpr double kTinyF32 = 1.1754943508222875e-38;   // least normals
constexpr double kTinyF64 = 2.2250738585072014e-308;
constexpr double kMaxF64 = 1.7976931348623157e308;

struct Rows {
  const void* x;        // (k, n) with element strides (ldx, ldc)
  const float* mid;     // the pre-scaled triple's mid and lo, or null
  const float* lo;
  const void* u;        // (n,) column grid in the accumulation type, or null
  int8_t* out;          // (nx, k, n) int8, contiguous
  void* sx;             // (k,) float32 or float64 row scales (fused only)
  long long ldx, ldc;
  int k, n, nx, bits, split;   // split: CTAs a row (the cluster's size)
  bool sx_f32, vec_x, vec_u, vec_out;
};

// Four consecutive values of p (stride ld) as V, rounded to nearest where V
// is narrower (torch's cast); live < 4 zero-fills.
template <typename T, typename V>
__device__ __forceinline__ void load4(const T* p, long long ld, bool vec,
                                      int live, V v[4]) {
  if (vec && live == 4) {
    if constexpr (sizeof(T) == 8) {
      const double2 a = __ldg(reinterpret_cast<const double2*>(p));
      const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
      v[0] = (V)a.x;
      v[1] = (V)a.y;
      v[2] = (V)b.x;
      v[3] = (V)b.y;
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = (V)a.x;
      v[1] = (V)a.y;
      v[2] = (V)a.z;
      v[3] = (V)a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = e < live ? (V)__ldg(p + e * ld) : (V)0;
    }
  }
}

__device__ __forceinline__ float absval(float x) { return fabsf(x); }

__device__ __forceinline__ double absval(double x) { return fabs(x); }

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// A quad of x as the plain chain's work values: x.to(acc) * u.to(acc)
// (u is given in the accumulation type), then .to(work).
template <typename In, typename Acc, typename Work>
__device__ __forceinline__ void load_work(const Rows& a, bool fold, int row,
                                          int quad, Work w[4]) {
  const int c0 = 4 * quad;
  const int live = min(4, a.n - c0);
  Acc x[4], u[4];
  load4(static_cast<const In*>(a.x) + row * a.ldx + c0 * a.ldc, a.ldc,
        a.vec_x, live, x);
  if (fold) {
    load4(static_cast<const Acc*>(a.u) + c0, 1LL, a.vec_u, live, u);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[e] = (Work)(fold ? mul_rn(x[e], u[e]) : x[e]);
  }
}

__device__ __forceinline__ void store_plane(const Rows& a, int p, int row,
                                            int c0, int live, uint32_t word) {
  int8_t* dst = a.out + ((long long)p * a.k + row) * a.n + c0;
  if (a.vec_out && live == 4) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < live) dst[e] = static_cast<int8_t>(word >> (8 * e));
    }
  }
}

// The planes of four elements by the plain chain's steps, each cast to int8
// as torch casts a float32 (the same C++ conversion).
__device__ __forceinline__ void peel_steps(const Rows& a, int row, int c0,
                                           int live, float hi[4],
                                           float mid[4], float lo[4],
                                           int bits) {
  for (int p = 0; p < a.nx; ++p) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = peel::step(bits * (p + 1), hi[e], mid[e], lo[e]);
      word |= (uint32_t)(uint8_t)static_cast<int8_t>(q) << (8 * e);
    }
    store_plane(a, p, row, c0, live, word);
  }
}

// The float32 triple of a pre-scaled work value (mid = lo = 0 for float32).
__device__ __forceinline__ void triple(float t, float& hi, float& mid,
                                       float& lo) {
  hi = t;
  mid = lo = 0.0f;
}

__device__ __forceinline__ void triple(double t, float& hi, float& mid,
                                       float& lo) {
  peel::split_f64(t, hi, mid, lo);
}

// The first kNp planes of a quad of pre-scaled values (|t| <= 1/2), by
// peel::peel_planes; the first a.nx are written.
template <typename Work, int kNp>
__device__ __forceinline__ void peel_fast(const Rows& a, int row, int c0,
                                          int live, const Work t[4]) {
  constexpr bool kTriple = sizeof(Work) == 8;
  uint32_t q[4][kNp];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float hi, mid, lo;
    triple(t[e], hi, mid, lo);
    peel::peel_planes<kNp, kTriple>(hi, mid, lo, q[e]);
  }
#pragma unroll
  for (int p = 0; p < kNp; ++p) {
    if (p < a.nx) {
      store_plane(a, p, row, c0, live,
                  peel::pack4(q[0][p], q[1][p], q[2][p], q[3][p]));
    }
  }
}

// Divide a quad of work values by the row's grid and write its planes.
template <typename Work>
__device__ __forceinline__ void peel_quad(const Rows& a, int row, int quad,
                                          const Work v[4], Work inv,
                                          bool fast) {
  const int c0 = 4 * quad;
  const int live = min(4, a.n - c0);
  Work t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // == work / grid in float64 rounded to the work type: one rounding of
    // one value (the reciprocal of the power of two is exact)
    t[e] = mul_rn(v[e], inv);
  }
  if (fast && a.nx <= 4) {
    peel_fast<Work, 4>(a, row, c0, live, t);
  } else if (fast) {
    peel_fast<Work, peel::kPlanes>(a, row, c0, live, t);
  } else {
    float hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) triple(t[e], hi[e], mid[e], lo[e]);
    peel_steps(a, row, c0, live, hi, mid, lo, 7);
  }
}

// Phase 1: the kept quads' work values into v (every load in flight
// before the first is used), and the NaN-propagating max of |work| over
// the thread's quads.
template <typename In, typename Acc, typename Work>
__device__ __forceinline__ Work load_max(const Rows& a, bool fold, int row,
                                         int q0, int q1,
                                         Work v[kKeep][4]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int quad = q0 + tid + j * kThreads;
    if (quad < q1) load_work<In, Acc, Work>(a, fold, row, quad, v[j]);
  }
  Work mx = 0;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (q0 + tid + j * kThreads < q1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = peel::nanmax(absval(v[j][e]), mx);
    }
  }
  for (int quad = q0 + tid + kKeep * kThreads; quad < q1;
       quad += kThreads) {
    Work w[4];
    load_work<In, Acc, Work>(a, fold, row, quad, w);
#pragma unroll
    for (int e = 0; e < 4; ++e) mx = peel::nanmax(absval(w[e]), mx);
  }
  return mx;
}

__device__ __forceinline__ double warp_nanmax(double m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = peel::nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// In: x's type; Acc: the accumulation type (x is cast to it and multiplied
// by u in it); Work: the type the row is peeled in.
template <typename In, typename Acc, typename Work>
__global__ void __launch_bounds__(kThreads)
slice_rows_kernel(const Rows a) {
  __shared__ double warp_max[kWarps];
  __shared__ double cta_max;
  __shared__ double row_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / a.split, part = blockIdx.x % a.split;
  const int nq = (a.n + 3) / 4;
  const int per = (nq + a.split - 1) / a.split;
  const int q0 = part * per, q1 = min(nq, q0 + per);
  const bool fold = a.u != nullptr;

  // ---- 1. load, fold, max ----
  Work v[kKeep][4];
  const Work mx = load_max<In, Acc, Work>(a, fold, row, q0, q1, v);
  const double mw = warp_nanmax((double)mx);
  if (lane == 0) warp_max[warp] = mw;
  __syncthreads();
  if (warp == 0) {
    const double m = warp_nanmax(lane < kWarps ? warp_max[lane] : 0.0);
    if (lane == 0) cta_max = m;
  }
  // every CTA's max is written and visible to the cluster after this
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (warp == 0) {
    const double m = warp_nanmax(
        lane < a.split ? *cluster.map_shared_rank(&cta_max, lane) : 0.0);
    if (lane == 0) row_max = m;
  }
  // done with the other CTAs' shared memory; this CTA waits for them to be
  // done with its own only before it exits
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // ---- 2. grid, scale, planes ----
  constexpr bool kF32 = sizeof(Work) == 4;
  const double m = row_max;
  const double g = peel::grid2(m, kF32 ? kTinyF32 : kTinyF64);
  // a power of two, exact in the work type too (float32 work: g <= 2^129),
  // or 0 for an infinite grid
  const Work inv = (Work)__drcp_rn(g);
  const bool fast = m <= kMaxF64;      // finite (NaN fails)
  if (part == 0 && tid == 0) {
    if (a.sx_f32) {
      static_cast<float*>(a.sx)[row] = __double2float_rn(g);
    } else {
      static_cast<double*>(a.sx)[row] = g;
    }
  }
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int quad = q0 + tid + j * kThreads;
    if (quad < q1) peel_quad<Work>(a, row, quad, v[j], inv, fast);
  }
  for (int quad = q0 + tid + kKeep * kThreads; quad < q1;
       quad += kThreads) {
    Work w[4];
    load_work<In, Acc, Work>(a, fold, row, quad, w);
    peel_quad<Work>(a, row, quad, w, inv, fast);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kMode 0: float64 or float32 values (mid = lo = 0 for float32); 1: a
// float32 (hi, mid, lo) triple.  Rows are contiguous (ldc = 1).
template <typename In, int kMode>
__global__ void __launch_bounds__(kThreads) peel_kernel(const Rows a) {
  const int row = blockIdx.x / a.split, part = blockIdx.x % a.split;
  const int nq = (a.n + 3) / 4;
  const int per = (nq + a.split - 1) / a.split;
  const int q1 = min(nq, part * per + per);
  for (int quad = part * per + threadIdx.x; quad < q1; quad += kThreads) {
    const int c0 = 4 * quad;
    const int live = min(4, a.n - c0);
    const long long off = row * a.ldx + c0;
    double v[4];
    load4(static_cast<const In*>(a.x) + off, 1LL, a.vec_x, live, v);
    float hi[4], mid[4], lo[4];
    if constexpr (kMode == 1) {
      double m4[4], l4[4];
      load4(a.mid + off, 1LL, a.vec_x, live, m4);
      load4(a.lo + off, 1LL, a.vec_x, live, l4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __double2float_rn(v[e]);
        mid[e] = __double2float_rn(m4[e]);
        lo[e] = __double2float_rn(l4[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(In) == 8) {
          peel::split_f64(v[e], hi[e], mid[e], lo[e]);
        } else {
          hi[e] = __double2float_rn(v[e]);
          mid[e] = lo[e] = 0.0f;
        }
      }
    }
    peel_steps(a, row, c0, live, hi, mid, lo, a.bits);
  }
}

template <typename In, typename Acc, typename Work>
cudaError_t launch_fused(const Rows& a, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.k * a.split));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, slice_rows_kernel<In, Acc, Work>, a);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
    }
  }
  return sms;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// The fused entry.  x: (k, n) float32 (x_f32) or float64 with element
// strides (ldx, ldc); acc_f32 / work_f32: the accumulation and working
// types (a float32 work type needs a float32 accumulation type); u: (n,)
// column grid in the accumulation type, contiguous, or null; out: (nx, k,
// n) int8, contiguous, 1 <= nx <= 8; sx: (k,) float32 (sx_f32) or float64.
// A row takes a cluster of 8 CTAs, or fewer for rows under 8 x 512 quads.
// One launch.
int slice_rows(const void* x, int x_f32, long long ldx, long long ldc,
               const void* u, int k, int n, int nx, int acc_f32,
               int work_f32, int sx_f32, int8_t* out, void* sx,
               void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaGetLastError();
  // a quad a thread at least, 8 CTAs (the portable cluster) at most
  const int nq = (n + 3) / 4;
  const int want = (nq + kThreads - 1) / kThreads;
  int split = 1;
  while (split < kPortable && split < want) split *= 2;
  if (nx < 1 || nx > peel::kPlanes ||
      (work_f32 && !acc_f32) || (long long)k * split > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int size = x_f32 ? 4 : 8;
  Rows a = {};
  a.x = x;
  a.u = u;
  a.out = out;
  a.sx = sx;
  a.ldx = ldx;
  a.ldc = ldc;
  a.k = k;
  a.n = n;
  a.nx = nx;
  a.bits = 7;
  a.split = split;
  a.sx_f32 = sx_f32 != 0;
  a.vec_x = ldc == 1 && aligned16(x) && (ldx * size) % 16 == 0;
  a.vec_u = u != nullptr && aligned16(u);
  a.vec_out = n % 4 == 0 && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_f32) {
    err = work_f32  ? launch_fused<float, float, float>(a, s)
          : acc_f32 ? launch_fused<float, float, double>(a, s)
                    : launch_fused<float, double, double>(a, s);
  } else {
    err = work_f32  ? launch_fused<double, float, float>(a, s)
          : acc_f32 ? launch_fused<double, float, double>(a, s)
                    : launch_fused<double, double, double>(a, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The pre-scaled entry.  mode 0: t float64; 1: t float32; 2: t, mid, lo
// float32 (the triple).  Each (rows, n), contiguous; out: (nx, rows, n)
// int8; bits * nx < 127.  One launch.
int peel_prescaled(const void* t, const float* mid, const float* lo,
                   int mode, long long rows, int n, int nx, int bits,
                   int8_t* out, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const int nq = (n + 3) / 4;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  // enough CTAs for two a multiprocessor, none without a quad a thread
  const long long want = (2LL * sms + rows - 1) / rows;
  const long long most = (nq + kThreads - 1) / kThreads;
  const long long split = want < most ? want : most;   // >= 1
  if (nx < 1 || bits * nx >= 127 || rows * split > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int size = mode == 0 ? 8 : 4;
  Rows a = {};
  a.x = t;
  a.mid = mid;
  a.lo = lo;
  a.out = out;
  a.ldx = n;
  a.ldc = 1;
  a.k = (int)rows;
  a.n = n;
  a.nx = nx;
  a.bits = bits;
  a.split = (int)split;
  a.vec_x = aligned16(t) && (mode != 2 || (aligned16(mid) && aligned16(lo)))
            && ((long long)n * size) % 16 == 0;
  a.vec_out = n % 4 == 0 && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(rows * split));
  if (mode == 0) {
    peel_kernel<double, 0><<<grid, kThreads, 0, s>>>(a);
  } else if (mode == 1) {
    peel_kernel<float, 0><<<grid, kThreads, 0, s>>>(a);
  } else {
    peel_kernel<float, 1><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* peel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
