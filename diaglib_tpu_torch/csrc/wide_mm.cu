// Kernel K3: the exact float64 wide-output product y = a(m, K) @ b(K, n)
// through 7-bit integer slices, for small K and wide n (the solvers' Ritz
// rotations and ortho projections).
//
// Replaces the TPU kernel diaglib_tpu/ops/slicing.py::_wide_kernel (launched
// by sliced_wide_mm).  Wrapper: diaglib_tpu_torch/ops/slicing.py
// ::sliced_wide_mm; plain version: sliced_wide_mm_plain beside it.
//
// One call, two launches.  The first puts a on its per-row grid and peels
// it into int8 planes, one CTA a (16-row tile, chunk of 32 k); a is at most
// a few tens of KB on the solvers' route.  The second does everything on
// b, which it reads in place through its strides (as the first reads a's
// transposed view for mTm).  It is launched as a programmatic dependent of
// the first, so it loads b and takes b's grid while a is peeled, and waits
// for a's planes only before its first product.
//
// In the second launch every warp works alone: it walks tiles of 8 columns
// of b (the MMA's N) with all rows of a (up to 16, the MMA's M; a larger m
// adds row tiles in y), so each element of b is read from device memory
// once and peeled once at m <= 16, and no barrier ties one warp to another:
// at any time some warps peel while others multiply or wait for memory.  A
// warp takes its first tile by its index and the next ones from a counter
// (the a-side launch zeroes it), one tile ahead.  For each tile:
//   1. b's grid: the tile's slab (all of K, up to kResident rows) sits in
//      the warp's shared memory, copied there with cp.async while the warp
//      worked on its previous tile; the warp takes the NaN-propagating max
//      of |b| per column and applies pow2_grid's rule (least power of two
//      >= max, clamped to [2^-1022, 2^1023], 1 below the smallest normal or
//      for NaN), doubled: sb per column.  A longer K reads the max from
//      device memory first and streams the slab a chunk at a time through
//      two stages (its second read hits L2);
//   2. K in chunks of 32: each element of b's chunk is divided by its grid
//      and cut into 8 int8 planes, laid out as the MMA operand wants (32 k
//      bytes per column); rows past K give zero planes.  As soon as a chunk
//      is peeled its stage takes the next tile's chunk;
//   3. the 43 plane pairs (i, p) with i + p < 9 run as int8 tensor-core
//      products, mma.sync m16n8k32 s8 x s8 -> s32, into 9 exact int32 level
//      accumulators per output (|q| <= 64; the wrapper's K bound keeps the
//      level sums in int32); a's planes come straight from the scratch, a
//      few KB that stay in L1.  Chunk c's products run beside chunk c + 1's
//      peel, so the tensor cores and the float32 pipe work at once;
//   4. the levels are combined as the TPU kernel combines them: deepest
//      first, each level split exactly into (v >> 12) << 12 and its low 12
//      bits, weighted by 2^{-7(L+2)} in float32 (exact) and summed into a
//      float32 triple by a 2Sum cascade (round-to-nearest intrinsics, no
//      contraction into FMAs); the triple's float64 sum is scaled by sa[r]
//      and sb[j].  The plain version and the JAX kernel do the same
//      operations in the same order, so all three agree bit for bit.
//
// The grid rule and the peel are K2's (peel.cuh: peel::grid2, peel::peel8),
// the chain in a form that gives the same planes: the remainders are kept
// scaled by 2^{7(p+1)}, and each rint is the add of 1.5 * 2^23 (exact
// round-half-even for |x| <= 2^22), whose low byte is the plane's int8.
// That keeps the chain on the float32 pipe, with no conversion
// instructions but the triple's split.
//
// What bounds it on the H100: reading b once (8 K n bytes) and the float32
// peel of b (about 70 instructions an element); the 43 plane pairs are
// about 17 G int8 tensor operations at (15, 165) @ (165, 65536).

#include <cuda_runtime.h>
#include <stdint.h>

#include "peel.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNW = 8;          // columns of b a warp's tile: the MMA's N
constexpr int kMR = 16;         // rows of a a tile: the MMA's M
constexpr int kKC = 32;         // contraction chunk: the MMA's k
constexpr int kNS = peel::kPlanes;  // planes of each operand (8)
constexpr int kNLev = 9;        // levels kept: i + p < 9
constexpr int kBits = 7;
constexpr int kResident = 256;  // padded K up to which b's slab stays
constexpr double kTiny = 2.2250738585072014e-308;  // float64's least normal

// The scratch: a's planes [row tile][chunk][plane][kMR][kKC] int8, then sa
// [row tile][kMR] float64, then a tile counter [row tile] int32.
constexpr int kAChunk = kNS * kMR * kKC;          // 4 KB
// Each warp's shared memory: b's raw chunks (all, or two), then
constexpr int kRawW = kKC * kNW * 8;              // 2 KB a chunk
constexpr int kBsW = kNS * kNW * kKC;             // b planes, 2 KB a stage
constexpr int kWarpTail = 2 * kBsW                // + b planes, two stages
                          + 2 * kNW * 8           // + sb, 1/sb
                          + kMR * 8;              // + sa

__host__ __device__ constexpr int warp_smem(int raw_chunks) {
  return raw_chunks * kRawW + kWarpTail;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [k0, k0 + 32) of columns [j0, j0 + 8) of b into a warp's
// chunk laid out [32][kNW] float64; rows >= K and columns >= n are
// zero-filled.
__device__ __forceinline__ void stage_b(double* raw, const double* b,
                                        long long sb0, long long sb1, int K,
                                        int n, int j0, int k0, bool vec,
                                        int lane) {
#pragma unroll
  for (int q = 0; q < kKC * kNW / 2 / 32; ++q) {
    const int c = lane + 32 * q;                 // one column pair
    const int kl = c / (kNW / 2);
    const int jl = 2 * (c % (kNW / 2));
    const int k = k0 + kl, j = j0 + jl;
    const int live = k < K ? max(0, min(2, n - j)) : 0;
    const double* src = live ? b + k * sb0 + j * sb1 : b;
    double* dst = raw + kl * kNW + jl;
    if (vec) {
      cp_async16(dst, src, 8 * live);
    } else {
      cp_async8(dst, src, live >= 1 ? 8 : 0);
      cp_async8(dst + 1, live >= 2 ? src + sb1 : b, live >= 2 ? 8 : 0);
    }
  }
}

// Knuth's 2Sum in float32, exact: x + err == s + t
__device__ __forceinline__ void two_sum(float s, float t, float& x,
                                        float& err) {
  x = __fadd_rn(s, t);
  const float bb = __fsub_rn(x, s);
  err = __fadd_rn(__fsub_rn(s, __fsub_rn(x, bb)), __fsub_rn(t, bb));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The a side, one CTA a (chunk blockIdx.x, row tile blockIdx.y): thread
// (row, 4 k) takes its row's grid with its 7 neighbours, writes sa (chunk 0
// only) and peels its 4 k of the chunk, one word a plane.
__global__ void __launch_bounds__(kThreads)
wide_a_prep(const double* __restrict__ a, long long sa0, long long sa1,
            uint8_t* __restrict__ apl, double* __restrict__ sa_g,
            int* __restrict__ counter, int m, int K, int nchunks) {
  // the main launch may start now; it waits for this grid's writes before
  // it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int rt = blockIdx.y, c = blockIdx.x;
  const int row = tid / 8, part = tid % 8;
  const int r = rt * kMR + row;
  const bool live = r < m;
  const double* ar = a + (live ? r : 0) * sa0;
  double am = 0.0;
  if (live) {
    int k = part;
    for (; k + 56 < K; k += 64) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = ar[(k + 8 * u) * sa1];
#pragma unroll
      for (int u = 0; u < 8; ++u) am = peel::nanmax(fabs(v[u]), am);
    }
    for (; k < K; k += 8) am = peel::nanmax(fabs(ar[k * sa1]), am);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    am = peel::nanmax(am, __shfl_xor_sync(0xffffffffu, am, o));
  }
  const double g = peel::grid2(am, kTiny);
  if (c == 0 && part == 0) sa_g[r] = g;
  if (c == 0 && tid == 0) counter[rt] = 0;
  if (c >= nchunks) return;          // K = 0: the grids only
  const double inv = __drcp_rn(g);   // a power of two: exact
  const int kq = 4 * part;
  uint32_t q[4][kNS];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int k = c * kKC + kq + t;
    peel::peel8(__dmul_rn(live && k < K ? ar[k * sa1] : 0.0, inv), q[t]);
  }
  uint8_t* dst = apl + ((size_t)rt * nchunks + c) * kAChunk + row * kKC + kq;
#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    *reinterpret_cast<uint32_t*>(dst + p * kMR * kKC) =
        peel::pack4(q[0][p], q[1][p], q[2][p], q[3][p]);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
wide_mm_kernel(const double* __restrict__ b, long long sb0, long long sb1,
               const uint8_t* __restrict__ apl,
               const double* __restrict__ sa_g, int* __restrict__ counter,
               double* __restrict__ out, int m, int K, int n, int nchunks,
               bool resident, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nraw = resident ? nchunks : 2;
  unsigned char* mine = smem + warp * warp_smem(nraw);
  double* raw = reinterpret_cast<double*>(mine);
  uint8_t* bs = mine + nraw * kRawW;              // 2 x [kNS][kNW][kKC]
  double* sb_w = reinterpret_cast<double*>(bs + 2 * kBsW);
  double* inv_sb_w = sb_w + kNW;
  double* sa_w = inv_sb_w + kNW;

  const int ntiles = (n + kNW - 1) / kNW;
  const int nwarps = gridDim.x * kWarps;
  const int rt = blockIdx.y, r0 = rt * kMR;
  const uint8_t* apl_t = apl + (size_t)rt * nchunks * kAChunk;
  // lane (jl, rg): column jl; rows 8 rg .. 8 rg + 7 of each chunk in the
  // peel, rows rg, rg + 4, ... in the grid
  const int jl = lane % kNW, rg = lane / kNW;
  // lane (g, t4) in the MMA and the combine
  const int g = lane >> 2, t4 = lane & 3;

  // ---- 2. peel: b's 8 k of column jl in chunk c into 8 planes, 8 bytes
  // each, into the planes' stage c & 1 ----
  auto peel_chunk = [&](int c) {
    uint32_t w[kNS][2];
    if (c * kKC + 8 * rg < K) {
      const double inv_sb = inv_sb_w[jl];
      const double* src =
          raw + (resident ? c : (c & 1)) * (kKC * kNW) + 8 * rg * kNW + jl;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t q[4][kNS];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          peel::peel8(__dmul_rn(src[(4 * h + t) * kNW], inv_sb), q[t]);
        }
#pragma unroll
        for (int p = 0; p < kNS; ++p) {
          w[p][h] = peel::pack4(q[0][p], q[1][p], q[2][p], q[3][p]);
        }
      }
    } else {                         // rows past K: zero planes
#pragma unroll
      for (int p = 0; p < kNS; ++p) w[p][0] = w[p][1] = 0u;
    }
    uint8_t* dst = bs + (c & 1) * kBsW + jl * kKC + 8 * rg;
#pragma unroll
    for (int p = 0; p < kNS; ++p) {
      *reinterpret_cast<uint2*>(dst + p * kNW * kKC) =
          make_uint2(w[p][0], w[p][1]);
    }
  };

  int t = blockIdx.x * kWarps + warp;
  if (t >= ntiles) return;
  // the first tile's slab (or its first two chunks)
  for (int c = 0; c < (resident ? nchunks : min(2, nchunks)); ++c) {
    stage_b(raw + c * (kKC * kNW), b, sb0, sb1, K, n, t * kNW, c * kKC, vec,
            lane);
  }
  commit();
  bool first = true;

  while (t < ntiles) {
    const int j0 = t * kNW;
    // ---- 1. b's grid ----
    double mx = 0.0;
    if (resident) {
      wait_all();                    // this tile's slab
      __syncwarp();
      double m4[4] = {0.0, 0.0, 0.0, 0.0};   // four chains, not one
      int k = rg;
      for (; k + 12 < K; k += 16) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          m4[u] = peel::nanmax(fabs(raw[(k + 4 * u) * kNW + jl]), m4[u]);
        }
      }
      for (; k < K; k += 4) {
        m4[0] = peel::nanmax(fabs(raw[k * kNW + jl]), m4[0]);
      }
      mx = peel::nanmax(peel::nanmax(m4[0], m4[1]),
                        peel::nanmax(m4[2], m4[3]));
    } else {
      if (!first) {                  // the tile's first two chunks
        for (int c = 0; c < min(2, nchunks); ++c) {
          stage_b(raw + c * (kKC * kNW), b, sb0, sb1, K, n, j0, c * kKC, vec,
                  lane);
        }
        commit();
      }
      if (j0 + jl < n) {
        const double* col = b + (j0 + jl) * sb1;
        int k = rg;
        for (; k + 28 < K; k += 32) {
          double v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = col[(k + 4 * u) * sb0];
#pragma unroll
          for (int u = 0; u < 8; ++u) mx = peel::nanmax(fabs(v[u]), mx);
        }
        for (; k < K; k += 4) mx = peel::nanmax(fabs(col[k * sb0]), mx);
      }
      wait_all();                    // the chunks peel_chunk(0, 1) reads
      __syncwarp();
    }
    mx = peel::nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = peel::nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    if (first) {
      // a's side comes from the launch before this one, which may still
      // be running (programmatic dependent launch): wait for it before
      // the first read of a's planes, row grids and the tile counter
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      if (lane < kMR) sa_w[lane] = sa_g[r0 + lane];
      first = false;
    }
    if (lane < kNW) {
      const double gr = peel::grid2(mx, kTiny);
      sb_w[lane] = gr;
      inv_sb_w[lane] = __drcp_rn(gr);  // a power of two: exact
    }
    int next = 0;
    if (lane == 0) next = nwarps + atomicAdd(counter + rt, 1);
    next = __shfl_sync(0xffffffffu, next, 0);
    __syncwarp();

    int32_t acc[kNLev][4];
#pragma unroll
    for (int L = 0; L < kNLev; ++L)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[L][i] = 0;

    // At the top of iteration c, chunk c's planes are stored and b's chunk
    // c + 1 has landed (resident: the whole slab has).
    if (nchunks > 0) peel_chunk(0);
    for (int c = 0; c < nchunks; ++c) {
      if (!resident) wait_all();
      // ... for every lane, and every lane is done with chunk c - 1's
      // stages and with the peel of chunk c
      __syncwarp();
      if (resident) {
        // chunk c's stage is free: it takes the next tile's chunk c
        if (next < ntiles) {
          stage_b(raw + c * (kKC * kNW), b, sb0, sb1, K, n, next * kNW,
                  c * kKC, vec, lane);
        }
      } else if (c + 2 < nchunks) {
        stage_b(raw + (c & 1) * (kKC * kNW), b, sb0, sb1, K, n, j0,
                (c + 2) * kKC, vec, lane);
      }
      commit();
      if (c + 1 < nchunks) peel_chunk(c + 1);

      // ---- 3. the 43 plane pairs on the tensor cores ----
      // Lane (g, t4) reads 8 bytes, the k 8 t4 .. 8 t4 + 7 of its row /
      // column: the low word is the MMA's k slots 4 t4 .. 4 t4 + 3, the
      // high word 16 + 4 t4 ..; a and b agree on that order of k, so the
      // sums are the same.
      const uint8_t* ac = apl_t + (size_t)c * kAChunk + g * kKC + 8 * t4;
      const uint8_t* bc = bs + (c & 1) * kBsW + g * kKC + 8 * t4;
      uint32_t af[kNS][4];
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const uint2 lo =
            __ldg(reinterpret_cast<const uint2*>(ac + i * kMR * kKC));
        const uint2 hi = __ldg(
            reinterpret_cast<const uint2*>(ac + (i * kMR + 8) * kKC));
        af[i][0] = lo.x;
        af[i][1] = hi.x;
        af[i][2] = lo.y;
        af[i][3] = hi.y;
      }
#pragma unroll
      for (int p = 0; p < kNS; ++p) {
        const uint2 bf =
            *reinterpret_cast<const uint2*>(bc + p * kNW * kKC);
#pragma unroll
        for (int i = 0; i + p < kNLev && i < kNS; ++i) {
          mma_s8(acc[i + p], af[i], bf.x, bf.y);
        }
      }
    }

    // ---- 4. combine, deepest level first, and store ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = g + 8 * (i >> 1);
      const int jc = 2 * t4 + (i & 1);
      if (r0 + rl >= m || j0 + jc >= n) continue;
      float s_hi = 0.f, s_mid = 0.f, s_lo = 0.f;
#pragma unroll
      for (int L = kNLev - 1; L >= 0; --L) {
        // 2^{-7(L+2)}, exact in float32 (down to 2^-70)
        const float wl = __int_as_float((127 - kBits * (L + 2)) << 23);
        const int v = acc[L][i];
        const int vh = (v >> 12) << 12;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // both halves convert exactly: <= 19 and <= 12 significant bits
          const float t = __fmul_rn(__int2float_rn(h ? v - vh : vh), wl);
          float e, e2;
          two_sum(s_hi, t, s_hi, e);
          two_sum(s_mid, e, s_mid, e2);
          s_lo = __fadd_rn(s_lo, e2);
        }
      }
      const double y = __dadd_rn(__dadd_rn((double)s_hi, (double)s_mid),
                                 (double)s_lo);
      out[(size_t)(r0 + rl) * n + j0 + jc] =
          __dmul_rn(__dmul_rn(y, sa_w[rl]), sb_w[jc]);
    }
    t = next;
  }
  wait_all();
}

}  // namespace

extern "C" {

// Bytes of scratch wide_mm needs: a's planes, its grids, the tile counters.
long long wide_mm_scratch_bytes(int m, int K) {
  const long long tiles = (m + kMR - 1) / kMR;
  const long long nchunks = (K + kKC - 1) / kKC;
  return tiles * nchunks * kAChunk + tiles * kMR * 8 + tiles * 4;
}

// a: (m, K) float64 with element strides (sa0, sa1); b: (K, n) float64 with
// strides (sb0, sb1); out: (m, n) float64, contiguous; scratch:
// wide_mm_scratch_bytes(m, K) bytes, 16-byte aligned.  Two launches.
int wide_mm(const double* a, long long sa0, long long sa1, const double* b,
            long long sb0, long long sb1, double* out, void* scratch, int m,
            int K, int n, void* stream) {
  static int sms = 0;
  // resident CTAs an SM, by the raw chunks the launch stages
  static int per_sm[kResident / kKC + 1] = {};
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaFuncSetAttribute(
        wide_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWarps * warp_smem(kResident / kKC));
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (m > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tiles = (m + kMR - 1) / kMR;
    const int nchunks = (K + kKC - 1) / kKC;
    const bool resident = nchunks * kKC <= kResident;
    const int nraw = resident ? nchunks : 2;
    const int smem = kWarps * warp_smem(nraw);
    if (per_sm[nraw] == 0) {
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[nraw], wide_mm_kernel, kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      if (per_sm[nraw] == 0) return (int)cudaErrorInvalidConfiguration;
    }
    uint8_t* apl = static_cast<uint8_t*>(scratch);
    double* sa_g = reinterpret_cast<double*>(
        apl + (size_t)tiles * nchunks * kAChunk);
    int* counter = reinterpret_cast<int*>(sa_g + (size_t)tiles * kMR);
    wide_a_prep<<<dim3(max(1, nchunks), tiles), kThreads, 0, s>>>(
        a, sa0, sa1, apl, sa_g, counter, m, K, nchunks);
    const bool vec = sb1 == 1 && sb0 % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(b) & 15) == 0;
    // as many CTAs as are resident at once over all row tiles, and no warp
    // without a first tile
    const int ntiles = (n + kNW - 1) / kNW;
    const int grid_x = max(1, min((ntiles + kWarps - 1) / kWarps,
                                  per_sm[nraw] * sms / tiles));
    // launched while wide_a_prep runs: its warps' loads and grids overlap it
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid_x, tiles);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, wide_mm_kernel, b, sb0, sb1, (const uint8_t*)apl,
        (const double*)sa_g, counter, out, m, K, n, nchunks, resident, vec);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* wide_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
