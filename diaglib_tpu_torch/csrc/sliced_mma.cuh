// The int8 tensor-core tile routine of the sliced SpMMs: kernel K1
// (sym_spmm.cu) and, through sliced_spmm.cuh, kernels K5 and K6.
//
// An entry e at block (r, c) holds the planes of T_e side by side, plane i
// in columns [i B, (i+1) B) of a (B, width B) int8 block.  For every pair of
// x plane ix and stored plane i whose relative level rl = i + ix is below
// nlev_rel, one work item adds, for the CTA's 16 rows of x and 64 output
// columns [j0, j0 + 64) of its block row,
//   direct (src = c):  sums[rl][:, j] += sum_l xs[ix, :, c B + l] T_e[l, i B + j]
//   mirror (src = r):  sums[rl][:, j] += sum_l xs[ix, :, r B + l] T_e[j, i B + l]
// The CTA walks a list of items (each an entry, the block column of x it
// reads and its direction) and keeps its sums in registers; the kernels
// write or add them into their int32 levels once, at the end.
//
// The products are mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (no
// .satfinite: the sums are the exact integers of the plain versions, which
// the wrappers' int32 guards keep in range).  M is the CTA's 16 rows of x
// (one x plane; rows past k are zeros), K 32 of the contraction index l, N
// 8 output columns.  Each of the 4 warps owns 16 output columns (two N
// tiles) and every level: 9 levels x 2 tiles x 4 registers.  One B fragment
// (plane i) serves every x plane ix, one A fragment (x plane ix) every
// plane i.  The fragments follow kernel K3's mma_s8 (wide_mm.cu): lane
// (g, t4) reads the 8 bytes l = 8 t4 .. 8 t4 + 7 of its row of A and of its
// column of B; the low word fills the MMA's k slots 4 t4 .., the high word
// 16 + 4 t4 .., the same order of l in both operands.
//
// Both operands need l contiguous.  x planes and the mirror term's T_e[j, i
// B + l] have it.  The direct term's T_e[l, i B + j] does not, and sm_90 has
// no 8-bit ldmatrix.trans: each warp transposes its 16 columns of the
// stage's strip once, 4 x 4 bytes a lane with __byte_perm, into a
// warp-private buffer that then serves all 16 rows and all x planes.  The
// raw direct strip sits in shared memory with row l at slot 8 (l % 4) + l /
// 4 and the transposed one with a pitch of 20 words, so that neither the
// transpose's reads and writes nor the fragment reads have bank conflicts.
//
// A stage is one item's l-chunk of 32: the na planes' 32 x 64 strip (2 KB
// a plane) and the nx x planes' 16 x 32 piece (512 B a plane), copied with
// 16-byte cp.async into a ring of stages, so that all but one are in
// flight, across items alike, while one is multiplied; one barrier a stage.
//
// Two instantiations (Config below): the float32 tier's (at most 4 x
// planes, 4 planes, 4 levels) keeps 32 sums a thread and runs 4 CTAs an
// SM; the wide one (the float64 tier) keeps 72 and runs 2.  On the H100
// both run well above their byte bounds: ablations of the copies and of
// the products (each alone) took most of the kernel's time apiece, so
// neither HBM nor the tensor cores are saturated; the 16-byte copies of
// 32- and 64-byte row pieces and the per-stage barrier are the suspects
// (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sliced_mma {

constexpr int kWarps = 4;                // 16 columns each: two N tiles
constexpr int kTJ = 16 * kWarps;         // output columns a CTA
constexpr int kKC = 16;                  // rows of x a CTA: the MMA's M
constexpr int kLC = 32;                  // l a stage: the MMA's K
constexpr int kThreads = 32 * kWarps;
constexpr int kPlaneBytes = kLC * kTJ;   // a plane's strip a stage
constexpr int kXPlaneBytes = kKC * kLC;  // an x plane's piece a stage
constexpr int kTPitch = 20;              // words an l-quad of a transposed strip
constexpr int kTPlaneWords = (kLC / 4) * kTPitch;   // a warp's plane

// The most x planes, stored planes and relative levels a kernel
// instantiation serves, its ring's stages and its CTAs an SM.  The sums
// take MaxLev x 8 registers a thread, so the float32 tier (4 x planes, 4
// planes, 4 levels) gets its own instantiation, with twice the CTAs an SM.
template <int MaxNx, int MaxPlanes, int MaxLev, int Stages, int MinBlocks>
struct Config {
  static constexpr int kMaxNx = MaxNx;
  static constexpr int kMaxPlanes = MaxPlanes;
  static constexpr int kMaxLev = MaxLev;
  static constexpr int kNS = Stages;
  static constexpr int kMinBlocks = MinBlocks;

  __host__ __device__ static bool serves(int nx, int na, int nlev_rel) {
    return nx <= MaxNx && na <= MaxPlanes && nlev_rel <= MaxLev;
  }
  // Dynamic shared memory of a CTA: the ring, then the warps' transposed
  // strips.
  __host__ __device__ static int smem_bytes(int nx, int na) {
    return Stages * stage_bytes(nx, na) + kWarps * na * kTPlaneWords * 4;
  }
  __host__ __device__ static int stage_bytes(int nx, int na) {
    return na * kPlaneBytes + nx * kXPlaneBytes;
  }
};

// Stages and CTAs an SM measured on an H100 at the flagship's shapes: the
// wide instantiation ran faster with 2 stages than with 3 or 4.  Shared
// memory does not depend on B: at most 61,440 bytes (wide), 51,200
// (narrow).
using Wide = Config<8, 8, 9, 2, 2>;      // the float64 tier and any other
using Narrow = Config<4, 4, 4, 4, 4>;    // the float32 tier

struct Item {
  int e;        // entry
  int src;      // block column of x the item reads
  int mirror;   // 1: the mirror term
};

// What a CTA's stages read.  xs: (nx, k, n_x) int8; slices: (entries, B,
// width B) int8.
struct Tile {
  const int8_t* xs;
  const int8_t* slices;
  int k, k0, n_x, B, width, nx, na, j0;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start this thread's copies of item `it`'s l-chunk [l0, l0 + 32) into
// stage `st`.  Direct strips: plane i, warp w's 16 columns, row l at slot
// 8 (l % 4) + l / 4 (16 bytes a slot).  Mirror strips: plane i, row jj
// (64 of them), 32 bytes of l.  x: plane ix, row kk, 32 bytes of l, zeros
// for rows past k.
__device__ __forceinline__ void start_copies(int8_t* st, const Tile& t,
                                             const Item it, int l0) {
  const size_t rstride = (size_t)t.width * t.B;
  const int8_t* blk = t.slices + (size_t)it.e * t.B * rstride;
  for (int c = threadIdx.x; c < t.na * (kPlaneBytes / 16); c += kThreads) {
    const int i = c / (kPlaneBytes / 16), q = c % (kPlaneBytes / 16);
    const int8_t* src;
    int8_t* dst = st + i * kPlaneBytes;
    if (!it.mirror) {
      // each 8 neighbouring threads copy rows l = 4 m + lq, m = 0 .. 7, of
      // one warp's columns: 8 distinct slots mod 8, so the 16-byte writes
      // into shared memory have no bank conflicts
      const int m = q % 8, w = q / 8 % kWarps, lq = q / (8 * kWarps);
      const int l = 4 * m + lq;
      src = blk + (size_t)(l0 + l) * rstride + i * t.B + t.j0 + 16 * w;
      dst += w * (kLC * 16) + (8 * (l % 4) + l / 4) * 16;
    } else {
      const int jj = q / 2, h = q % 2;
      src = blk + (size_t)(t.j0 + jj) * rstride + i * t.B + l0 + 16 * h;
      dst += jj * kLC + 16 * h;
    }
    cp_async16(dst, src, 16);
  }
  int8_t* xst = st + t.na * kPlaneBytes;
  for (int c = threadIdx.x; c < t.nx * (kXPlaneBytes / 16); c += kThreads) {
    const int ix = c / (kXPlaneBytes / 16);
    const int kk = (c / 2) % kKC, h = c % 2;
    const bool live = t.k0 + kk < t.k;
    const int8_t* src =
        live ? t.xs + (size_t)(ix * t.k + t.k0 + kk) * t.n_x +
                   (size_t)it.src * t.B + l0 + 16 * h
             : t.xs;
    cp_async16(xst + (ix * kKC + kk) * kLC + 16 * h, src, live ? 16 : 0);
  }
}

// The products of one stage into sums[rl][N tile][4]; tw is the warp's
// transposed-strip buffer (na planes of kTPlaneWords words).
template <class C>
__device__ __forceinline__ void consume(const int8_t* st, uint32_t* tw,
                                        bool mirror, int nx, int na,
                                        int nlev_rel,
                                        int32_t sums[C::kMaxLev][2][4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int8_t* xst = st + na * kPlaneBytes;
  uint32_t af[C::kMaxNx][4];
#pragma unroll
  for (int ix = 0; ix < C::kMaxNx; ++ix) {
    if (ix < nx) {
      const uint2 lo = *reinterpret_cast<const uint2*>(
          xst + (ix * kKC + g) * kLC + 8 * t4);
      const uint2 hi = *reinterpret_cast<const uint2*>(
          xst + (ix * kKC + g + 8) * kLC + 8 * t4);
      af[ix][0] = lo.x;
      af[ix][1] = hi.x;
      af[ix][2] = lo.y;
      af[ix][3] = hi.y;
    }
  }
  if (!mirror) {
    // lane (lb, jb) turns rows l = 4 lb .. 4 lb + 3 x columns 4 jb .. 4 jb
    // + 3 into columns x l-quad lb
    const int lb = lane & 7, jb = lane >> 3;
#pragma unroll
    for (int i = 0; i < C::kMaxPlanes; ++i) {
      if (i < na) {
        const uint32_t* raw = reinterpret_cast<const uint32_t*>(
            st + i * kPlaneBytes + w * (kLC * 16));
        const uint32_t r0 = raw[(0 + lb) * 4 + jb];
        const uint32_t r1 = raw[(8 + lb) * 4 + jb];
        const uint32_t r2 = raw[(16 + lb) * 4 + jb];
        const uint32_t r3 = raw[(24 + lb) * 4 + jb];
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
        const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
        const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
        *reinterpret_cast<uint4*>(tw + i * kTPlaneWords + lb * kTPitch +
                                  4 * jb) =
            make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                       __byte_perm(t1, t3, 0x5410),
                       __byte_perm(t1, t3, 0x7632));
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < C::kMaxPlanes; ++i) {
    if (i < na && i < nlev_rel) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (!mirror) {
          const uint32_t* tp = tw + i * kTPlaneWords + 8 * nt + g;
          b[nt][0] = tp[(2 * t4) * kTPitch];
          b[nt][1] = tp[(2 * t4 + 1) * kTPitch];
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(
              st + i * kPlaneBytes + (16 * w + 8 * nt + g) * kLC + 8 * t4);
          b[nt][0] = v.x;
          b[nt][1] = v.y;
        }
      }
#pragma unroll
      for (int ix = 0; ix < C::kMaxNx; ++ix) {
        if (i + ix < C::kMaxLev && ix < nx && i + ix < nlev_rel) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_s8(sums[i + ix][nt], af[ix], b[nt][0], b[nt][1]);
          }
        }
      }
    }
  }
}

// The CTA's sums over the items [p0, p1): items(p) gives item p.  On return
// sums[rl] holds relative level rl (zeros where no item adds).
template <class C, class Items>
__device__ __forceinline__ void tile_sums(int8_t* smem, const Tile& t,
                                          Items items, int p0, int p1,
                                          int nlev_rel,
                                          int32_t sums[C::kMaxLev][2][4]) {
#pragma unroll
  for (int rl = 0; rl < C::kMaxLev; ++rl)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sums[rl][nt][q] = 0;

  constexpr int kNS = C::kNS;
  const int spi = t.B / kLC;                 // stages an item
  const int total = (p1 - p0) * spi;
  const int sb = C::stage_bytes(t.nx, t.na);
  uint32_t* tw = reinterpret_cast<uint32_t*>(smem + kNS * sb) +
                 (threadIdx.x >> 5) * t.na * kTPlaneWords;
  auto fill_stage = [&](int s) {
    start_copies(smem + s % kNS * sb, t, items(p0 + s / spi), s % spi * kLC);
  };
  for (int s = 0; s < kNS - 1; ++s) {
    if (s < total) fill_stage(s);
    commit();
  }
  for (int s = 0; s < total; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kNS - 2) : "memory");
    // stage s has landed for every thread, and every thread is done with
    // stage s - 1, whose slot the next copy takes
    __syncthreads();
    if (s + kNS - 1 < total) fill_stage(s + kNS - 1);
    commit();
    consume<C>(smem + s % kNS * sb, tw, items(p0 + s / spi).mirror, t.nx,
               t.na, nlev_rel, sums);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Write (kAdd false) or add (true) the sums into levels lev0 + rl < nlev of
// acc (nlev, k, n_out) int32, at columns col0 .. col0 + 63 of rows k0 ..
// k0 + 15 below k.
template <class C, bool kAdd>
__device__ __forceinline__ void store_sums(int* __restrict__ acc,
                                           const int32_t sums[C::kMaxLev][2][4],
                                           int lev0, int nlev, int k, int k0,
                                           int n_out, size_t col0) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int rl = 0; rl < C::kMaxLev; ++rl) {
    if (lev0 + rl < nlev) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = g + 8 * h;
        if (k0 + kk < k) {
          int* row = acc + (size_t)((lev0 + rl) * k + k0 + kk) * n_out + col0 +
                     16 * w + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            int2* p = reinterpret_cast<int2*>(row + 8 * nt);
            int2 v = make_int2(sums[rl][nt][2 * h], sums[rl][nt][2 * h + 1]);
            if (kAdd) {
              const int2 o = *p;
              // unsigned: the wrappers' guards keep the sums in range
              v.x = (int)((unsigned)v.x + (unsigned)o.x);
              v.y = (int)((unsigned)v.y + (unsigned)o.y);
            }
            *p = v;
          }
        }
      }
    }
  }
}

// Sets the kernel's dynamic shared memory limit to at least smem bytes, once
// a size: `done` is the caller's record of what is set.  Returns a
// cudaError_t.
template <class Kernel>
inline int allow_smem(Kernel kernel, int smem, int& done) {
  if (smem <= done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done = smem;
  return (int)err;
}

}  // namespace sliced_mma
