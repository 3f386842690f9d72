// Device code of the general sliced SpMM, shared by kernel K5
// (sliced_spmm.cu) and kernel K6 (group_spmm.cu), so that both add the
// same int8 plane products in the same order.
//
// A store entry e at block (r, c) holds the planes of T_e = A(r, c)^T on its
// row's grid side by side, plane i in columns [i B, (i+1) B) of a
// (B, width B) int8 block, of which the leading na planes are used (the
// float32 tier reads a prefix).  For every pair of x plane ix and stored
// plane i whose level lev = i + ix is below nlev, the entry adds
//   acc[lev, :, r B + j] += sum_l xs[ix, :, c B + l] T_e[l, i B + j].
//
// One CTA owns one (block row r, tile of 64 output columns, tile of 16 rows
// of x) and walks the row's entries [e0, e1), keeping the sums in
// registers, so it writes each of its outputs once: no atomics, no zeroing
// pass, a deterministic result, and a row with no entry writes zeros.  The
// x planes are n_x wide and the output n_out wide; K5 has one n for both,
// K6 reads a rank's x shard and writes one more block row (its padding
// row).  The kernel and its launch are here too: each of the two sources
// compiles its own copy behind its own C entry.
//
// For each entry the CTA stages the x planes of block column c in shared
// memory (nx 16 B bytes, 64 KB at the f64 tier's nx = 8, B = 512) and,
// plane by plane, the entry's B x 64 strip transposed to [column][l], with
// rows padded by 16 bytes.  Only the pairs with lev < nlev are computed.
// Thread (j, g) owns output column j and rows g, g+4, g+8, g+12 and keeps
// their sums for every level in registers; the loops over planes and x
// planes are unrolled, so the level index is static.  The products are
// __dp4a (4 int8 products a lane) on the CUDA cores, kernel K1's
// arithmetic (csrc/sym_spmm.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sliced {

constexpr int kTJ = 64;                 // output columns per CTA
constexpr int kKC = 16;                 // rows of x per CTA
constexpr int kKG = 4;                  // row groups; kKC / kKG rows a thread
constexpr int kRows = kKC / kKG;
constexpr int kThreads = kTJ * kKG;     // 256
constexpr int kMaxNx = 8;
constexpr int kMaxPlanes = 8;
constexpr int kMaxLev = 9;

// Dynamic shared memory of a CTA: the x planes and one transposed strip.
inline int smem_bytes(int nx, int B) { return nx * kKC * B + kTJ * (B + 16); }

// The tile of CTA (blockIdx.y, blockIdx.z) for block row r over the entries
// [e0, e1).  xs: (nx, k, n_x) int8; slices: (entries, B, width B) int8;
// cols: block columns into xs; acc: (nlev, k, n_out) int32.
__device__ __forceinline__ void level_sums_tile(
    int8_t* smem, const int8_t* __restrict__ xs,
    const int8_t* __restrict__ slices, const int* __restrict__ cols,
    int* __restrict__ acc, int r, int e0, int e1, int k, int n_x, int n_out,
    int B, int width, int nx, int na, int nlev) {
  const int j0 = blockIdx.y * kTJ;
  const int k0 = blockIdx.z * kKC;
  const int kc = min(kKC, k - k0);

  int8_t* xs_s = smem;                   // [nx][kKC][B]
  const int tstride = B + 16;
  int8_t* t_s = smem + nx * kKC * B;     // [kTJ][B + 16]
  const int tid = threadIdx.x;
  const int j = tid % kTJ;
  const int g = tid / kTJ;
  const int vrow = B / 16;               // 16-byte vectors per row of B
  const size_t rstride = (size_t)width * B;

  int sums[kMaxLev][kRows];
#pragma unroll
  for (int lev = 0; lev < kMaxLev; ++lev)
#pragma unroll
    for (int q = 0; q < kRows; ++q) sums[lev][q] = 0;

  for (int e = e0; e < e1; ++e) {
    const int c = cols[e];
    __syncthreads();                     // the last entry's tiles are read
    for (int v = tid; v < nx * kKC * vrow; v += kThreads) {
      const int row = v / vrow;
      const int c16 = v % vrow;
      const int ix = row / kKC;
      const int kk = row % kKC;
      int4 val = make_int4(0, 0, 0, 0);
      if (kk < kc) {
        val = *reinterpret_cast<const int4*>(
            xs + ((size_t)(ix * k + k0 + kk) * n_x + (size_t)c * B) +
            c16 * 16);
      }
      *reinterpret_cast<int4*>(xs_s + (size_t)row * B + c16 * 16) = val;
    }
    const int8_t* blk = slices + (size_t)e * B * rstride;

#pragma unroll
    for (int i = 0; i < kMaxPlanes; ++i) {
      if (i < na && i < nlev) {              // uniform over the CTA
        __syncthreads();                     // x staged / last strip read
        // t_s[jj][l] = T_e[l, i B + j0 + jj]
        for (int v = tid; v < B * (kTJ / 4); v += kThreads) {
          const int l = v / (kTJ / 4);
          const int jj = (v % (kTJ / 4)) * 4;
          const char4 q4 = *reinterpret_cast<const char4*>(
              blk + l * rstride + i * B + j0 + jj);
          t_s[(jj + 0) * tstride + l] = q4.x;
          t_s[(jj + 1) * tstride + l] = q4.y;
          t_s[(jj + 2) * tstride + l] = q4.z;
          t_s[(jj + 3) * tstride + l] = q4.w;
        }
        __syncthreads();
        const int nxi = min(nx, nlev - i);
        const int8_t* trow = t_s + j * tstride;
        for (int l16 = 0; l16 < vrow; ++l16) {
          const int4 t = *reinterpret_cast<const int4*>(trow + l16 * 16);
#pragma unroll
          for (int ix = 0; ix < kMaxNx; ++ix) {
            if (i + ix < kMaxLev && ix < nxi) {
#pragma unroll
              for (int q = 0; q < kRows; ++q) {
                const int4 x = *reinterpret_cast<const int4*>(
                    xs_s + (size_t)(ix * kKC + g + kKG * q) * B + l16 * 16);
                int a = sums[i + ix][q];
                a = __dp4a(x.x, t.x, a);
                a = __dp4a(x.y, t.y, a);
                a = __dp4a(x.z, t.z, a);
                a = __dp4a(x.w, t.w, a);
                sums[i + ix][q] = a;
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int lev = 0; lev < kMaxLev; ++lev) {
    if (lev < nlev) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int kk = g + kKG * q;
        if (kk < kc) {
          acc[(size_t)(lev * k + k0 + kk) * n_out + (size_t)r * B + j0 + j] =
              sums[lev][q];
        }
      }
    }
  }
}

namespace {

// Grid (n_out / B, B / kTJ, ceil(k / kKC)): block row blockIdx.x walks its
// entries from row_start[r] to the next row's start (the last row to m).
__global__ void __launch_bounds__(kThreads)
level_sums_kernel(const int8_t* __restrict__ xs,
                  const int8_t* __restrict__ slices,
                  const int* __restrict__ cols,
                  const int* __restrict__ row_start, int* __restrict__ acc,
                  int m, int k, int n_x, int n_out, int B, int width, int nx,
                  int na, int nlev) {
  extern __shared__ __align__(16) int8_t smem[];
  const int nbr_out = n_out / B;
  const int r = blockIdx.x;
  const int e0 = row_start[r];
  const int e1 = r + 1 < nbr_out ? row_start[r + 1] : m;
  level_sums_tile(smem, xs, slices, cols, acc, r, e0, e1, k, n_x, n_out, B,
                  width, nx, na, nlev);
}

}  // namespace

// Launches the level sums on `stream`; returns a cudaError_t.  xs: (nx, k,
// n_x) int8; slices: (m, B, width B) int8; cols: (m,) int32 block columns
// into xs; row_start: (n_out / B,) int32, the first entry of each output
// block row (rows sorted); acc: (nlev, k, n_out) int32, written whole.  The
// caller checks the shapes: B % 64 == 0, B <= 1024, n_x % B == 0,
// n_out % B == 0, 0 < nx <= 8, 0 < na <= min(width, 8), 0 < nlev <= 9.
inline int launch_level_sums(const int8_t* xs, const int8_t* slices,
                             const int* cols, const int* row_start, int* acc,
                             int m, int k, int n_x, int n_out, int B,
                             int width, int nx, int na, int nlev,
                             void* stream) {
  if (k == 0 || n_out == 0) return 0;
  const int smem = smem_bytes(nx, B);
  cudaError_t err = cudaFuncSetAttribute(
      level_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(n_out / B), B / kTJ, (k + kKC - 1) / kKC);
  level_sums_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      xs, slices, cols, row_start, acc, m, k, n_x, n_out, B, width, nx, na,
      nlev);
  return (int)cudaGetLastError();
}

}  // namespace sliced
