// Device code of the general sliced SpMM, shared by kernel K5
// (sliced_spmm.cu) and kernel K6 (group_spmm.cu), so that both add the
// same int8 plane products.
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
// The products are int8 tensor-core MMAs (mma.sync m16n8k32 s8 x s8 ->
// s32), the entries' strips and x's planes streamed through a ring of
// cp.async stages: the tile routine of sliced_mma.cuh, shared with kernel
// K1, each item here an entry's direct term.  Its floor on the H100 is
// reading the used planes from device memory once per 16 rows of x (at the
// f64 tier 2 MiB an entry at B = 512), beside 43 plane pairs of (16 x 512)
// (512 x 512) int8 products an entry on the tensor cores; it runs at 40-50 %
// of that floor on the 15-entry rows of the general store (sliced_mma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sliced_mma.cuh"

namespace sliced {

using sliced_mma::kKC;
using sliced_mma::kTJ;
using sliced_mma::kThreads;

namespace {

// Grid (B / kTJ, n_out / B, ceil(k / kKC)): block row blockIdx.y walks its
// entries from row_start[r] to the next row's start (the last row to m).
// xs: (nx, k, n_x) int8; slices: (m, B, width B) int8; cols: block columns
// into xs; acc: (nlev, k, n_out) int32.
template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
level_sums_kernel(const int8_t* __restrict__ xs,
                  const int8_t* __restrict__ slices,
                  const int* __restrict__ cols,
                  const int* __restrict__ row_start, int* __restrict__ acc,
                  int m, int k, int n_x, int n_out, int B, int width, int nx,
                  int na, int nlev) {
  extern __shared__ __align__(16) int8_t smem[];
  const int nbr_out = n_out / B;
  const int r = blockIdx.y;
  const int e0 = row_start[r];
  const int e1 = r + 1 < nbr_out ? row_start[r + 1] : m;
  const sliced_mma::Tile t{xs, slices, k, (int)blockIdx.z * kKC, n_x, B,
                           width, nx, na, (int)blockIdx.x * kTJ};
  auto entry = [cols](int e) { return sliced_mma::Item{e, cols[e], 0}; };
  int32_t sums[C::kMaxLev][2][4];
  sliced_mma::tile_sums<C>(smem, t, entry, e0, e1, nlev, sums);
  sliced_mma::store_sums<C, false>(acc, sums, 0, nlev, k, t.k0, n_out,
                                   (size_t)r * B + t.j0);
}

// Launches the level sums on `stream`; returns a cudaError_t.  xs: (nx, k,
// n_x) int8; slices: (m, B, width B) int8; cols: (m,) int32 block columns
// into xs; row_start: (n_out / B,) int32, the first entry of each output
// block row (rows sorted); acc: (nlev, k, n_out) int32, written whole.  The
// caller checks the shapes: B % 64 == 0, n_x % B == 0, n_out % B == 0,
// 0 < nx <= 8, 0 < na <= min(width, 8), 0 < nlev <= 9, and xs, slices and
// acc 16-byte aligned.
int launch_level_sums(const int8_t* xs, const int8_t* slices,
                      const int* cols, const int* row_start, int* acc, int m,
                      int k, int n_x, int n_out, int B, int width, int nx,
                      int na, int nlev, void* stream) {
  using sliced_mma::Narrow;
  using sliced_mma::Wide;
  if (k == 0 || n_out == 0) return 0;
  static int smem_narrow = 0, smem_wide = 0;
  // column tiles fastest: the CTAs of a block row run together and read
  // the same rows of its entries
  const dim3 grid(B / kTJ, (unsigned)(n_out / B), (k + kKC - 1) / kKC);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (Narrow::serves(nx, na, nlev)) {
    const int smem = Narrow::smem_bytes(nx, na);
    err = sliced_mma::allow_smem(level_sums_kernel<Narrow>, smem, smem_narrow);
    if (err) return err;
    level_sums_kernel<Narrow><<<grid, kThreads, smem, s>>>(
        xs, slices, cols, row_start, acc, m, k, n_x, n_out, B, width, nx, na,
        nlev);
  } else {
    const int smem = Wide::smem_bytes(nx, na);
    err = sliced_mma::allow_smem(level_sums_kernel<Wide>, smem, smem_wide);
    if (err) return err;
    level_sums_kernel<Wide><<<grid, kThreads, smem, s>>>(
        xs, slices, cols, row_start, acc, m, k, n_x, n_out, B, width, nx, na,
        nlev);
  }
  return (int)cudaGetLastError();
}

}  // namespace (internal linkage: each library keeps its own smem records)

}  // namespace sliced
