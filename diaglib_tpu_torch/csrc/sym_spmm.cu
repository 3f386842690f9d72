// Kernel K1: the symmetric sliced SpMM, level sums of int8 slice products.
//
// Replaces the TPU kernel diaglib_tpu/ops/bsr_sliced_sym.py::_sym_kernel
// (launched by sym_sliced_matvec.bucket_call).  Wrapper:
// diaglib_tpu_torch/ops/bsr_sliced_sym.py::sym_spmm; plain version:
// sym_spmm_plain beside it.
//
// The store keeps the upper triangle of a symmetric block matrix: entry e at
// block (r, c), r <= c, holds the planes of T_e = A(r, c)^T side by side,
// plane i in columns [i B, (i+1) B) of a (B, width B) int8 block.  For every
// pair of x plane ix and stored plane i whose level lev = plane_off + i + ix
// is below nlev, the entry adds
//   direct:  acc[lev, :, r B + j] += sum_l xs[ix, :, c B + l] T_e[l, i B + j]
//   mirror:  acc[lev, :, c B + j] += sum_l xs[ix, :, r B + l] T_e[j, i B + l]
// (the mirror only off the diagonal, r != c).
//
// The TPU kernel walks the entries in order on one core and keeps the whole
// (nlev k, n) accumulator in VMEM.  Here one CTA owns one (output block row
// r, tile of 64 output columns, tile of 16 rows of x) and walks r's work
// list: the bucket's entries with rows == r (direct) and its off-diagonal
// entries with cols == r (mirror), items [item_start[r], item_start[r+1])
// of `items`, each 2 e + (1 for the mirror).  The wrapper derives the list
// from rows and cols (bsr_sliced_sym.py::sym_worklist).  The CTA keeps its
// sums in registers and adds them into acc with a plain read-add-write:
// within a launch each output has one owner, so no atomics; both plane
// buckets add into the same accumulator, one launch each, which the caller
// zeroes.
//
// The products are int8 tensor-core MMAs (mma.sync m16n8k32 s8 x s8 ->
// s32), the strips and x's planes streamed through a ring of cp.async
// stages: the tile routine of sliced_mma.cuh, shared with kernels K5 and
// K6.  Its floor on the H100 is reading the store with each off-diagonal
// entry's used planes twice, once a direction (at the f64 tier 3.6 GB a
// matvec of the flagship operator, 1.09 ms at 3.35 TB/s), beside 43 plane
// pairs of (16 x 512) (512 x 512) int8 products an entry a direction on
// the tensor cores; it runs at about 40 % of that floor (sliced_mma.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sliced_mma.cuh"

namespace {

using sliced_mma::kKC;
using sliced_mma::kTJ;
using sliced_mma::kThreads;

template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
sym_spmm_kernel(const int8_t* __restrict__ xs,
                const int8_t* __restrict__ slices,
                const int* __restrict__ rows, const int* __restrict__ cols,
                const int* __restrict__ items,
                const int* __restrict__ item_start, int* __restrict__ acc,
                int k, int n, int B, int width, int nx, int na, int nlev,
                int plane_off) {
  extern __shared__ __align__(16) int8_t smem[];
  const int r = blockIdx.y;
  const int p0 = item_start[r], p1 = item_start[r + 1];
  if (p0 >= p1) return;                  // nothing adds to this block row
  const sliced_mma::Tile t{xs, slices, k, (int)blockIdx.z * kKC, n, B,
                           width, nx, na, (int)blockIdx.x * kTJ};
  auto item = [items, rows, cols](int p) {
    const int v = items[p];
    const int e = v >> 1, mirror = v & 1;
    return sliced_mma::Item{e, mirror ? rows[e] : cols[e], mirror};
  };
  int32_t sums[C::kMaxLev][2][4];
  sliced_mma::tile_sums<C>(smem, t, item, p0, p1, nlev - plane_off, sums);
  sliced_mma::store_sums<C, true>(acc, sums, plane_off, nlev, k, t.k0, n,
                                  (size_t)r * B + t.j0);
}

}  // namespace

extern "C" {

// xs: (nx, k, n) int8; slices: (m, B, width B) int8; rows, cols: (m,)
// int32; items: int32 work list, item_start: (n / B + 1,) int32 (see
// above); acc: (nlev, k, n) int32, added into.  The caller checks the
// shapes: B % 64 == 0, n % B == 0, nx <= 8, na <= min(width, 8),
// nlev <= plane_off + 9, and xs, slices and acc 16-byte aligned.
int sym_spmm(const int8_t* xs, const int8_t* slices, const int* rows,
             const int* cols, const int* items, const int* item_start,
             int* acc, int k, int n, int B, int width, int nx, int na,
             int nlev, int plane_off, void* stream) {
  using sliced_mma::Narrow;
  using sliced_mma::Wide;
  if (n == 0 || k == 0 || na <= 0 || plane_off >= nlev) return 0;
  static int smem_narrow = 0, smem_wide = 0;
  // column tiles fastest: the CTAs of a block row run together and read
  // the same rows of its entries
  const dim3 grid(B / kTJ, (unsigned)(n / B), (k + kKC - 1) / kKC);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (Narrow::serves(nx, na, nlev - plane_off)) {
    const int smem = Narrow::smem_bytes(nx, na);
    err = sliced_mma::allow_smem(sym_spmm_kernel<Narrow>, smem, smem_narrow);
    if (err) return err;
    sym_spmm_kernel<Narrow><<<grid, kThreads, smem, s>>>(
        xs, slices, rows, cols, items, item_start, acc, k, n, B, width, nx,
        na, nlev, plane_off);
  } else {
    const int smem = Wide::smem_bytes(nx, na);
    err = sliced_mma::allow_smem(sym_spmm_kernel<Wide>, smem, smem_wide);
    if (err) return err;
    sym_spmm_kernel<Wide><<<grid, kThreads, smem, s>>>(
        xs, slices, rows, cols, items, item_start, acc, k, n, B, width, nx,
        na, nlev, plane_off);
  }
  return (int)cudaGetLastError();
}

const char* sym_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
