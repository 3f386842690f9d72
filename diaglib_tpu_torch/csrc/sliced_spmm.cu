// Kernel K5: the general sliced SpMM, level sums of int8 slice products.
//
// Replaces the TPU kernels diaglib_tpu/ops/bsr_sliced.py::_sliced_kernel
// and ::_sliced_kernel_resident (launched by _sliced_spmm).  Wrapper:
// diaglib_tpu_torch/ops/bsr_sliced.py::sliced_spmm; plain version:
// sliced_spmm_plain beside it.
//
// The store keeps every entry of a block matrix once: entry e at block
// (r, c) holds the planes of T_e = A(r, c)^T on its row's grid.  The device
// code (the planes, the levels, the CTA's tile) is in sliced_spmm.cuh,
// shared with kernel K6 (group_spmm.cu).
//
// The TPU kernels walk the entries in order on one core: one zeroes its
// output tile at a row's first entry and revisits it, the other keeps the
// whole (nlev k, n) accumulator in VMEM.  Here one CTA owns one (block row
// r, tile of 64 output columns, tile of 16 rows of x) and walks its row's
// entries from row_start[r] to the next row's start, keeping the sums in
// registers, so it writes each of its outputs once: no atomics, no zeroing
// pass, a deterministic result, and an empty row writes zeros.
//
// The products run on the int8 tensor cores (mma.sync m16n8k32), the
// entries' strips streamed through a ring of cp.async stages (the tile
// routine of sliced_mma.cuh, shared with K1).  Its floor on the H100 is
// reading each entry's used planes (2 MiB at the f64 tier) from device
// memory once per 16 rows of x; on the band store of one entry a row each
// CTA waits on that one entry's strips.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sliced_spmm.cuh"

extern "C" {

// xs: (nx, k, n) int8; slices: (m, B, width B) int8; cols: (m,) int32;
// row_start: (n / B,) int32, the first entry of each block row (rows
// sorted); acc: (nlev, k, n) int32, written whole (n_x = n_out = n; see
// sliced::launch_level_sums for the shapes the caller checks).
int sliced_spmm(const int8_t* xs, const int8_t* slices, const int* cols,
                const int* row_start, int* acc, int m, int k, int n_x,
                int n_out, int B, int width, int nx, int na, int nlev,
                void* stream) {
  return sliced::launch_level_sums(xs, slices, cols, row_start, acc, m, k,
                                   n_x, n_out, B, width, nx, na, nlev,
                                   stream);
}

const char* sliced_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
