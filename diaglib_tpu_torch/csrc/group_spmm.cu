// Kernel K6: one ring-offset group's level sums on one rank of the
// distributed sliced operator.
//
// Replaces the TPU kernel diaglib_tpu/ops/dist_sliced.py::_group_spmm
// (whose body is bsr_sliced.py::_sliced_kernel).  Wrapper:
// diaglib_tpu_torch/ops/dist_sliced.py::group_spmm; plain version:
// group_spmm_plain beside it.
//
// A group holds the entries of this rank's block rows whose block column
// lies on the x shard s ranks up the ring: P entries, sorted by local block
// row, then padding entries (all-zero planes) that point at the extra row
// nbr_loc.  Its arithmetic is kernel K5's (the shared sliced_spmm.cuh); it
// differs from K5 in three ways:
//   * x is narrower than the output: the x shard is n_local = nbr_loc B
//     wide and the entries' local columns index into it, while the output
//     has nbr_loc + 1 block rows, the last one the padding row (the wrapper
//     drops it);
//   * the rows come from row_start (nbr_loc + 1 entries, built from the
//     sorted local rows), not from the TPU kernel's `first` flags: one CTA
//     per (block row, 64 columns, 16 rows of x) walks its row, with no
//     sequential grid, and writes each output once, without atomics;
//   * a row the group does not cover writes zeros, so the output equals
//     the reference's after its `covered` mask (dist_sliced.py:223-227) and
//     the caller needs no mask.
//
// What bounds it on the H100: as K5, reading the planes from device memory
// once per 16 rows of x; the products run on the int8 tensor cores
// (sliced_mma.cuh, through sliced_spmm.cuh).  At the main
// path's shape (one rank, one group of 1920 entries, B = 512, k = 15) it is
// K5's launch on the same store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sliced_spmm.cuh"

extern "C" {

// xs: (nx, k, n_x) int8, the x shard (n_x = nbr_loc B); slices: (p, B,
// width B) int8; loc_cols: (p,) int32 block columns of the x shard;
// row_start: (nbr_loc + 1,) int32, the first entry of each local block row,
// the padding row last; acc: (nlev, k, n_out) int32 with n_out = (nbr_loc +
// 1) B, written whole (see sliced::launch_level_sums for the shapes the
// caller checks).
int group_spmm(const int8_t* xs, const int8_t* slices, const int* loc_cols,
               const int* row_start, int* acc, int p, int k, int n_x,
               int n_out, int B, int width, int nx, int na, int nlev,
               void* stream) {
  return sliced::launch_level_sums(xs, slices, loc_cols, row_start, acc, p,
                                   k, n_x, n_out, B, width, nx, na, nlev,
                                   stream);
}

const char* group_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
