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
// (nlev k, n) accumulator in VMEM.  Here the CTAs run in any order, so each
// CTA adds its finished sums into the accumulator in device memory with
// int32 atomicAdd: integer addition is exact and order-free, so the result
// is bitwise deterministic, and both plane buckets add into the same
// accumulator, which the caller zeroes.
//
// One CTA takes one entry, one direction (direct or mirror), a tile of 64
// output columns and up to 16 rows of x.  It stages the x planes of the
// source block column in shared memory (nx 16 B bytes, 64 KB at the f64
// tier's nx = 8, B = 512) and, plane by plane, the entry's 64 x B strip laid
// out [column][l] (transposed for the direct term, as stored for the mirror)
// with rows padded by 16 bytes so that 128-bit reads by neighbouring
// columns fall in distinct banks.  Only the pairs with lev < nlev are
// computed.  Thread (j, g) owns output column j and rows g, g+4, g+8, g+12
// and keeps their sums for every relative level in registers; the loops
// over planes and x planes are unrolled, so the level index is static.
//
// On the H100 the cost is the int8 products, not the store: at the f64 tier
// an off-diagonal entry costs 35 plane pairs of (16 x 512) (512 x 512)
// products per direction, all as __dp4a (4 int8 products a lane) on the
// CUDA cores, while the store is read from device memory about twice.
// Tensor-core int8 (mma / wgmma) would raise the ceiling many times; that
// is work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTJ = 64;                 // output columns per CTA
constexpr int kKC = 16;                 // rows of x per CTA
constexpr int kKG = 4;                  // row groups; kKC / kKG rows a thread
constexpr int kRows = kKC / kKG;
constexpr int kThreads = kTJ * kKG;     // 256
constexpr int kMaxNx = 8;
constexpr int kMaxPlanes = 8;
constexpr int kMaxLev = 9;

__global__ void __launch_bounds__(kThreads)
sym_spmm_kernel(const int8_t* __restrict__ xs, const int8_t* __restrict__ slices,
                const int* __restrict__ rows, const int* __restrict__ cols,
                int* __restrict__ acc, int k, int n, int B, int width, int nx,
                int na, int nlev, int plane_off) {
  extern __shared__ __align__(16) int8_t smem[];
  const int e = blockIdx.x;
  const int ntile = B / kTJ;
  const int mirror = blockIdx.y / ntile;
  const int j0 = (blockIdx.y % ntile) * kTJ;
  const int k0 = blockIdx.z * kKC;
  const int kc = min(kKC, k - k0);
  const int r = rows[e];
  const int c = cols[e];
  if (mirror && r == c) return;          // uniform over the CTA
  const int src = mirror ? r : c;        // block column x is read from
  const int dst = mirror ? c : r;        // block column the sums go to

  int8_t* xs_s = smem;                   // [nx][kKC][B]
  const int tstride = B + 16;
  int8_t* t_s = smem + nx * kKC * B;     // [kTJ][B + 16]
  const int tid = threadIdx.x;
  const int j = tid % kTJ;
  const int g = tid / kTJ;
  const int vrow = B / 16;               // 16-byte vectors per row of B

  for (int v = tid; v < nx * kKC * vrow; v += kThreads) {
    const int row = v / vrow;
    const int c16 = v % vrow;
    const int ix = row / kKC;
    const int kk = row % kKC;
    int4 val = make_int4(0, 0, 0, 0);
    if (kk < kc) {
      val = *reinterpret_cast<const int4*>(
          xs + ((size_t)(ix * k + k0 + kk) * n + (size_t)src * B) + c16 * 16);
    }
    *reinterpret_cast<int4*>(xs_s + (size_t)row * B + c16 * 16) = val;
  }

  int sums[kMaxLev][kRows];
#pragma unroll
  for (int rl = 0; rl < kMaxLev; ++rl)
#pragma unroll
    for (int q = 0; q < kRows; ++q) sums[rl][q] = 0;

  const size_t rstride = (size_t)width * B;
  const int8_t* blk = slices + (size_t)e * B * rstride;

#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) {
    if (i < na && plane_off + i < nlev) {    // uniform over the CTA
      __syncthreads();                       // x staged / last strip read
      if (!mirror) {
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
      } else {
        // t_s[jj][l] = T_e[j0 + jj, i B + l]
        for (int v = tid; v < kTJ * vrow; v += kThreads) {
          const int jj = v / vrow;
          const int c16 = v % vrow;
          *reinterpret_cast<int4*>(t_s + jj * tstride + c16 * 16) =
              *reinterpret_cast<const int4*>(
                  blk + (size_t)(j0 + jj) * rstride + i * B + c16 * 16);
        }
      }
      __syncthreads();
      const int nxi = min(nx, nlev - plane_off - i);
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

#pragma unroll
  for (int rl = 0; rl < kMaxLev; ++rl) {
    const int lev = plane_off + rl;
    if (lev < nlev) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int kk = g + kKG * q;
        if (kk < kc && sums[rl][q] != 0) {
          atomicAdd(acc + (size_t)(lev * k + k0 + kk) * n + (size_t)dst * B +
                        j0 + j,
                    sums[rl][q]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// xs: (nx, k, n) int8; slices: (m, B, width B) int8; rows, cols: (m,) int32;
// acc: (nlev, k, n) int32, added into.  The caller checks the shapes:
// B % 64 == 0, B <= 1024, n % B == 0, nx <= 8, na <= min(width, 8),
// nlev <= plane_off + 9.
int sym_spmm(const int8_t* xs, const int8_t* slices, const int* rows,
             const int* cols, int* acc, int m, int k, int n, int B, int width,
             int nx, int na, int nlev, int plane_off, void* stream) {
  if (m == 0 || k == 0 || na <= 0 || plane_off >= nlev) return 0;
  const int smem = nx * kKC * B + kTJ * (B + 16);
  cudaError_t err = cudaFuncSetAttribute(
      sym_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)m, 2 * (B / kTJ), (k + kKC - 1) / kKC);
  sym_spmm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, slices, rows, cols, acc, k, n, B, width, nx, na, nlev, plane_off);
  return (int)cudaGetLastError();
}

const char* sym_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
