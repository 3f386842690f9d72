// Device code of the slice peel, shared by kernel K2 (peel.cu) and kernel K3
// (wide_mm.cu), so that both cut a value into exactly the same int8 planes.
//
// A pre-scaled value t (|t| <= 1/2 on its power-of-two grid) is carried as
// its exact float32 triple (hi, mid, lo), t == hi + mid + lo.  Plane i takes
// q = rint(rem 2^{b(i+1)}) and leaves rem -= q 2^{-b(i+1)}; mid joins once
// b(i+1) >= 24 and lo once b(i+1) >= 48 (before that they round to zero).
// Every step is exact in float32 as long as the build keeps IEEE semantics:
// rintf rounds half to even like jnp.round, the _rn intrinsics forbid
// multiply-add contraction, and denormals are kept (no fast math).

#pragma once

#include <cuda_runtime.h>

namespace peel {

// The exact float32 triple of a float64 value.
__device__ __forceinline__ void split_f64(double t, float& hi, float& mid,
                                          float& lo) {
  hi = __double2float_rn(t);
  const double d = __dsub_rn(t, (double)hi);
  mid = __double2float_rn(d);
  lo = __double2float_rn(__dsub_rn(d, (double)mid));
}

// One plane at shift sh = bits * (i + 1) (0 < sh < 127): returns q as an
// integral float and updates the remainders in place.
__device__ __forceinline__ float step(int sh, float& hi, float& mid,
                                      float& lo) {
  const float w = __int_as_float((127 - sh) << 23);     // 2^-sh, exact
  const float inv = __int_as_float((127 + sh) << 23);   // 2^sh, exact
  float q = rintf(__fmul_rn(hi, inv));
  hi = __fsub_rn(hi, __fmul_rn(q, w));
  if (sh >= 24) {
    const float q2 = rintf(__fmul_rn(mid, inv));
    mid = __fsub_rn(mid, __fmul_rn(q2, w));
    q = __fadd_rn(q, q2);
  }
  if (sh >= 48) {
    const float q3 = rintf(__fmul_rn(lo, inv));
    lo = __fsub_rn(lo, __fmul_rn(q3, w));
    q = __fadd_rn(q, q3);
  }
  return q;
}

}  // namespace peel
