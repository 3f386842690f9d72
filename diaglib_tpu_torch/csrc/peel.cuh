// Device code of the slice peel, shared by kernel K2 (peel.cu) and kernel K3
// (wide_mm.cu), so that both put a value on the same grid and cut it into
// exactly the same int8 planes.
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
#include <stdint.h>

namespace peel {

constexpr int kPlanes = 8;   // planes of peel8: 7 * 8 - 1 = 55 >= 53 bits

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

// max(x, y) that propagates a NaN in either, as torch.amax does.
template <typename T>
__device__ __forceinline__ T nanmax(T x, T y) {
  return (x > y || x != x) ? x : y;
}

// 2 * pow2_grid(mx) for a max of absolute values (ops/slicing.py): the least
// power of two >= mx, its exponent clamped to [-1022, 1023], 1 below
// ``tiny`` (the smallest normal number of the values' type) or for NaN,
// 2^1023 for inf; then doubled, so a grid clamped at 2^1023 gives inf.
__device__ __forceinline__ double grid2(double mx, double tiny) {
  if (!(mx >= tiny)) return 2.0;                      // denormal, 0, NaN
  const long long bits = __double_as_longlong(mx);
  const int e = (int)(bits >> 52) & 0x7ff;
  int p;
  if (e == 0x7ff) {
    p = 1023;                                         // inf
  } else {
    p = e - 1023 + ((bits & 0xfffffffffffffLL) != 0);
    p = min(p, 1023);
  }
  return __dmul_rn(2.0, __longlong_as_double((long long)(p + 1023) << 52));
}

// The first kNp of the 8 planes at 7 bits of a pre-scaled value (|t| <=
// 1/2) given as its float32 triple, as step() cuts them: q[p]'s low byte
// is plane p.  Remainders are kept scaled by 2^{7(p+1)}; s = x 2^7 + 1.5
// 2^23 rounds x 2^7 half to even (x 2^7 is exact), and s's bits are
// 0x4B400000 + rint(x 2^7).  mid joins at 7(p+1) >= 24, lo at >= 48.
// kTriple false: a float32 value (mid = lo = 0, their chains skipped).
template <int kNp = kPlanes, bool kTriple = true>
__device__ __forceinline__ void peel_planes(float hi, float mid, float lo,
                                            uint32_t q[kNp]) {
  constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23
  float x = hi;
#pragma unroll
  for (int p = 0; p < kNp; ++p) {
    const float s = __fmaf_rn(x, 128.0f, kMagic);
    x = __fmaf_rn(x, 128.0f, -__fsub_rn(s, kMagic));
    q[p] = __float_as_uint(s);
  }
  if (!kTriple || kNp <= 3) return;
  x = __fmul_rn(mid, 2097152.0f);         // 2^21: mid enters at 2^28
#pragma unroll
  for (int p = 3; p < kNp; ++p) {
    const float s = __fmaf_rn(x, 128.0f, kMagic);
    x = __fmaf_rn(x, 128.0f, -__fsub_rn(s, kMagic));
    q[p] += __float_as_uint(s);
  }
  x = __fmul_rn(lo, 4398046511104.0f);    // 2^42: lo enters at 2^49
#pragma unroll
  for (int p = 6; p < kNp; ++p) {
    const float s = __fmaf_rn(x, 128.0f, kMagic);
    x = __fmaf_rn(x, 128.0f, -__fsub_rn(s, kMagic));
    q[p] += __float_as_uint(s);
  }
}

// The 8 planes of a pre-scaled float64 value, through its triple.
__device__ __forceinline__ void peel8(double v, uint32_t q[kPlanes]) {
  float hi, mid, lo;
  split_f64(v, hi, mid, lo);
  peel_planes<kPlanes, true>(hi, mid, lo, q);
}

// the low bytes of four words, in order, as one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

}  // namespace peel
