// The hydro coordinates of an MCRaT position and the strict domain test, as
// device functions that the direct lookup (direct_lookup.cu) and the carried
// lookup (binned_search.cu) share.  Each keeps the plain version's operation
// order in its dtype (round-to-nearest intrinsics; the build turns off FMA
// contraction; the CUDA math library's sqrt, acos, atan2 and fmod as torch's
// CUDA ops call them), so a kernel that calls them gives the plain version's
// values bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace {

// geometry.mcrat_to_hydro's cases: 2-D and 2.5-D cartesian or cylindrical,
// 2-D and 2.5-D spherical, 3-D cartesian, spherical and polar
enum Geo { CYL2 = 0, SPH2 = 1, CART3 = 2, SPH3 = 3, POL3 = 4 };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float acos_(float a) { return acosf(a); }
__device__ __forceinline__ double acos_(double a) { return acos(a); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }

// torch.clamp(v, -1, 1): NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_unit(T v) {
  return v != v ? v : (v < T(-1) ? T(-1) : (v > T(1) ? T(1) : v));
}

// torch.remainder(atan2(y, x) + 2 pi, 2 pi): 2 pi rounded to T, as torch
// rounds the Python scalar; fmod, plus the divisor where the sign differs
template <typename T>
__device__ __forceinline__ T azimuth(T y, T x) {
  const T two_pi = T(6.283185307179586);
  const T a = add_rn(atan2_(y, x), two_pi);
  T m = fmod_(a, two_pi);
  if (m != T(0) && (m < T(0)) != (two_pi < T(0))) m = add_rn(m, two_pi);
  return m;
}

// x * x + y * y (+ z * z), each product and sum rounded
template <typename T>
__device__ __forceinline__ T norm2(T x, T y) { return add_rn(mul_rn(x, x), mul_rn(y, y)); }

// geometry.mcrat_to_hydro of (x, y, z): r2 is 0 in 2-D
template <typename T, int G>
__device__ __forceinline__ void to_hydro(T x, T y, T z, T& r0, T& r1, T& r2) {
  if (G == CYL2) {
    r0 = sqrt_rn(norm2(x, y));
    r1 = z;
    r2 = T(0);
  } else if (G == SPH2 || G == SPH3) {
    r0 = sqrt_rn(add_rn(norm2(x, y), mul_rn(z, z)));
    r1 = acos_(clamp_unit(div_rn(z, r0)));
    r2 = G == SPH3 ? azimuth(y, x) : T(0);
  } else if (G == CART3) {
    r0 = x;
    r1 = y;
    r2 = z;
  } else {  // POL3
    r0 = sqrt_rn(norm2(x, y));
    r1 = azimuth(y, x);
    r2 = z;
  }
}

// grid._hydro_inside's strict test against the frame's bounds rounded to T,
// dom = (lo, hi) per axis; axis 2 only in 3-D
template <typename T, bool D3>
__device__ __forceinline__ bool in_domain(T r0, T r1, T r2, const T* __restrict__ dom) {
  bool inside = r0 > __ldg(dom) && r0 < __ldg(dom + 1) && r1 > __ldg(dom + 2) &&
                r1 < __ldg(dom + 3);
  if (D3) inside = inside && r2 > __ldg(dom + 4) && r2 < __ldg(dom + 5);
  return inside;
}

}  // namespace
