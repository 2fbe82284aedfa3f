// The fixed float32 orders of goicp_tpu_torch/utils/fp32.py as device
// functions, one definition each, shared by fp32_products.cu (one launch
// per product) and icp.cu (the whole ICP event in one launch).
//
// Every product and sum is an explicit round-to-nearest intrinsic, which
// the compiler may not contract into an FMA (nvcc's default -fmad=true
// would otherwise fuse a*b + c and round once instead of twice).
//
//   dot3_warp   ordered_sum's warp order for three terms:
//               (z0 + z2) + z1 with z_k = +0 + a_k b_k (never -0.0);
//   dot3_seq    its sequential order (lanes=1): ((+0 + a0 b0) + a1 b1)
//               + a2 b2, the Kabsch's;
//   sq_dist_from  the squared distance (|p|^2 - 2 p.q) + |q|^2 from its
//               three dot3_warp values, sq_dist3's algebra;
//   cross3      (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0), each
//               product and difference rounded once;
//   det3_rows   dot3_seq(M0, cross3(M1, M2)) of a row-major 3x3;
//   dot_fma_step  one link of dot_fma's chain: the correctly rounded
//               float32 FMA, __fmaf_rn (XLA:CPU's dot and jnp.linalg.norm
//               take the same); dot_fma, norm3 and icp.cu's Kabsch R =
//               V (dU)^T all follow it;
//   sincos32    sin and cos of a float32 in float64, each operation
//               rounded once in the order written below, then rounded
//               once to float32: the same bits as fp32.py::sincos32_plain,
//               whose docstring gives the range reduction, the two
//               polynomials and their coefficients.
#pragma once

#include <cuda_runtime.h>

namespace goicp {

__device__ __forceinline__ float dot3_warp(const float* a, const float* b) {
  const float z0 = __fadd_rn(0.0f, __fmul_rn(a[0], b[0]));
  const float z1 = __fadd_rn(0.0f, __fmul_rn(a[1], b[1]));
  const float z2 = __fadd_rn(0.0f, __fmul_rn(a[2], b[2]));
  return __fadd_rn(__fadd_rn(z0, z2), z1);
}

__device__ __forceinline__ float dot3_seq(const float* a, const float* b) {
  float acc = __fadd_rn(0.0f, __fmul_rn(a[0], b[0]));
  acc = __fadd_rn(acc, __fmul_rn(a[1], b[1]));
  return __fadd_rn(acc, __fmul_rn(a[2], b[2]));
}

__device__ __forceinline__ float sq_dist_from(float pp, float pq, float qq) {
  return __fadd_rn(__fsub_rn(pp, __fmul_rn(2.0f, pq)), qq);
}

__device__ __forceinline__ void cross3(const float* x, const float* y,
                                       float* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
    out[k] = __fsub_rn(__fmul_rn(x[i], y[j]), __fmul_rn(x[j], y[i]));
  }
}

__device__ __forceinline__ float det3_rows(const float* M) {
  float c[3];
  cross3(M + 3, M + 6, c);
  return dot3_seq(M, c);
}

// a b + acc with one rounding
__device__ __forceinline__ float dot_fma_step(float a, float b, float acc) {
  return __fmaf_rn(a, b, acc);
}

// pi/2 = kPio2Hi + kPio2Lo + O(2^-87): kPio2Hi holds 33 bits, so k kPio2Hi
// is exact for |k| < 2^20 (fdlibm's pio2_1, pio2_1t)
constexpr double kTwoOverPi = 0x1.45f306dc9c883p-1;
constexpr double kPio2Hi = 0x1.921fb544p+0;
constexpr double kPio2Lo = 0x1.0b4611a626331p-34;
// Taylor coefficients, correctly rounded: sin r = r + r z (S1 + z (S2 +
// ... + z S8)), S_j = (-1)^j / (2j+1)!; cos r = 1 + z (C1 + z (C2 + ...
// + z C8)), C_j = (-1)^j / (2j)!; z = r^2
constexpr double kS1 = -0x1.5555555555555p-3, kS2 = 0x1.1111111111111p-7,
                 kS3 = -0x1.a01a01a01a01ap-13, kS4 = 0x1.71de3a556c734p-19,
                 kS5 = -0x1.ae64567f544e4p-26, kS6 = 0x1.6124613a86d09p-33,
                 kS7 = -0x1.ae7f3e733b81fp-41, kS8 = 0x1.952c77030ad4ap-49;
constexpr double kC1 = -0x1.0000000000000p-1, kC2 = 0x1.5555555555555p-5,
                 kC3 = -0x1.6c16c16c16c17p-10, kC4 = 0x1.a01a01a01a01ap-16,
                 kC5 = -0x1.27e4fb7789f5cp-22, kC6 = 0x1.1eed8eff8d898p-29,
                 kC7 = -0x1.93974a8c07c9dp-37, kC8 = 0x1.ae7f3e733b81fp-45;

// c1 + z (c2 + z (... + z c8)) by Horner from c8, one rounding a step
__device__ __forceinline__ double horner8(double z, double c1, double c2,
                                          double c3, double c4, double c5,
                                          double c6, double c7, double c8) {
  double p = c8;
  p = __dadd_rn(__dmul_rn(p, z), c7);
  p = __dadd_rn(__dmul_rn(p, z), c6);
  p = __dadd_rn(__dmul_rn(p, z), c5);
  p = __dadd_rn(__dmul_rn(p, z), c4);
  p = __dadd_rn(__dmul_rn(p, z), c3);
  p = __dadd_rn(__dmul_rn(p, z), c2);
  return __dadd_rn(__dmul_rn(p, z), c1);
}

// k = rint(t 2/pi); r = (t - k kPio2Hi) - k kPio2Lo; the two polynomials;
// the quadrant k mod 4 picks and negates; each value rounded once to
// float32
__device__ __forceinline__ void sincos32(float x, float* s, float* c) {
  const double t = static_cast<double>(x);
  const double k = rint(__dmul_rn(t, kTwoOverPi));
  const double r =
      __dsub_rn(__dsub_rn(t, __dmul_rn(k, kPio2Hi)), __dmul_rn(k, kPio2Lo));
  const double z = __dmul_rn(r, r);
  const double ps = horner8(z, kS1, kS2, kS3, kS4, kS5, kS6, kS7, kS8);
  const double pc = horner8(z, kC1, kC2, kC3, kC4, kC5, kC6, kC7, kC8);
  const double sr = __dadd_rn(r, __dmul_rn(__dmul_rn(r, z), ps));
  const double cr = __dadd_rn(1.0, __dmul_rn(z, pc));
  const int q = static_cast<int>(static_cast<long long>(k) & 3);
  const double sv = (q & 1) ? cr : sr, cv = (q & 1) ? sr : cr;
  *s = __double2float_rn((q & 2) ? -sv : sv);
  *c = __double2float_rn((q == 1 || q == 2) ? -cv : cv);
}

}  // namespace goicp
