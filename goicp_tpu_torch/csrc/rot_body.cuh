// The per-element code of the rotation path, one definition each, shared
// by the standalone kernels (fp32_products.cu's norm3, ordered_sum.cu's
// rotate) and the outer-step transition (transition.cu), so that all of
// them compile the same arithmetic:
//
//   norm3_of       sqrt(fma(z, z, fma(y, y, x x))) with a correctly rounded
//                  square root: utils/fp32.py's norm3 (dot_fma's chain);
//   rotate_point   R p for one point, each coordinate dot3_warp(R_i, p),
//                  ordered_sum's warp order for three terms: rotate's;
//   rodrigues_of   geom/rotation.py's rodrigues as torch evaluates it, one
//                  rounding per op, nothing contracted into an FMA:
//                  t = norm3(v); u = v / (t > 0 ? t : 1), 0 where !(t > 0);
//                  (st, ct) = sincos32(t); one_ct = 1 - ct; then
//                  R_ij = (ct * eye_ij + st * K_ij) + one_ct * (u_i * u_j),
//                  K the cross-product matrix of u with +0.0 on its
//                  diagonal, each product taken even where a factor is 0
//                  (ct * 0 is -0.0 for a negative ct, as in torch).
#pragma once

#include "fp32_order.cuh"

namespace goicp {

__device__ __forceinline__ float norm3_of(float x, float y, float z) {
  float acc = __fmul_rn(x, x);
  acc = dot_fma_step(y, y, acc);
  acc = dot_fma_step(z, z, acc);
  return __fsqrt_rn(acc);
}

// out[i] = dot3_warp(R[3 i .. 3 i + 2], p), R row-major
__device__ __forceinline__ void rotate_point(const float* R, const float* p,
                                             float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = dot3_warp(R + 3 * i, p);
}

// R (row-major 3x3) of the angle-axis vector v whose norm3 is t
__device__ __forceinline__ void rodrigues_of(const float* v, float t,
                                             float* R) {
  const bool pos = t > 0.0f;
  const float safe_t = pos ? t : 1.0f;
  float u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = pos ? __fdiv_rn(v[a], safe_t) : 0.0f;
  float st, ct;
  sincos32(t, &st, &ct);
  const float one_ct = __fsub_rn(1.0f, ct);
  // K = [[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]]
  const float K[9] = {0.0f, -u[2], u[1], u[2], 0.0f, -u[0],
                      -u[1], u[0], 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      const float a = __fadd_rn(__fmul_rn(ct, e), __fmul_rn(st, K[3 * i + j]));
      R[3 * i + j] = __fadd_rn(a, __fmul_rn(one_ct, __fmul_rn(u[i], u[j])));
    }
  }
}

}  // namespace goicp
