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
//   dot_fma_step  one link of dot_fma's chain: the float32 FMA taken in
//               float64 (the product exact there) and rounded once to
//               float32.
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

// acc + a b in float64, rounded once to float32
__device__ __forceinline__ float dot_fma_step(float a, float b, float acc) {
  const double prod =
      __dmul_rn(static_cast<double>(a), static_cast<double>(b));
  return __double2float_rn(__dadd_rn(prod, static_cast<double>(acc)));
}

}  // namespace goicp
