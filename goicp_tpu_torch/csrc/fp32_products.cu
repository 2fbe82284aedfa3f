// The fixed-order products of goicp_tpu_torch/utils/fp32.py on the card,
// each one launch where its torch form takes several.
//
// Not ports of TPU kernels.  They exist so that the registration path
// takes utils/fp32.py's written-down order at the launch count of the
// library calls they replace (matmul, linalg.cross, linalg.norm, cos,
// sin):
//
//   sq_dist3   d2[r, m] = (dot3(p_r, p_r) - 2 dot3(p_r, q_m)) + dot3(q_m, q_m)
//              for points p (R, 3) and a model q (M, 3): the ICP's nearest-
//              neighbour distance matrix, without the (R, M, 3) products;
//   det3       det M = dot3_seq(M0, cross3(M1, M2)) of (B, 3, 3) matrices;
//   cross3     (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0) of broadcast
//              3-vectors a and b;
//   dot_fma    a chain of float32 FMAs over the last axis of broadcast a
//              and b;
//   norm3      sqrt(fma(v2, v2, fma(v1, v1, v0 v0))) of 3-vectors: it
//              replaces fp32.py's exact_sqrt(dot_fma(v, v)), four
//              launches (the chain, and the square root taken in float64
//              as a cast, a sqrt and a cast back); __fsqrt_rn is the
//              correctly rounded square root, which exact_sqrt is too;
//   sincos32   sin and cos of float32 angles in float64 (fp32_order.cuh),
//              both in one launch: it replaces fp32.py's cos32 and sin32,
//              six launches (a cast, the device's libm call and a cast
//              back, twice) whose libm differed between the card and the
//              CPU.
//
// The orders (dot3's warp and sequential ones, the cross product, the
// FMA chain, the sin and cos polynomials) are fp32_order.cuh's, shared
// with icp.cu; norm3's body (norm3_of) is rot_body.cuh's, shared with the
// outer-step transition (transition.cu).  One thread per output value; what bounds them on the
// H100 is the launch: the ICP's matrices are a few hundred KB (sq_dist3),
// the rest a few hundred bytes (8 rotation centres, 3x3 matrices) to ~5
// KB (the preparation's point norms).  So each takes its whole function
// into one launch and its wrapper (fp32.py) keeps the host's work per
// call to a few checks and one C call.  Since the ICP event is one
// launch of icp.cu, the registration path launches none of sq_dist3,
// det3, cross3 or dot_fma; norm3 and sincos32 are on it (the outer
// transition, rodrigues, the preparation, the rotation uncertainty).
#include "common.cuh"
#include "fp32_order.cuh"
#include "rot_body.cuh"

namespace goicp {

constexpr int kThreads = 256;
constexpr int kDims = 4;   // leading (broadcast) dims of cross3 and dot_fma

__global__ void sq_dist3_kernel(const float* __restrict__ p,
                                const float* __restrict__ q,
                                float* __restrict__ out, long long rows,
                                int m) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * m) return;
  const long long r = idx / m;
  const int j = static_cast<int>(idx - r * m);
  float pr[3], qj[3];
  for (int k = 0; k < 3; ++k) {
    pr[k] = __ldg(p + 3 * r + k);
    qj[k] = __ldg(q + 3 * static_cast<long long>(j) + k);
  }
  out[idx] = sq_dist_from(dot3_warp(pr, pr), dot3_warp(pr, qj),
                          dot3_warp(qj, qj));
}

__global__ void det3_kernel(const float* __restrict__ mats,
                            float* __restrict__ out, long long batch) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= batch) return;
  out[b] = det3_rows(mats + 9 * b);
}

// The broadcast shape of two operands (cross3, dot_fma): kDims leading
// dims (size and each operand's stride in floats, a stride of 0 where it
// broadcasts), then the last axis.
struct BroadcastShape {
  long long size[kDims], sa[kDims], sb[kDims];
  long long la, lb;   // strides of the last axis
  int n;              // its length
};

// offsets of leading index `row` (the last dim fastest) in a and b
__device__ __forceinline__ void broadcast_offsets(const BroadcastShape& s,
                                                  long long row,
                                                  long long* oa,
                                                  long long* ob) {
  *oa = 0;
  *ob = 0;
  for (int d = kDims - 1; d >= 0; --d) {
    const long long i = row % s.size[d];
    row /= s.size[d];
    *oa += i * s.sa[d];
    *ob += i * s.sb[d];
  }
}

__global__ void cross3_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out, BroadcastShape s,
                              long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  long long oa, ob;
  broadcast_offsets(s, row, &oa, &ob);
  float x[3], y[3];
  for (int k = 0; k < 3; ++k) {
    x[k] = __ldg(a + oa + k * s.la);
    y[k] = __ldg(b + ob + k * s.lb);
  }
  cross3(x, y, out + 3 * row);
}

__global__ void dot_fma_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ out, BroadcastShape s,
                               long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  long long oa, ob;
  broadcast_offsets(s, row, &oa, &ob);
  float acc = __fmul_rn(__ldg(a + oa), __ldg(b + ob));
  for (int k = 1; k < s.n; ++k)
    acc = dot_fma_step(__ldg(a + oa + k * s.la), __ldg(b + ob + k * s.lb),
                       acc);
  out[row] = acc;
}

__global__ void norm3_kernel(const float* __restrict__ v,
                             float* __restrict__ out, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  out[row] = norm3_of(__ldg(v + 3 * row), __ldg(v + 3 * row + 1),
                      __ldg(v + 3 * row + 2));
}

__global__ void sincos32_kernel(const float* __restrict__ x,
                                float* __restrict__ s, float* __restrict__ c,
                                long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  sincos32(__ldg(x + i), s + i, c + i);
}

inline int launch_status(long long blocks) {
  return blocks > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// meta: size[4], stride of a[4], stride of b[4], a's and b's stride of the
// last axis, its length (15 values); rows = the product of the sizes
inline BroadcastShape read_shape(const long long* meta, long long* rows) {
  BroadcastShape s;
  *rows = 1;
  for (int d = 0; d < kDims; ++d) {
    s.size[d] = meta[d];
    s.sa[d] = meta[kDims + d];
    s.sb[d] = meta[2 * kDims + d];
    *rows *= s.size[d] > 0 ? s.size[d] : 0;
  }
  s.la = meta[3 * kDims];
  s.lb = meta[3 * kDims + 1];
  s.n = static_cast<int>(meta[3 * kDims + 2]);
  return s;
}

}  // namespace goicp

extern "C" int goicp_sq_dist3(const float* p, const float* q, float* out,
                              long long rows, int m, void* stream) {
  using namespace goicp;
  if (rows <= 0 || m <= 0) return 0;
  const long long blocks = (rows * m + kThreads - 1) / kThreads;
  if (int err = launch_status(blocks)) return err;
  sq_dist3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p, q, out, rows, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int goicp_det3(const float* mats, float* out, long long batch,
                          void* stream) {
  using namespace goicp;
  if (batch <= 0) return 0;
  const long long blocks = (batch + kThreads - 1) / kThreads;
  if (int err = launch_status(blocks)) return err;
  det3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(mats, out, batch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int goicp_cross3(const float* a, const float* b, float* out,
                            const long long* meta, void* stream) {
  using namespace goicp;
  long long rows;
  const BroadcastShape s = read_shape(meta, &rows);
  if (rows == 0) return 0;
  if (s.n != 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (int err = launch_status(blocks)) return err;
  cross3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, out, s, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int goicp_dot_fma(const float* a, const float* b, float* out,
                             const long long* meta, void* stream) {
  using namespace goicp;
  long long rows;
  const BroadcastShape s = read_shape(meta, &rows);
  if (rows == 0) return 0;
  if (s.n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (int err = launch_status(blocks)) return err;
  dot_fma_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, s, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int goicp_norm3(const float* v, float* out, long long rows,
                           void* stream) {
  using namespace goicp;
  if (rows <= 0) return 0;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (int err = launch_status(blocks)) return err;
  norm3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(v, out, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int goicp_sincos32(const float* x, float* s, float* c,
                              long long n, void* stream) {
  using namespace goicp;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (int err = launch_status(blocks)) return err;
  sincos32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, s, c, n);
  return static_cast<int>(cudaGetLastError());
}
