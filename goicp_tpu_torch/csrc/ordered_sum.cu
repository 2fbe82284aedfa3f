// ordered_sum: the fixed-order float32 sum of goicp_tpu_torch/utils/fp32.py
// on the card.
//
// Not a port of a TPU kernel.  The JAX package leaves its sums to XLA; the
// port takes every non-integer sum of the registration path (the ICP, the
// rescoring, the rotated points, the plain twins of the bound kernels) in
// one written-down order, so that the card's answer equals the CPU's bit
// for bit.  In torch ops that order is ~15 elementwise launches a sum;
// this kernel keeps it to one launch, replacing torch.sum one for one.
//
// The order (fp32.py's docstring): lane t < `lanes` of a warp starts from
// +0.0 and adds x[t], x[t + lanes], ... in that order; the other lanes
// hold +0.0; common.cuh's warp_sum then combines the lanes by an xor
// butterfly at offsets 16, 8, 4, 2, 1, and lane 0's value is the sum.
// With lanes = 32 this is K1/K3's own order (geom_bounds.cu); with lanes
// = 1 the sequential one.  Offsets >= lanes add +0.0 to values that are
// never -0.0, which changes no bit.  Every addition is __fadd_rn or the
// butterfly's plain +, neither of which the compiler may fuse with a
// product.
//
// A row is (outer o, inner i) of a contiguous (outer, n, inner) tensor:
// its terms lie `inner` floats apart.  One warp per row, eight rows a
// block.  What bounds it on the H100: latency (a launch and one dependent
// chain of n / lanes loads and adds per lane); the rows of the ICP and
// the rescoring are 3 to ~300 terms long, and the bytes read are a few
// hundred KB at most.
//
// rotate: every point of a cloud rotated by every R of a batch, and
// shifted by its t where one is given, in one launch.  Not a port of a
// TPU kernel either: it replaces fp32.py's rotate composition, a
// broadcast product that wrote a (B, N, 3, 3) tensor, the ordered sum
// over it and an add of t (three launches, the first of them the only
// large write).  out[b, n, i] = dot3_warp(R[b, i, :], p[n, :]), which is
// the ordered sum's warp order for three terms, (z0 + z2) + z1, then
// __fadd_rn(., t[b, i]); the per-point code (rotate_point) is
// rot_body.cuh's, shared with the outer-step transition (transition.cu).
// One thread per output point; a block's threads
// read the same few R rows, which stay in L1.  What bounds it on the
// H100: the launch.  The outer transition rotates 192-256 points by 8
// matrices (~20 KB out), the rescoring by 4 to 8 (~10 KB); the design
// takes the product, the sum and the shift into one launch and writes
// only the output.
#include "common.cuh"
#include "fp32_order.cuh"
#include "rot_body.cuh"

namespace goicp {

constexpr int kRowsPerBlock = 8;

__global__ void ordered_sum_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, long long rows,
                                   int n, long long inner, int lanes) {
  const int tid = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp leaves together
  const long long o = row / inner, i = row - o * inner;
  const float* base = x + o * n * inner + i;
  float acc = 0.0f;
  if (tid < lanes)
    for (int j = tid; j < n; j += lanes)
      acc = __fadd_rn(acc, __ldg(base + static_cast<long long>(j) * inner));
  acc = warp_sum(acc);
  if (tid == 0) out[row] = acc;
}

constexpr int kRotateThreads = 128;

template <bool kShift>
__global__ void rotate_kernel(const float* __restrict__ R,
                              const float* __restrict__ pts,
                              const float* __restrict__ t,
                              float* __restrict__ out, long long batch,
                              int n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kRotateThreads + threadIdx.x;
  if (idx >= batch * n) return;
  const long long b = idx / n;
  const long long j = idx - b * n;
  float r[9], p[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = __ldg(R + 9 * b + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = __ldg(pts + 3 * j + k);
  float v[3];
  rotate_point(r, p, v);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[3 * idx + i] = kShift ? __fadd_rn(v[i], __ldg(t + 3 * b + i)) : v[i];
}

}  // namespace goicp

extern "C" int goicp_rotate(const float* R, const float* pts, const float* t,
                            float* out, long long batch, int n,
                            void* stream) {
  using namespace goicp;
  if (batch <= 0 || n <= 0) return 0;
  const long long blocks = (batch * n + kRotateThreads - 1) / kRotateThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t != nullptr)
    rotate_kernel<true><<<static_cast<unsigned>(blocks), kRotateThreads, 0,
                          s>>>(R, pts, t, out, batch, n);
  else
    rotate_kernel<false><<<static_cast<unsigned>(blocks), kRotateThreads, 0,
                           s>>>(R, pts, t, out, batch, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int goicp_ordered_sum(const float* x, float* out, long long rows,
                                 int n, long long inner, int lanes,
                                 void* stream) {
  using namespace goicp;
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL || inner <= 0 || lanes < 1 || lanes > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  ordered_sum_kernel<<<static_cast<unsigned>(blocks), 32 * kRowsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, rows, n,
                                                            inner, lanes);
  return static_cast<int>(cudaGetLastError());
}
