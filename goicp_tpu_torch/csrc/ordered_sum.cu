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
#include "common.cuh"

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

}  // namespace goicp

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
