// score: the rescoring of whole transforms (goicp_tpu_torch/bounds/
// error.py) in one launch.
//
// Not a port of a TPU kernel.  The JAX package computes the rescoring in
// XLA (goicp_tpu/bounds/error.py: score_transform, icp_chem_terms,
// bnb_incompatibility_count, initial_error); the port's torch bodies of
// the same functions (error.py's *_plain) take ~85 launches a rescoring:
// the rotated points, the distance-transform gather with its
// out-of-bounds extension, the trimmed sort, the ordered sums, the
// correspondences' compatibility, neighbour and c-FPFH terms, the points
// rotated again and the nearest-cell gather for the BnB count.  This
// kernel takes all of them into one launch, with the torch bodies'
// operations in their order, so that its bits are theirs.
//
// Routes (`mode`), each one launch of one block a row:
//
//   kFull     row k of (R_k, t_k, nn_idx_k): what score_transform and
//             icp_chem_terms return, out (7, K) = error, geom,
//             incomp_term, fpfh_term, nbr_term, incomp_count (int32 bits:
//             the BnB count at (R_k, t_k)) and icp_incomp (the
//             correspondences' incompatibility count, float);
//   kCount    bnb_incompatibility_count at (R_k, t_k): out (K,) int32;
//   kInitial  initial_error: the unrotated data, weights applied before
//             the trim, the chem terms' worst-case seeds: out (1,).
//
// A row's block:
//
//   1. every point (a thread a point): p' = R p + t (rot_body.cuh's
//      rotate_point, then __fadd_rn of t; kInitial takes p itself); the
//      voxel raw = trunc((p' - lo) * scale + 0.5), clamped to [0, S);
//      the field at the clamped voxel plus, out of the grid,
//      sqrt((e0^2 + e1^2) + e2^2) / scale, the excess e per axis (the
//      sum in that sequential order, grid/lookup.py's oob_extension and
//      the bound kernels' too; a correctly rounded sqrt and an IEEE
//      division); the value the sum takes (trimmed rescoring: d, +inf on
//      padding; untrimmed and kInitial: w d, then +inf on padding where
//      trimmed) into shared memory; the integer counts (the
//      correspondences' incompatibilities, |nbrs_d - nbrs_m|, the BnB
//      count from the nearest-cell table and the pair's compat table)
//      added in shared memory, exact in any order for data_mask of 0/1;
//   2. the c-FPFH term (kFull with the term on): a warp a point, lane b
//      adding |f_d[b] - f_m[b]| for b = lane, lane + 32, ... and the xor
//      butterfly combining the lanes (utils/fp32.py's ordered_sum over
//      the B bins), times the mask into shared memory; then one warp's
//      ordered sum over the points, divided by nd;
//   3. trimmed: each value placed at its rank (the count of smaller
//      values, and of equal values at lower indices: equal values give
//      the same bits in any order), the values taken at positions below
//      inlier_num (static K) or below counts[1] (dynamic K; the torch
//      body's zeros past K add +0.0, which changes no bit); a static K
//      not below Nd takes the values unsorted, as trimmed_smallest does;
//   4. the sum of f(v) (v v for norm 2 and every trimmed rescoring, v for
//      norm 1) in ordered_sum's warp order: lane t adds positions t, t +
//      32, ... from +0.0, then the butterfly (common.cuh's warp_sum);
//   5. lane 0 forms the terms in the torch bodies' order: reg x x as
//      (reg x) x with reg rounded to float32 as torch takes a Python
//      scalar, error ((geom + nbr) + incomp) + fpfh, the initial error's
//      seeds err + (reg nd) nd, + float(regF 800^2), + (regN (6 nd)) (6
//      nd).  Every product and sum is a round-to-nearest intrinsic, which
//      the compiler may not contract into an FMA.
//
// What bounds it on the H100: a launch and one block's serial chain a
// row.  The rescoring's rows are 4 to 8 of ~150-300 points (a few KB of
// gathers); phase 2 of chip_smoke.py also runs the 4,200-point ICP
// event's rows, whose O(Nd^2) rank placement takes the block ~0.1-0.3
// ms.  The design is the simple one: one block a row, the row's values
// and their ranked copy in shared memory.
#include "common.cuh"
#include "fp32_order.cuh"
#include "rot_body.cuh"

namespace goicp {

constexpr int kScoreThreads = 256;
constexpr int kScoreWarps = kScoreThreads / 32;
constexpr int kFull = 0, kCount = 1, kInitial = 2;
constexpr int kNoTrim = 0, kStaticTrim = 1, kDynamicTrim = 2;

// the pair's tensors and the configuration, as the wrapper's slot block
// lays them out (bounds/error.py::_score_args)
struct ScoreArgs {
  const float* data;           // (Nd, 3)
  const float* weights;        // (Nd,)
  const float* mask;           // (Nd,) 1 real, 0 padding
  const float* dist;           // (S^3,) distance field
  const int* nearest;          // (S^3,) nearest occupied cell
  const float* consts;         // (5,) lo, scale, size
  const int* data_props;       // (Nd,)
  const int* model_props;      // (Nm,)
  const unsigned char* compat; // (P, P) bool property compatibility
  const int* data_nbrs;        // (Nd,)
  const int* model_nbrs;       // (Nm,)
  const float* data_fpfh;      // (Nd, B)
  const float* model_fpfh;     // (Nm, B)
  const unsigned char* table;  // (Nd, C) bool compat of point and cell
  const float* counts;         // (3,) n_data, inlier_num, n_model
  int nd, n_cells, n_props, bins;
  int norm, trim, inlier_num, n_data, dynamic;
  int reg_on, nbr_on, fpfh_on, seed_fpfh_on;
  float reg, reg_nbr, reg_fpfh, seed_fpfh;
};

// dynamic shared memory a row needs: its values and their ranked copy
__host__ __forceinline__ size_t score_smem(int nd) {
  return 2 * region_words(static_cast<size_t>(nd)) * sizeof(float);
}

__global__ void __launch_bounds__(kScoreThreads)
    score_kernel(ScoreArgs a, const float* __restrict__ R,
                 const float* __restrict__ t, const void* __restrict__ nn,
                 int nn_wide, float* __restrict__ out, int rows, int mode) {
  extern __shared__ float smem[];
  const int nd = a.nd;
  float* vals = smem;
  float* buf = smem + region_words(static_cast<size_t>(nd));
  __shared__ int s_incomp, s_nbr, s_bnb;
  __shared__ float s_fp;
  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_incomp = s_nbr = s_bnb = 0;
  __syncthreads();

  const bool full = mode == kFull, initial = mode == kInitial;
  const bool trimmed = a.trim != kNoTrim;
  float r[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float sh[3] = {0.0f, 0.0f, 0.0f};
  if (!initial) {
    const size_t row = static_cast<size_t>(k);
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = __ldg(R + 9 * row + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) sh[i] = __ldg(t + 3 * row + i);
  }
  const GridConsts g = load_consts(a.consts);
  const float inf = __int_as_float(0x7f800000);
  const long long* nn64 = static_cast<const long long*>(nn);
  const int* nn32 = static_cast<const int*>(nn);
  const size_t row0 = static_cast<size_t>(k) * nd;

  // 1. the points
  int incomp = 0, nbr = 0, bnb = 0;
  for (int i = tid; i < nd; i += kScoreThreads) {
    float p[3], q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = __ldg(a.data + 3 * i + c);
    if (initial) {
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = p[c];
    } else {
      rotate_point(r, p, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = __fadd_rn(q[c], sh[c]);
    }
    int cl[3];
    float ex[3];
    bool oob = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float raw = truncf(__fadd_rn(
          __fmul_rn(__fsub_rn(q[c], g.lo[c]), g.scale), 0.5f));
      const int ri = static_cast<int>(raw);
      cl[c] = min(max(ri, 0), g.size - 1);
      ex[c] = ri < 0 ? static_cast<float>(ri)
                     : (ri >= g.size ? static_cast<float>(ri - g.size + 1)
                                     : 0.0f);
      oob = oob || ri < 0 || ri >= g.size;
    }
    const int vox = flat_voxel(cl[0], cl[1], cl[2], g.size);
    const float m = __ldg(a.mask + i);
    const bool real = m != 0.0f;
    if (mode != kCount) {
      float d = __ldg(a.dist + vox);
      if (oob) {
        const float s = __fadd_rn(
            __fadd_rn(__fmul_rn(ex[0], ex[0]), __fmul_rn(ex[1], ex[1])),
            __fmul_rn(ex[2], ex[2]));
        d = __fadd_rn(d, __fdiv_rn(__fsqrt_rn(s), g.scale));
      }
      // the rescoring's trim drops the weights (the reference's quirk)
      float v = trimmed && !initial ? d : __fmul_rn(__ldg(a.weights + i), d);
      if (trimmed && !(m > 0.0f)) v = inf;
      vals[i] = v;
    }
    if (mode != kInitial) {
      const int cell = __ldg(a.nearest + vox);
      bnb += real && !a.table[static_cast<size_t>(i) * a.n_cells + cell];
    }
    if (full) {
      const long long j = nn_wide ? nn64[row0 + i] : nn32[row0 + i];
      const int dp = __ldg(a.data_props + i);
      const int mp = __ldg(a.model_props + j);
      incomp += real && !a.compat[dp * a.n_props + mp];
      if (a.nbr_on && real)
        nbr += abs(__ldg(a.data_nbrs + i) - __ldg(a.model_nbrs + j));
    }
  }
  if (incomp) atomicAdd(&s_incomp, incomp);
  if (nbr) atomicAdd(&s_nbr, nbr);
  if (bnb) atomicAdd(&s_bnb, bnb);
  __syncthreads();

  const float nd_f = a.dynamic ? __ldg(a.counts) : static_cast<float>(a.n_data);

  // 2. the c-FPFH term: a warp a point, then one warp over the points
  if (full && a.fpfh_on) {
    for (int i = warp; i < nd; i += kScoreWarps) {
      const long long j = nn_wide ? nn64[row0 + i] : nn32[row0 + i];
      const float* fd = a.data_fpfh + static_cast<size_t>(i) * a.bins;
      const float* fm = a.model_fpfh + static_cast<size_t>(j) * a.bins;
      float acc = 0.0f;
      for (int b = lane; b < a.bins; b += 32)
        acc = __fadd_rn(acc, fabsf(__fsub_rn(__ldg(fd + b), __ldg(fm + b))));
      acc = warp_sum(acc);
      if (lane == 0) buf[i] = __fmul_rn(acc, __ldg(a.mask + i));
    }
    __syncthreads();
    if (warp == 0) {
      float acc = 0.0f;
      for (int i = lane; i < nd; i += 32) acc = __fadd_rn(acc, buf[i]);
      acc = warp_sum(acc);
      if (lane == 0) s_fp = __fdiv_rn(acc, nd_f);
    }
    __syncthreads();
  }

  // 3. the trimmed selection: each value at its rank
  const float* kept = vals;
  float keep_below = static_cast<float>(nd);   // positions kept: < this
  if (mode != kCount && trimmed) {
    keep_below = a.trim == kDynamicTrim ? __ldg(a.counts + 1)
                                        : static_cast<float>(a.inlier_num);
    if (a.trim == kDynamicTrim || a.inlier_num < nd) {
      for (int i = tid; i < nd; i += kScoreThreads) {
        const float v = vals[i];
        int rank = 0;
        for (int j = 0; j < nd; ++j) {
          const float u = vals[j];
          rank += u < v || (u == v && j < i);
        }
        buf[rank] = v;
      }
      __syncthreads();
      kept = buf;
    }
  }

  // 4. and 5. the sum in the warp order, then the terms
  if (warp != 0) return;
  if (mode == kCount) {
    if (lane == 0) reinterpret_cast<int*>(out)[k] = s_bnb;
    return;
  }
  const bool square = a.norm == 2 || (trimmed && !initial);
  float acc = 0.0f;
  for (int i = lane; i < nd; i += 32) {
    const float v = kept[i];
    const float fv = square ? __fmul_rn(v, v) : v;
    acc = __fadd_rn(acc, static_cast<float>(i) < keep_below ? fv : 0.0f);
  }
  const float geom = warp_sum(acc);
  if (lane != 0) return;
  if (initial) {
    float err = geom;
    if (a.reg_on) err = __fadd_rn(err, __fmul_rn(__fmul_rn(a.reg, nd_f), nd_f));
    if (a.seed_fpfh_on) err = __fadd_rn(err, a.seed_fpfh);
    if (a.nbr_on) {
      const float six = __fmul_rn(6.0f, nd_f);
      err = __fadd_rn(err, __fmul_rn(__fmul_rn(a.reg_nbr, six), six));
    }
    out[0] = err;
    return;
  }
  const float inc = static_cast<float>(s_incomp);
  const float nb = static_cast<float>(s_nbr);
  const float nbr_term =
      a.nbr_on ? __fmul_rn(__fmul_rn(a.reg_nbr, nb), nb) : 0.0f;
  const float incomp_term =
      a.reg_on ? __fmul_rn(__fmul_rn(a.reg, inc), inc) : 0.0f;
  const float fpfh_term =
      a.fpfh_on ? __fmul_rn(__fmul_rn(a.reg_fpfh, s_fp), s_fp) : 0.0f;
  const float error = __fadd_rn(
      __fadd_rn(__fadd_rn(geom, nbr_term), incomp_term), fpfh_term);
  const size_t K = static_cast<size_t>(rows);
  out[k] = error;
  out[K + k] = geom;
  out[2 * K + k] = incomp_term;
  out[3 * K + k] = fpfh_term;
  out[4 * K + k] = nbr_term;
  reinterpret_cast<int*>(out)[5 * K + k] = s_bnb;
  out[6 * K + k] = inc;
}

}  // namespace goicp

// slots: the 15 pointers of ScoreArgs in its order; ints: its 13 ints;
// floats: its 4 floats.  R (rows, 3, 3), t (rows, 3), nn (rows, Nd) int64
// (nn_wide) or int32; NULL where the mode reads none.
extern "C" int goicp_score(const unsigned long long* slots, const int* ints,
                           const float* floats, const float* R,
                           const float* t, const void* nn, int nn_wide,
                           float* out, long long rows, int mode,
                           void* stream) {
  using namespace goicp;
  if (rows <= 0) return 0;
  auto ptr = [&](int i) {
    return reinterpret_cast<const void*>(static_cast<uintptr_t>(slots[i]));
  };
  ScoreArgs a;
  a.data = static_cast<const float*>(ptr(0));
  a.weights = static_cast<const float*>(ptr(1));
  a.mask = static_cast<const float*>(ptr(2));
  a.dist = static_cast<const float*>(ptr(3));
  a.nearest = static_cast<const int*>(ptr(4));
  a.consts = static_cast<const float*>(ptr(5));
  a.data_props = static_cast<const int*>(ptr(6));
  a.model_props = static_cast<const int*>(ptr(7));
  a.compat = static_cast<const unsigned char*>(ptr(8));
  a.data_nbrs = static_cast<const int*>(ptr(9));
  a.model_nbrs = static_cast<const int*>(ptr(10));
  a.data_fpfh = static_cast<const float*>(ptr(11));
  a.model_fpfh = static_cast<const float*>(ptr(12));
  a.table = static_cast<const unsigned char*>(ptr(13));
  a.counts = static_cast<const float*>(ptr(14));
  a.nd = ints[0];
  a.n_cells = ints[1];
  a.n_props = ints[2];
  a.bins = ints[3];
  a.norm = ints[4];
  a.trim = ints[5];
  a.inlier_num = ints[6];
  a.n_data = ints[7];
  a.dynamic = ints[8];
  a.reg_on = ints[9];
  a.nbr_on = ints[10];
  a.fpfh_on = ints[11];
  a.seed_fpfh_on = ints[12];
  a.reg = floats[0];
  a.reg_nbr = floats[1];
  a.reg_fpfh = floats[2];
  a.seed_fpfh = floats[3];
  const size_t smem = score_smem(a.nd);
  if (rows > 0x7fffffffLL || a.nd <= 0 || smem > kMaxDynamicSmem ||
      mode < kFull || mode > kInitial || (mode == kInitial && rows != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;
  const cudaError_t err = allow_smem(score_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_kernel<<<static_cast<unsigned>(rows), kScoreThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      a, R, t, nn, nn_wide, out, static_cast<int>(rows), mode);
  return static_cast<int>(cudaGetLastError());
}
