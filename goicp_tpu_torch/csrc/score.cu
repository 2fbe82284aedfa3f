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
// It also ends an ICP event on the card (search/pick.py): the seeds
// before the event and the pick after it, so that a refinement reads the
// host no time.
//
// Routes of goicp_score (`mode`), each one launch of one block a row:
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
// goicp_score_pick, one launch of one block a seed row and one for the
// extra row, each computing its row as kFull (or the extra row's route)
// does, so that the bits are those of the rows above:
//
//   kPick     the K rows of an ICP event's results (R_k, t_k, nn_idx_k),
//             the first minimum of their errors (torch.argmin's rule: the
//             first NaN if there is one), and the extra row the
//             candidate's BnB count (kCount at cand_R, cand_t); the
//             winner written into row j of the refine record (icp_R,
//             icp_t, icp_err, icp_terms = [geom, incomp_term + nbr_term,
//             fpfh_term], icp_incomp, bnb_comp, do_icp = 1);
//   kInit     the K rows of the initial ICP event, the extra row the
//             initial error (kInitial), the first minimum, and the
//             initial incumbent device_engine._initial_incumbent forms
//             (better = err < initial error; opt_err, opt_R, opt_t, comp,
//             terms, last_icp) written into the new state's tensors.
//
//   With K + 1 <= 8 the K + 1 blocks are one thread-block cluster (the
//   extra row block K's); with K = 8 the cluster is the 8 seed blocks and
//   block 0 takes the extra row after its own.  Every block arrives at
//   the cluster barrier when it starts and waits before it writes its row
//   into block 0's shared memory (the block must have started); one more
//   barrier and block 0's thread 0 picks and writes.  With K > 8 (a
//   configuration's icp_seeds above 8) the K blocks are a plain grid:
//   each writes its row into a workspace in device memory, fences, and
//   takes a ticket; the block with the last ticket picks, writes, and
//   sets the ticket back to 0 for the next launch.
//
// goicp_icp_seeds (one block): the K lowest-ub lanes of an outer step,
// ties to the lower lane (a stable ascending argsort's first K, NaN
// last), each lane's rank the count of lanes before it; the seeds' R
// (R_lanes' rows) and t = c + w / 2 of their best nodes.  Given a refine
// record, the same launch sets its n rows to the dummy of a row that
// did not refine (identity, 0, inf, 0, 0, 0, do_icp 0): a transition's
// first refinement clears the record that its picks then write.
//
// What bounds it on the H100: a launch and one block's serial chain a
// row.  The rescoring's rows are 4 to 8 of ~150-300 points (a few KB of
// gathers); phase 2 of chip_smoke.py also runs the 4,200-point ICP
// event's rows, whose O(Nd^2) rank placement takes the block ~0.1-0.3
// ms.  The design is the simple one: one block a row, the row's values
// and their ranked copy in shared memory; the pick adds a cluster
// barrier (or a ticket) and one thread's writes.
#include <cooperative_groups.h>

#include "common.cuh"
#include "fp32_order.cuh"
#include "rot_body.cuh"

namespace cg = cooperative_groups;

namespace goicp {

constexpr int kScoreThreads = 256;
constexpr int kScoreWarps = kScoreThreads / 32;
constexpr int kFull = 0, kCount = 1, kInitial = 2;
constexpr int kPick = 0, kInit = 1;            // goicp_score_pick's routes
constexpr int kNoTrim = 0, kStaticTrim = 1, kDynamicTrim = 2;
constexpr int kPickCluster = 8;   // the portable cluster size
constexpr int kRowWords = 7;      // a row's result (RowOut)
constexpr int kSeedThreads = 256;

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

// a row's result, in goicp_score's output order: error, geom,
// incomp_term, fpfh_term, nbr_term, the BnB count (int32 bits), the
// correspondences' incompatibility count (float); kInitial: the initial
// error in word 0
enum RowOut { kErr, kGeom, kIncTerm, kFpfhTerm, kNbrTerm, kBnb, kInc };

// the block's integer counts and the c-FPFH mean of a row
struct RowShared {
  int incomp, nbr, bnb;
  float fp;
};

// dynamic shared memory a row needs: its values and their ranked copy
__host__ __forceinline__ size_t score_smem(int nd) {
  return 2 * region_words(static_cast<size_t>(nd)) * sizeof(float);
}

// One row's score by the whole block (every thread calls it): `mode`
// kFull / kCount at (R, t) with the correspondences nn (Nd entries,
// int64 if nn_wide), kInitial at the unrotated data.  The result lands in
// res[0 .. kRowWords) (shared), visible to every thread on return.
__device__ __forceinline__ void score_row(const ScoreArgs& a, int mode,
                          const float* __restrict__ R,
                          const float* __restrict__ t, const void* nn,
                          int nn_wide, float* vals, float* buf,
                          RowShared& sh, float* res) {
  const int nd = a.nd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh.incomp = sh.nbr = sh.bnb = 0;
  __syncthreads();

  const bool full = mode == kFull, initial = mode == kInitial;
  const bool trimmed = a.trim != kNoTrim;
  float r[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float shift[3] = {0.0f, 0.0f, 0.0f};
  if (!initial) {
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = __ldg(R + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) shift[i] = __ldg(t + i);
  }
  const GridConsts g = load_consts(a.consts);
  const float inf = __int_as_float(0x7f800000);
  const long long* nn64 = static_cast<const long long*>(nn);
  const int* nn32 = static_cast<const int*>(nn);

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
      for (int c = 0; c < 3; ++c) q[c] = __fadd_rn(q[c], shift[c]);
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
      const long long j = nn_wide ? nn64[i] : nn32[i];
      const int dp = __ldg(a.data_props + i);
      const int mp = __ldg(a.model_props + j);
      incomp += real && !a.compat[dp * a.n_props + mp];
      if (a.nbr_on && real)
        nbr += abs(__ldg(a.data_nbrs + i) - __ldg(a.model_nbrs + j));
    }
  }
  if (incomp) atomicAdd(&sh.incomp, incomp);
  if (nbr) atomicAdd(&sh.nbr, nbr);
  if (bnb) atomicAdd(&sh.bnb, bnb);
  __syncthreads();

  const float nd_f =
      a.dynamic ? __ldg(a.counts) : static_cast<float>(a.n_data);

  // 2. the c-FPFH term: a warp a point, then one warp over the points
  if (full && a.fpfh_on) {
    for (int i = warp; i < nd; i += kScoreWarps) {
      const long long j = nn_wide ? nn64[i] : nn32[i];
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
      if (lane == 0) sh.fp = __fdiv_rn(acc, nd_f);
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

  // 4. and 5. the sum in the warp order, then the terms (warp 0)
  if (warp == 0) {
    if (mode == kCount) {
      if (lane == 0) res[kBnb] = __int_as_float(sh.bnb);
    } else {
      const bool square = a.norm == 2 || (trimmed && !initial);
      float acc = 0.0f;
      for (int i = lane; i < nd; i += 32) {
        const float v = kept[i];
        const float fv = square ? __fmul_rn(v, v) : v;
        acc = __fadd_rn(acc, static_cast<float>(i) < keep_below ? fv : 0.0f);
      }
      const float geom = warp_sum(acc);
      if (lane == 0 && initial) {
        float err = geom;
        if (a.reg_on)
          err = __fadd_rn(err, __fmul_rn(__fmul_rn(a.reg, nd_f), nd_f));
        if (a.seed_fpfh_on) err = __fadd_rn(err, a.seed_fpfh);
        if (a.nbr_on) {
          const float six = __fmul_rn(6.0f, nd_f);
          err = __fadd_rn(err, __fmul_rn(__fmul_rn(a.reg_nbr, six), six));
        }
        res[kErr] = err;
      } else if (lane == 0) {
        const float inc = static_cast<float>(sh.incomp);
        const float nb = static_cast<float>(sh.nbr);
        const float nbr_term =
            a.nbr_on ? __fmul_rn(__fmul_rn(a.reg_nbr, nb), nb) : 0.0f;
        const float incomp_term =
            a.reg_on ? __fmul_rn(__fmul_rn(a.reg, inc), inc) : 0.0f;
        const float fpfh_term =
            a.fpfh_on ? __fmul_rn(__fmul_rn(a.reg_fpfh, sh.fp), sh.fp)
                      : 0.0f;
        res[kErr] = __fadd_rn(
            __fadd_rn(__fadd_rn(geom, nbr_term), incomp_term), fpfh_term);
        res[kGeom] = geom;
        res[kIncTerm] = incomp_term;
        res[kFpfhTerm] = fpfh_term;
        res[kNbrTerm] = nbr_term;
        res[kInc] = inc;
        res[kBnb] = __int_as_float(sh.bnb);
      }
    }
  }
  __syncthreads();
}

// row k of the correspondences (NULL where the route reads none)
__device__ __forceinline__ const void* nn_row(const void* nn, int nn_wide,
                                              size_t k, int nd) {
  return nn == nullptr ? nullptr
                       : static_cast<const char*>(nn) +
                             (nn_wide ? 8 : 4) * k * static_cast<size_t>(nd);
}

__global__ void __launch_bounds__(kScoreThreads)
    score_kernel(ScoreArgs a, const float* __restrict__ R,
                 const float* __restrict__ t, const void* __restrict__ nn,
                 int nn_wide, float* __restrict__ out, int rows, int mode) {
  extern __shared__ float smem[];
  float* vals = smem;
  float* buf = smem + region_words(static_cast<size_t>(a.nd));
  __shared__ RowShared sh;
  __shared__ float res[kRowWords];
  const size_t k = blockIdx.x;
  score_row(a, mode, R + 9 * k, t + 3 * k, nn_row(nn, nn_wide, k, a.nd),
            nn_wide, vals, buf, sh, res);
  if (threadIdx.x != 0) return;
  if (mode == kInitial) {
    out[0] = res[kErr];
  } else if (mode == kCount) {
    reinterpret_cast<int*>(out)[k] = __float_as_int(res[kBnb]);
  } else {
    const size_t K = static_cast<size_t>(rows);
#pragma unroll
    for (int w = 0; w < kRowWords; ++w) out[w * K + k] = res[w];
  }
}

// ---------------------------------------------------------------------------
// the pick: K seed rows and the extra row in one launch
// ---------------------------------------------------------------------------

// where the pick writes: the refine record's fields at row j (kPick), or
// the new state's opt_err, opt_R, opt_t, comp, terms, last_icp (kInit)
struct PickOut {
  float* R;              // icp_R (n, 3, 3) / opt_R (3, 3)
  float* t;              // icp_t (n, 3) / opt_t (3,)
  float* err;            // icp_err (n,) / opt_err ()
  float* terms;          // icp_terms (n, 3) / terms (3,)
  int* incomp;           // icp_incomp (n,) / comp ()
  int* bnb;              // bnb_comp (n,); unused by kInit
  unsigned char* flag;   // do_icp (n,) / last_icp ()
};

struct PickArgs {
  const float* R;        // (K, 3, 3) the ICP event's results
  const float* t;        // (K, 3)
  const void* nn;        // (K, Nd) int64 (nn_wide) or int32
  int nn_wide;
  const float* cand_R;   // (3, 3) kPick: the BnB candidate
  const float* cand_t;   // (3,)
  PickOut out;
  int j;                 // kPick: the record's row
  int K, route;
  int extra;             // the block that scores the extra row
  int clustered;         // 1: the grid is one cluster; 0: the ticket form
  float* ws;             // ticket form: (K + 1) rows of kRowWords
  unsigned* ticket;      // ticket form: 0 between launches
};

// the first minimum of the K errors, as torch.argmin takes it: the first
// NaN where there is one
__device__ __forceinline__ int first_min(const float* rows, int K,
                                         int stride) {
  int bi = 0;
  float best = rows[0];
  for (int i = 1; i < K && best == best; ++i) {
    const float v = rows[i * stride];
    if (v != v || v < best) {
      best = v;
      bi = i;
    }
  }
  return bi;
}

// the winner (rows of kRowWords words, the extra row at K) written where
// the route writes; one thread.  `rows` in shared memory, or (ticket
// form) in device memory that other blocks wrote: a copy read past L1.
__device__ __forceinline__ void pick_write(const PickArgs& p,
                                           const float* rows,
                                           bool device_rows) {
  float w[kRowWords], x[kRowWords];
  int bi = 0;
  if (device_rows) {
    float best = __ldcg(rows + kErr);
    for (int i = 1; i < p.K && best == best; ++i) {
      const float v = __ldcg(rows + i * kRowWords + kErr);
      if (v != v || v < best) {
        best = v;
        bi = i;
      }
    }
#pragma unroll
    for (int e = 0; e < kRowWords; ++e) {
      w[e] = __ldcg(rows + bi * kRowWords + e);
      x[e] = __ldcg(rows + p.K * kRowWords + e);
    }
  } else {
    bi = first_min(rows + kErr, p.K, kRowWords);
#pragma unroll
    for (int e = 0; e < kRowWords; ++e) {
      w[e] = rows[bi * kRowWords + e];
      x[e] = rows[p.K * kRowWords + e];
    }
  }
  const float* Rb = p.R + 9 * bi;
  const float* tb = p.t + 3 * bi;
  const float inc_nbr = __fadd_rn(w[kIncTerm], w[kNbrTerm]);
  if (p.route == kPick) {
    const PickOut& o = p.out;
    const size_t j = p.j;
#pragma unroll
    for (int i = 0; i < 9; ++i) o.R[9 * j + i] = Rb[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) o.t[3 * j + i] = tb[i];
    o.err[j] = w[kErr];
    o.terms[3 * j] = w[kGeom];
    o.terms[3 * j + 1] = inc_nbr;
    o.terms[3 * j + 2] = w[kFpfhTerm];
    o.incomp[j] = __float2int_rz(w[kInc]);
    o.bnb[j] = __float_as_int(x[kBnb]);
    o.flag[j] = 1;
    return;
  }
  const float init = x[kErr];
  const bool better = w[kErr] < init;
  const PickOut& o = p.out;
  o.err[0] = better ? w[kErr] : init;
#pragma unroll
  for (int i = 0; i < 9; ++i)
    o.R[i] = better ? Rb[i] : (i % 4 == 0 ? 1.0f : 0.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) o.t[i] = better ? tb[i] : 0.0f;
  o.incomp[0] = better ? __float2int_rz(w[kInc]) : 0;
  o.terms[0] = better ? w[kGeom] : init;
  o.terms[1] = better ? inc_nbr : 0.0f;
  o.terms[2] = better ? w[kFpfhTerm] : 0.0f;
  o.flag[0] = better;
}

__device__ __forceinline__ void pick_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void pick_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kScoreThreads)
    pick_kernel(ScoreArgs a, PickArgs p) {
  extern __shared__ float smem[];
  float* vals = smem;
  float* buf = smem + region_words(static_cast<size_t>(a.nd));
  __shared__ RowShared sh;
  __shared__ float res[2][kRowWords];          // this block's rows
  __shared__ float rows[(kPickCluster + 1) * kRowWords];   // block 0's
  const int k = blockIdx.x;
  const bool seed = k < p.K, extra = k == p.extra;
  if (p.clustered) pick_arrive_relaxed();     // this block has started
  if (seed)
    score_row(a, kFull, p.R + 9 * k, p.t + 3 * k,
              nn_row(p.nn, p.nn_wide, k, a.nd), p.nn_wide, vals, buf, sh,
              res[0]);
  if (extra) {
    score_row(a, p.route == kPick ? kCount : kInitial, p.cand_R, p.cand_t,
              nullptr, 0, vals, buf, sh, res[1]);
  }
  const int tid = threadIdx.x;
  if (p.clustered) {
    cg::cluster_group cluster = cg::this_cluster();
    pick_wait();              // every block has started: block 0 too
    if (tid < kRowWords) {
      if (seed) cluster.map_shared_rank(rows, 0)[k * kRowWords + tid] =
          res[0][tid];
      if (extra) cluster.map_shared_rank(rows, 0)[p.K * kRowWords + tid] =
          res[1][tid];
    }
    cluster.sync();           // the rows are in block 0's shared memory
    if (k == 0 && tid == 0) pick_write(p, rows, false);
    return;
  }
  // the ticket form: the rows in device memory, the last block picks
  __shared__ bool last;
  if (tid < kRowWords) {
    if (seed) p.ws[k * kRowWords + tid] = res[0][tid];
    if (extra) p.ws[p.K * kRowWords + tid] = res[1][tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last || tid != 0) return;
  __threadfence();
  pick_write(p, p.ws, true);
  *p.ticket = 0u;
}

// ---------------------------------------------------------------------------
// the seeds of an outer step's ICP event
// ---------------------------------------------------------------------------

// does (v, lane q) come before (u, lane i) in a stable ascending sort with
// NaN last?
__device__ __forceinline__ bool sorts_before(float v, int q, float u, int i) {
  if (v != v) return u != u && q < i;
  if (u != u) return true;
  return v < u || (v == u && q < i);
}

__global__ void __launch_bounds__(kSeedThreads)
    icp_seeds_kernel(const float* __restrict__ ubs,
                     const float* __restrict__ R_lanes,
                     const float* __restrict__ nodes,
                     float* __restrict__ seed_R, float* __restrict__ seed_t,
                     int L, int K, PickOut rec, int n_rec) {
  for (int i = threadIdx.x; i < L; i += kSeedThreads) {
    const float u = ubs[i];
    int rank = 0;
    for (int q = 0; q < L; ++q) rank += sorts_before(ubs[q], q, u, i);
    if (rank < K) {
#pragma unroll
      for (int e = 0; e < 9; ++e) seed_R[9 * rank + e] = R_lanes[9 * i + e];
      const float half = __fdiv_rn(nodes[4 * i + 3], 2.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        seed_t[3 * rank + c] = __fadd_rn(nodes[4 * i + c], half);
    }
  }
  // the refine record's rows to the dummy of a row that did not refine
  const float inf = __int_as_float(0x7f800000);
  for (int r = threadIdx.x; r < n_rec; r += kSeedThreads) {
#pragma unroll
    for (int e = 0; e < 9; ++e) rec.R[9 * r + e] = e % 4 == 0 ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rec.t[3 * r + c] = 0.0f;
      rec.terms[3 * r + c] = 0.0f;
    }
    rec.err[r] = inf;
    rec.incomp[r] = 0;
    rec.bnb[r] = 0;
    rec.flag[r] = 0;
  }
}

// ScoreArgs from the wrapper's slot block
ScoreArgs score_args(const unsigned long long* slots, const int* ints,
                     const float* floats) {
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
  return a;
}

PickOut pick_out(const unsigned long long* out) {
  auto ptr = [&](int i) {
    return reinterpret_cast<void*>(static_cast<uintptr_t>(out[i]));
  };
  PickOut o;
  o.R = static_cast<float*>(ptr(0));
  o.t = static_cast<float*>(ptr(1));
  o.err = static_cast<float*>(ptr(2));
  o.terms = static_cast<float*>(ptr(3));
  o.incomp = static_cast<int*>(ptr(4));
  o.bnb = static_cast<int*>(ptr(5));
  o.flag = static_cast<unsigned char*>(ptr(6));
  return o;
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
  const ScoreArgs a = score_args(slots, ints, floats);
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

// slots, ints, floats: the pair's block as goicp_score takes it.  R (K,
// 3, 3), t (K, 3), nn (K, Nd) int64 (nn_wide) or int32: the ICP event's
// results; cand_R (3, 3), cand_t (3,): the BnB candidate (route kPick;
// NULL for kInit); out: the 7 pointers of PickOut (kInit: bnb unused),
// j the record's row; ws (K + 1) * 7 floats and ticket (one word, 0)
// in device memory, read only where K > 8.
extern "C" int goicp_score_pick(const unsigned long long* slots,
                                const int* ints, const float* floats,
                                const float* R, const float* t,
                                const void* nn, int nn_wide, long long K,
                                const float* cand_R, const float* cand_t,
                                const unsigned long long* out, int j,
                                int route, float* ws, void* ticket,
                                void* stream) {
  using namespace goicp;
  const ScoreArgs a = score_args(slots, ints, floats);
  const size_t smem = score_smem(a.nd);
  const bool clustered = K <= kPickCluster;
  if (K <= 0 || K > 0x7fffffffLL || a.nd <= 0 || smem > kMaxDynamicSmem ||
      (route != kPick && route != kInit) || j < 0 ||
      (route == kPick && (cand_R == nullptr || cand_t == nullptr)) ||
      (!clustered && (ws == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;
  cudaError_t err = allow_smem(pick_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  PickArgs p;
  p.R = R;
  p.t = t;
  p.nn = nn;
  p.nn_wide = nn_wide;
  p.cand_R = cand_R;
  p.cand_t = cand_t;
  p.out = pick_out(out);
  p.j = j;
  p.K = static_cast<int>(K);
  p.route = route;
  p.extra = K + 1 <= kPickCluster ? p.K : 0;
  p.clustered = clustered;
  p.ws = ws;
  p.ticket = static_cast<unsigned*>(ticket);
  const unsigned blocks = static_cast<unsigned>(p.extra == p.K ? K + 1 : K);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kScoreThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = clustered ? attr : nullptr;
  cfg.numAttrs = clustered ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, pick_kernel, a, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ubs (L,), R_lanes (L, 3, 3), nodes (L, 4) -> seed_R (K, 3, 3), seed_t
// (K, 3); rec: NULL, or the 7 pointers of a refine record whose n_rec
// rows the launch sets to the dummy.
extern "C" int goicp_icp_seeds(const float* ubs, const float* R_lanes,
                               const float* nodes, float* seed_R,
                               float* seed_t, long long L, int K,
                               const unsigned long long* rec, int n_rec,
                               void* stream) {
  using namespace goicp;
  if (L <= 0 || L > 0x7fffffffLL || K <= 0 || K > L || n_rec < 0 ||
      (n_rec > 0 && rec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PickOut r = {};
  if (n_rec > 0) r = pick_out(rec);
  icp_seeds_kernel<<<1, kSeedThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ubs, R_lanes, nodes, seed_R, seed_t, static_cast<int>(L), K, r, n_rec);
  return static_cast<int>(cudaGetLastError());
}
