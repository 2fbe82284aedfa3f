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
// host no time.  The row's body (score_row), the pick's rules (first_min,
// pick_write) and the seeds' order (sorts_before) live in score_body.cuh,
// which csrc/icp.cu's refine route compiles too: the engines' refinements
// run there, one launch for a transition's refining rows, and of this
// file's seeds and pick only the initial incumbent's route (kInit) is on
// the main path; phase 2 of chip_smoke.py holds the others to their plain
// versions.
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

#include "score_body.cuh"

namespace cg = cooperative_groups;

namespace goicp {

constexpr int kSeedThreads = 256;

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
  for (int r = threadIdx.x; r < n_rec; r += kSeedThreads) dummy_row(rec, r);
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
