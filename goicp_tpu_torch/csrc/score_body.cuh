// score_body: the rescoring of one row and the pick's rules, shared by
// csrc/score.cu (the rescoring, the pick, the seeds) and csrc/icp.cu (the
// refine and initial routes, which rescore and pick inside the ICP
// event's launch), so that both compile the same bodies and give the same
// bits.
//
//   score_row          one row's rescoring by a whole block (score.cu's
//                      head sets out its steps), for a block of kThreads
//                      threads;
//   score_row_cluster  the same row's rescoring (kFull, with the BnB
//                      candidate's count beside it where asked) by the C
//                      blocks of a thread-block cluster, each block the
//                      points of its share: icp.cu's routes after the ICP
//                      loop, whose blocks each hold the whole row;
//   sorts_before       the seeds' and the trimmed ranks' order: a stable
//                      ascending sort, NaN last (torch.sort's);
//   first_min          the pick's rule, torch.argmin's (the first NaN
//                      first);
//   pick_write         the winner written where the route writes;
//   dummy_row          a refine record's row that did not refine.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "fp32_order.cuh"
#include "rot_body.cuh"

namespace goicp {

constexpr int kScoreThreads = 256;
constexpr int kFull = 0, kCount = 1, kInitial = 2;
constexpr int kPick = 0, kInit = 1;            // goicp_score_pick's routes
constexpr int kNoTrim = 0, kStaticTrim = 1, kDynamicTrim = 2;
constexpr int kPickCluster = 8;   // the portable cluster size
constexpr int kRowWords = 7;      // a row's result (RowOut)
constexpr int kScoreClusterMax = 8;   // blocks of score_row_cluster's cluster

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

// the block's integer counts (the cluster form: and the candidate's) and
// the c-FPFH mean of a row
struct RowShared {
  int incomp, nbr, bnb, cand;
  float fp;
};

// dynamic shared memory a row needs: its values and their ranked copy
__host__ __forceinline__ size_t score_smem(int nd) {
  return 2 * region_words(static_cast<size_t>(nd)) * sizeof(float);
}

// does (v, q) come before (u, i) in a stable ascending sort with NaN last
// (torch.sort's order)?  The seeds' lanes and the trimmed ranks.
__device__ __forceinline__ bool sorts_before(float v, int q, float u, int i) {
  if (v != v) return u != u && q < i;
  if (u != u) return true;
  return v < u || (v == u && q < i);
}

// Step 1 of a row for point i (score.cu's head): the value the sum takes
// (modes kFull, kInitial) and the point's integer counts added to incomp,
// nbr and bnb; j the point's correspondence (kFull).  r, shift: the
// transform in registers (the identity and 0 for kInitial).  data: the
// pair's (Nd, 3) points, a.data or a copy in shared memory.
__device__ __forceinline__ float score_point(const ScoreArgs& a,
                                             const GridConsts& g, int mode,
                                             const float* r,
                                             const float* shift,
                                             const float* data, int i,
                                             long long j, int& incomp,
                                             int& nbr, int& bnb) {
  const bool full = mode == kFull, initial = mode == kInitial;
  const bool trimmed = a.trim != kNoTrim;
  float p[3], q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = data[3 * i + c];
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
  float v = 0.0f;
  if (mode != kCount) {
    float d = __ldg(a.dist + vox);
    if (oob) {
      const float s = __fadd_rn(
          __fadd_rn(__fmul_rn(ex[0], ex[0]), __fmul_rn(ex[1], ex[1])),
          __fmul_rn(ex[2], ex[2]));
      d = __fadd_rn(d, __fdiv_rn(__fsqrt_rn(s), g.scale));
    }
    // the rescoring's trim drops the weights (the reference's quirk)
    v = trimmed && !initial ? d : __fmul_rn(__ldg(a.weights + i), d);
    if (trimmed && !(m > 0.0f)) v = __int_as_float(0x7f800000);
  }
  if (mode != kInitial) {
    const int cell = __ldg(a.nearest + vox);
    bnb += real && !a.table[static_cast<size_t>(i) * a.n_cells + cell];
  }
  if (full) {
    const int dp = __ldg(a.data_props + i);
    const int mp = __ldg(a.model_props + j);
    incomp += real && !a.compat[dp * a.n_props + mp];
    if (a.nbr_on && real)
      nbr += abs(__ldg(a.data_nbrs + i) - __ldg(a.model_nbrs + j));
  }
  return v;
}

// Step 2's per-point value: the c-FPFH distance of point i to its
// correspondence j by the calling warp (lane b adds |f_d[b] - f_m[b]| for
// b = lane, lane + 32, ..., the xor butterfly), times the mask; every lane
// gets it.
__device__ __forceinline__ float fpfh_point(const ScoreArgs& a, int i,
                                            long long j) {
  const int lane = threadIdx.x & 31;
  const float* fd = a.data_fpfh + static_cast<size_t>(i) * a.bins;
  const float* fm = a.model_fpfh + static_cast<size_t>(j) * a.bins;
  float acc = 0.0f;
  for (int b = lane; b < a.bins; b += 32)
    acc = __fadd_rn(acc, fabsf(__fsub_rn(__ldg(fd + b), __ldg(fm + b))));
  return __fmul_rn(warp_sum(acc), __ldg(a.mask + i));
}

// the kept-set size where the rescoring ranks its values: counts[1]
// (dynamic K) or inlier_num, and whether it ranks at all (a static K not
// below Nd takes the values unsorted, as trimmed_smallest does)
__device__ __forceinline__ bool score_ranks(const ScoreArgs& a, int mode) {
  return mode != kCount && a.trim != kNoTrim &&
         (a.trim == kDynamicTrim || a.inlier_num < a.nd);
}

__device__ __forceinline__ float score_keep_below(const ScoreArgs& a,
                                                  int mode) {
  if (mode == kCount || a.trim == kNoTrim) return static_cast<float>(a.nd);
  return a.trim == kDynamicTrim ? __ldg(a.counts + 1)
                                : static_cast<float>(a.inlier_num);
}

// value v of point i's stable rank among vals[0, nd) counted over j = g,
// g + G, ... (G threads a point add their counts)
__device__ __forceinline__ int rank_part(const float* vals, int nd, float v,
                                         int i, int g, int G) {
  const bool vn = v != v;
  int rank = 0;
  for (int j = g; j < nd; j += G) {
    const float u = vals[j];
    rank += vn ? (u == u || j < i) : (u < v || (u == v && j < i));
  }
  return rank;
}

// Steps 4 and 5 by warp 0 (every thread calls it): the sum of f(v) over
// kept[0, nd) in the warp order, positions below keep_below, then the
// terms in the torch bodies' order into res; kCount: the BnB count
__device__ __forceinline__ void score_terms(const ScoreArgs& a, int mode,
                                            const float* kept,
                                            float keep_below, float nd_f,
                                            const RowShared& sh, float* res) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  if (mode == kCount) {
    if (lane == 0) res[kBnb] = __int_as_float(sh.bnb);
    return;
  }
  const bool initial = mode == kInitial;
  const bool square = a.norm == 2 || (a.trim != kNoTrim && !initial);
  float acc = 0.0f;
  for (int i = lane; i < a.nd; i += 32) {
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
    res[kErr] = err;
    return;
  }
  const float inc = static_cast<float>(sh.incomp);
  const float nb = static_cast<float>(sh.nbr);
  const float nbr_term =
      a.nbr_on ? __fmul_rn(__fmul_rn(a.reg_nbr, nb), nb) : 0.0f;
  const float incomp_term =
      a.reg_on ? __fmul_rn(__fmul_rn(a.reg, inc), inc) : 0.0f;
  const float fpfh_term =
      a.fpfh_on ? __fmul_rn(__fmul_rn(a.reg_fpfh, sh.fp), sh.fp) : 0.0f;
  res[kErr] = __fadd_rn(__fadd_rn(__fadd_rn(geom, nbr_term), incomp_term),
                        fpfh_term);
  res[kGeom] = geom;
  res[kIncTerm] = incomp_term;
  res[kFpfhTerm] = fpfh_term;
  res[kNbrTerm] = nbr_term;
  res[kInc] = inc;
  res[kBnb] = __int_as_float(sh.bnb);
}

__device__ __forceinline__ float score_nd(const ScoreArgs& a) {
  return a.dynamic ? __ldg(a.counts) : static_cast<float>(a.n_data);
}

// One row's score by the whole block of kThreads threads (every thread
// calls it): `mode` kFull / kCount at (R, t) with the correspondences nn
// (Nd entries, int64 if nn_wide), kInitial at the unrotated data.  R, t
// and nn may lie in shared or device memory; vals and buf (each
// region_words(Nd) words) in either.  The result lands in res[0 ..
// kRowWords) (shared), visible to every thread on return.  Every value is
// a point's own or a sum in a fixed order, so the bits do not depend on
// kThreads.
template <int kThreads = kScoreThreads>
__device__ __forceinline__ void score_row(const ScoreArgs& a, int mode,
                          const float* __restrict__ R,
                          const float* __restrict__ t, const void* nn,
                          int nn_wide, float* vals, float* buf,
                          RowShared& sh, float* res) {
  const int nd = a.nd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh.incomp = sh.nbr = sh.bnb = 0;
  __syncthreads();

  const bool full = mode == kFull;
  float r[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float shift[3] = {0.0f, 0.0f, 0.0f};
  if (mode != kInitial) {
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) shift[i] = t[i];
  }
  const GridConsts g = load_consts(a.consts);
  const long long* nn64 = static_cast<const long long*>(nn);
  const int* nn32 = static_cast<const int*>(nn);
  auto nn_of = [&](int i) -> long long {
    return full ? (nn_wide ? nn64[i] : nn32[i]) : 0;
  };

  // 1. the points
  int incomp = 0, nbr = 0, bnb = 0;
  for (int i = tid; i < nd; i += kThreads) {
    const float v = score_point(a, g, mode, r, shift, a.data, i, nn_of(i),
                                incomp, nbr, bnb);
    if (mode != kCount) vals[i] = v;
  }
  if (incomp) atomicAdd(&sh.incomp, incomp);
  if (nbr) atomicAdd(&sh.nbr, nbr);
  if (bnb) atomicAdd(&sh.bnb, bnb);
  __syncthreads();
  const float nd_f = score_nd(a);

  // 2. the c-FPFH term: a warp a point, then one warp over the points
  if (full && a.fpfh_on) {
    for (int i = warp; i < nd; i += kThreads / 32) {
      const float f = fpfh_point(a, i, nn_of(i));
      if (lane == 0) buf[i] = f;
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
  if (score_ranks(a, mode)) {
    for (int i = tid; i < nd; i += kThreads) {
      const float v = vals[i];
      buf[rank_part(vals, nd, v, i, 0, 1)] = v;
    }
    __syncthreads();
    kept = buf;
  }

  // 4. and 5. the sum in the warp order, then the terms (warp 0)
  score_terms(a, mode, kept, score_keep_below(a, mode), nd_f, sh, res);
  __syncthreads();
}

// The cluster form of score_row, mode kFull (csrc/icp.cu's routes after
// the ICP loop, every thread of the cluster's c blocks calls it): block
// `rank` takes the points of its share [lo, lo + nb), the share it took in
// the loop.  Each block holds the row's correspondences (the loop's last
// (d2, NN index) pairs, `last`, NULL where no iteration ran: index 0), the
// points (data: a.data or a copy in shared memory) and its own vals, buf
// and fpv (Nd words each, shared memory, at the same offsets in every
// block); block 0's hold the row.  There is no barrier on entry: vals,
// buf and fpv must lie in words no block reads after its arrival at the
// ICP loop's last barrier (icp.cu's epilogue), which every block passes
// before this.
//   - Step 1 for the share, each point's value sent to block 0's vals
//     (to every block's where the values are ranked), the integer counts
//     as the block's partials to block 0's parts; with cand_R, the BnB
//     candidate's count at (cand_R, cand_t) beside it, a fourth partial
//     (R, t, cand_R and cand_t read at each point, not held in registers).
//     The c-FPFH values a warp a point into block 0's fpv.  A barrier.
//   - Ranked (score_ranks): each share point's stable rank, G threads a
//     point over the block's own vals (G the largest power of two <= 32
//     with the share's G threads a point in the block), the value written
//     at its rank into block 0's buf.  A barrier.
//   - Block 0 adds the partials (integers: exact in any order) and forms
//     the c-FPFH mean, the sum and the terms as score_row does, in the
//     same orders: the same bits.  It returns true, holding the row in res
//     (and the candidate's count in cand_res[kBnb]); the other blocks
//     return false, and no block reads or writes another's shared memory
//     after the last barrier.
// kStop (bench/refine_stops.py's stop points; a.nd >= 0 keeps the
// compiler from folding them): 2 returns false after the values' barrier,
// 3 after the ranks'.
template <int kThreads, int kStop = 99>
__device__ __forceinline__ bool score_row_cluster(
    const ScoreArgs& a, const float* R, const float* t, const float2* last,
    const float* data, const float* cand_R, const float* cand_t, int c,
    int rank, int lo, int nb, float* vals, float* buf, float* fpv,
    RowShared& sh, float* res, float* cand_res) {
  namespace cg = cooperative_groups;
  __shared__ int parts[kScoreClusterMax][4];     // block 0's: the partials
  cg::cluster_group cluster = cg::this_cluster();
  const int nd = a.nd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ranked = score_ranks(a, kFull), count = cand_R != nullptr;
  if (tid == 0) sh.incomp = sh.nbr = sh.bnb = sh.cand = 0;
  const GridConsts g = load_consts(a.consts);
  auto nn_of = [&](int i) -> long long {
    return last == nullptr ? 0 : __float_as_int(last[i].y);
  };
  __syncthreads();

  // 1. the share's points (and the candidate's count)
  int incomp = 0, nbr = 0, bnb = 0, cand = 0, unused = 0;
  for (int i = lo + tid; i < lo + nb; i += kThreads) {
    const float v = score_point(a, g, kFull, R, t, data, i, nn_of(i),
                                incomp, nbr, bnb);
    if (ranked) {
      for (int q = 0; q < c; ++q) cluster.map_shared_rank(vals, q)[i] = v;
    } else {
      cluster.map_shared_rank(vals, 0)[i] = v;
    }
    if (count)
      score_point(a, g, kCount, cand_R, cand_t, data, i, 0, unused, unused,
                  cand);
  }
  if (incomp) atomicAdd(&sh.incomp, incomp);
  if (nbr) atomicAdd(&sh.nbr, nbr);
  if (bnb) atomicAdd(&sh.bnb, bnb);
  if (cand) atomicAdd(&sh.cand, cand);
  if (a.fpfh_on) {
    float* fp0 = cluster.map_shared_rank(fpv, 0);
    for (int i = lo + warp; i < lo + nb; i += kThreads / 32) {
      const float f = fpfh_point(a, i, nn_of(i));
      if (lane == 0) fp0[i] = f;
    }
  }
  __syncthreads();
  if (tid < 4) {
    const int w = tid == 0 ? sh.incomp
                           : (tid == 1 ? sh.nbr
                                       : (tid == 2 ? sh.bnb : sh.cand));
    cluster.map_shared_rank(&parts[0][0], 0)[4 * rank + tid] = w;
  }
  cluster.sync();
  if (kStop == 2 && nd >= 0) return false;

  // 3. the ranks, G threads a point
  if (ranked) {
    int g_log = 5;
    while (g_log > 0 && (nb << g_log) > kThreads) --g_log;
    const int G = 1 << g_log, slots = kThreads >> g_log;
    const int slot = tid >> g_log, gi = tid & (G - 1);
    float* buf0 = cluster.map_shared_rank(buf, 0);
    for (int base = 0; base < nb; base += slots) {
      const int li = base + slot, i = lo + li;
      const float v = li < nb ? vals[i] : 0.0f;
      int rk = li < nb ? rank_part(vals, nd, v, i, gi, G) : 0;
      for (int off = G >> 1; off > 0; off >>= 1)
        rk += __shfl_xor_sync(0xffffffffu, rk, off);
      if (li < nb && gi == 0) buf0[rk] = v;
    }
    cluster.sync();
  }
  if (kStop == 3 && nd >= 0) return false;
  if (rank != 0) return false;

  // 4. block 0: the partials, the c-FPFH mean, the sum and the terms
  if (tid == 0) {
    int s[4] = {0, 0, 0, 0};
    for (int q = 0; q < c; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += parts[q][e];
    sh.incomp = s[0];
    sh.nbr = s[1];
    sh.bnb = s[2];
    sh.cand = s[3];
  }
  __syncthreads();
  const float nd_f = score_nd(a);
  if (a.fpfh_on && warp == 0) {
    float acc = 0.0f;
    for (int i = lane; i < nd; i += 32) acc = __fadd_rn(acc, fpv[i]);
    acc = warp_sum(acc);
    if (lane == 0) sh.fp = __fdiv_rn(acc, nd_f);
  }
  __syncthreads();
  score_terms(a, kFull, ranked ? buf : vals, score_keep_below(a, kFull),
              nd_f, sh, res);
  if (count && tid < kRowWords)
    cand_res[tid] = tid == kBnb ? __int_as_float(sh.cand) : 0.0f;
  __syncthreads();
  return true;
}

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

// row r of a refine record set to the dummy of a row that did not refine
// (identity, 0, inf, 0, 0, 0, do_icp 0)
__device__ __forceinline__ void dummy_row(const PickOut& rec, int r) {
#pragma unroll
  for (int e = 0; e < 9; ++e) rec.R[9 * r + e] = e % 4 == 0 ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rec.t[3 * r + c] = 0.0f;
    rec.terms[3 * r + c] = 0.0f;
  }
  rec.err[r] = __int_as_float(0x7f800000);
  rec.incomp[r] = 0;
  rec.bnb[r] = 0;
  rec.flag[r] = 0;
}

// ScoreArgs from the wrapper's slot block
inline ScoreArgs score_args(const unsigned long long* slots, const int* ints,
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

// PickOut from the wrapper's 7 pointers
inline PickOut pick_out(const unsigned long long* out) {
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
