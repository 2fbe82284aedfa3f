// One lane's share of an inner-BnB iteration (search/inner.py::
// _make_inner_body), shared by the two kernels of inner.cu: the step
// (goicp_inner_step, one iteration a launch, a lane's blocks meeting
// through a ticket and scratch in device memory) and the run
// (goicp_inner_run, the iterations of a whole search in one launch, a
// lane's blocks a thread-block cluster meeting in distributed shared
// memory).  One source, so that both compile the same float steps and
// keep the same bits.  What an iteration computes, step by step, and its
// rounding and NaN rules are written in inner.cu's header.
#pragma once

#include "chem_body.cuh"
#include "geom_body.cuh"

namespace goicp {

constexpr int kStepWarps = 8;

// the 19 lattice points of a parent that are not its own cube corners
// (search/inner.py::_ODD_LATTICE), lattice index (z * 3 + y) * 3 + x
__constant__ int kOddLattice[19] = {1,  3,  4,  5,  7,  9,  10, 11, 12, 13,
                                    14, 15, 16, 17, 19, 21, 22, 23, 25};

// one set of the lanes' fields (search/inner.py::_PER_LANE), read
struct LaneIn {
  const float* nodes;          // (L, cap, 4)
  const float* lbs;            // (L, cap)
  const float* cvals;          // (L, cap, 8) or null: no corner reuse
  const float* opt_err;        // (L,)
  const float* thr;            // (L,)
  const float* best_node;      // (L, 4)
  const float* ub_terms;       // (L, 3)
  const float* min_dropped;    // (L,)
  const unsigned char* done;   // (L,)
};

// and written
struct LaneOut {
  float* nodes;
  float* lbs;
  float* cvals;
  float* opt_err;
  float* thr;
  float* best_node;
  float* ub_terms;
  float* min_dropped;
  unsigned char* done;
};

__host__ __device__ __forceinline__ LaneIn as_input(const LaneOut& o) {
  return LaneIn{o.nodes, o.lbs,       o.cvals,       o.opt_err, o.thr,
                o.best_node, o.ub_terms, o.min_dropped, o.done};
}

struct StepParams {
  GeomParams geom;           // tables, trim, norm, fused (centres local)
  ChemParams chem;           // tables; cell_compat null: no chem term
  const int* lane_pair;      // (L,) or null: every lane reads pair 0
  const float* sse;          // (W,) the search epsilon of each pair
  LaneIn in;                 // the lanes' state before the (first) step
  LaneOut out;               // the step's output set (the run's set A)
  const unsigned char* live; // (L / group,) or null: every lane live
  const int* cnt_in[4];      // (L / group,) it, evals, geom_surv,
                             // chem_corners; null: 0
  int* o_stats;              // the step: evals (L), geom_surv (L),
                             // counters (4, L / group), lanes not done (1)
  unsigned int* tickets;     // the step: (L + 1) zeroed: the block that
                             // takes a lane's last ticket finishes that
                             // lane, the one that takes the last of [L]
                             // the counters
  float* scratch;            // the step: (L, 3 B + Q): each lane's bounds
                             // (ub, ubu, lb of its children, compacted)
                             // and counts
  int L, cap, pop, group, reuse, sorted_merge;
  int blocks_per_lane;
  float reg;
  int step_words;            // the step's own shared arrays, then the
                             // bodies' region
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ float min_nan(float a, float b) {   // minimum
  return is_nan(a) || is_nan(b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// the merge's order: a before b
__device__ __forceinline__ bool key_less(float a, float b, bool nan_last) {
  return nan_last ? (a < b || (is_nan(b) && !is_nan(a))) : a < b;
}

__device__ __forceinline__ bool key_equal(float a, float b, bool nan_last) {
  return a == b || (nan_last && is_nan(a) && is_nan(b));
}

// argmin's order: NaN first, then the value, then the index
__device__ __forceinline__ bool arg_before(float a, int ia, float b,
                                           int ib) {
  if (is_nan(a) || is_nan(b)) return is_nan(a) && (!is_nan(b) || ia < ib);
  return a < b || (a == b && ia < ib);
}

// A lane's state copied whole from `in` to `out` with `done` as its new
// flag, by the calling block.
__device__ __forceinline__ void copy_lane(const StepParams& p,
                                          const LaneIn& in,
                                          const LaneOut& out, int lane,
                                          bool done) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int C = p.cap;
  const size_t lc = static_cast<size_t>(lane) * C;
  const int pw = in.cvals != nullptr ? 8 : 0;
  for (int i = t; i < 4 * C; i += nt)
    out.nodes[4 * lc + i] = __ldcg(in.nodes + 4 * lc + i);
  for (int i = t; i < C; i += nt) out.lbs[lc + i] = __ldcg(in.lbs + lc + i);
  for (int i = t; i < pw * C; i += nt)
    out.cvals[pw * lc + i] = __ldcg(in.cvals + pw * lc + i);
  if (t < 4) out.best_node[4 * lane + t] = __ldcg(in.best_node + 4 * lane + t);
  if (t < 3) out.ub_terms[3 * lane + t] = __ldcg(in.ub_terms + 3 * lane + t);
  if (t == 0) {
    out.opt_err[lane] = __ldcg(in.opt_err + lane);
    out.thr[lane] = __ldcg(in.thr + lane);
    out.min_dropped[lane] = __ldcg(in.min_dropped + lane);
    out.done[lane] = done ? 1 : 0;
  }
}

// Lane state is read through L2 (__ldcg): a run reads sets that other
// blocks wrote earlier in the same launch, which no stale L1 line may hide.
//
// One block's part of lane `lane`'s iteration from `in` into `out`
// (steps 1-7 of inner.cu's header); part is the block's index among the
// lane's blocks_per_lane.  live: the lane's group steps.  stats: (2 L)
// the lane's evaluations at [lane] and geometric survivors at [L + lane]
// (0 for a lane that did not step).  frozen: null (the step), or the run's
// (L,) count of the copies a lane that no longer steps has had: such a
// lane is copied into each of the run's two output sets once, and after
// that left alone in both.
//
// ex carries the bounds and counts between the lane's blocks:
//   ex.parts(s_ub, s_ubu, s_lb, s_count, lane, ub, ubu, lb, count): where
//     this block writes its share (node and corner index as the arrays');
//   ex.gather(lane, part, nb, nper, Q, qper, fused, s_ub, s_ubu, s_lb,
//     s_count): called by every block of the lane after its share; true
//     in the block that goes on with the lane, whose s_ arrays then hold
//     every share (nper children and qper corners a block, in part order).
// Every return is the same for the whole block.
template <typename Exchange>
__device__ __forceinline__ void step_lane(const StepParams& p,
                                          const LaneIn& in,
                                          const LaneOut& out, int lane,
                                          int part, bool live, int* stats,
                                          int* frozen, unsigned char* smem,
                                          Exchange& ex) {
  __shared__ int s_nexp, s_surv, s_bc;
  __shared__ float s_red[kStepWarps];
  __shared__ float s_scal[4];            // opt_err, thr, prune_ref, improved

  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, tid = t & 31;
  const int P = p.pop, B = 8 * P, C = p.cap, R = C - P, N = R + B;
  const bool chem = p.chem.cell_compat != nullptr;
  const int per_parent = chem ? (p.reuse ? 19 : 27) : 0;
  const int Q = per_parent * P;
  const int pair = p.lane_pair != nullptr ? p.lane_pair[lane] : 0;
  const bool fused = p.geom.fused;
  const float inf = __int_as_float(0x7f800000);
  const size_t lc = static_cast<size_t>(lane) * C;

  float* s_child = reinterpret_cast<float*>(smem);   // (B, 4)
  float* s_cen = s_child + 4 * B;                    // (B, 3) compacted
  float* s_wid = s_cen + 3 * B;                      // (B,) compacted
  float* s_ub = s_wid + B;                           // (B,) compacted
  float* s_ubu = s_ub + B;
  float* s_lb = s_ubu + B;
  float* s_cub = s_lb + B;                           // (B,) per child
  float* s_cubu = s_cub + B;
  float* s_term = s_cubu + B;                        // (B, 3)
  float* s_ccv = s_term + 3 * B;                     // (B, 8)
  float* s_corner = s_ccv + 8 * B;                   // (Q, 3)
  float* s_count = s_corner + 3 * Q;                 // (Q,)
  float* s_key = s_count + Q;                        // (N,)
  int* s_erank = reinterpret_cast<int*>(s_key + N);  // (P,) expanded rank
  unsigned char* body_smem = smem + 4 * static_cast<size_t>(p.step_words);

  const bool done_in = __ldcg(in.done + lane) != 0;
  const float ref = __ldcg((fused ? in.thr : in.opt_err) + lane);
  const float sse = p.sse[pair];
  const float lb0 = __ldcg(in.lbs + lc);
  const bool done = done_in || fabsf(lb0) == inf || __fsub_rn(ref, lb0) < sse;

  if (!live || done) {
    if (part != 0) return;
    if (frozen != nullptr) {
      const int copies = frozen[lane];
      __syncthreads();
      if (copies >= 2) {
        if (t == 0) stats[lane] = stats[p.L + lane] = 0;
        return;
      }
      if (t == 0) frozen[lane] = copies + 1;
    }
    // the lane's state as it was (a done lane's done is now set)
    copy_lane(p, in, out, lane, live || done_in);
    if (t == 0) stats[lane] = stats[p.L + lane] = 0;
    return;
  }
  const float opt_old = __ldcg(in.opt_err + lane);
  // ---- 1-2. pop, expand, children (compacted for the bounds) ----
  if (t == 0) {
    int e = 0;
    for (int q = 0; q < P; ++q) {
      const float plb = __ldcg(in.lbs + lc + q);
      const bool ex_ = fabsf(plb) != inf && !is_nan(plb) &&
                       __fsub_rn(ref, plb) >= sse;
      s_erank[q] = ex_ ? e++ : -1;
    }
    s_nexp = e;
    s_surv = 0;
  }
  __syncthreads();
  for (int j = t; j < B; j += nt) {
    const int q = j >> 3, c = j & 7;
    const float* par = in.nodes + 4 * (lc + q);
    const float cw = __fdiv_rn(__ldcg(par + 3), 2.0f);
    const float half = __fdiv_rn(cw, 2.0f);
    const int e = s_erank[q];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float off = static_cast<float>((c >> a) & 1);
      const float x = __fadd_rn(__ldcg(par + a), __fmul_rn(off, cw));
      s_child[4 * j + a] = x;
      if (e >= 0) s_cen[3 * (8 * e + c) + a] = __fadd_rn(x, half);
    }
    s_child[4 * j + 3] = cw;
    if (e >= 0) s_wid[8 * e + c] = cw;
  }
  for (int k = t; k < Q; k += nt) {
    const int q = k / per_parent, m = k % per_parent;
    const int i = p.reuse ? kOddLattice[m] : m;
    const float* par = in.nodes + 4 * (lc + q);
    const float cw = __fdiv_rn(__ldcg(par + 3), 2.0f);
    s_corner[3 * k + 0] =
        __fadd_rn(__ldcg(par), __fmul_rn(static_cast<float>(i % 3), cw));
    s_corner[3 * k + 1] = __fadd_rn(
        __ldcg(par + 1), __fmul_rn(static_cast<float>((i / 3) % 3), cw));
    s_corner[3 * k + 2] =
        __fadd_rn(__ldcg(par + 2), __fmul_rn(static_cast<float>(i / 9), cw));
  }
  __syncthreads();

  // ---- 3-4. this block's part of the bounds and the counts ----
  {
    const int K = p.blocks_per_lane;
    const int nb = 8 * s_nexp, nper = (nb + K - 1) / K;
    const int qper = (Q + K - 1) / K;
    float *o_ub, *o_ubu, *o_lb, *o_count;
    ex.parts(s_ub, s_ubu, s_lb, s_count, lane, o_ub, o_ubu, o_lb, o_count);
    const int n0 = min(part * nper, nb), n1 = min(n0 + nper, nb);
    const int q0 = min(part * qper, Q), q1 = min(q0 + qper, Q);
    if (n1 > n0) {
      geom_bounds_body<true>(p.geom, lane, pair, body_smem, n0, n1, s_cen,
                             s_wid, o_ub, fused ? o_ubu : o_lb,
                             fused ? o_lb : nullptr);
      __syncthreads();
    }
    if (q1 > q0)
      chem_incomp_body<true>(p.chem, lane, pair, body_smem, q0, q1, s_corner,
                             o_count);
    if (!ex.gather(lane, part, nb, nper, Q, qper, fused, s_ub, s_ubu, s_lb,
                   s_count))
      return;
  }

  // per child: the masked bounds, the chem terms, its corner payload
  int surv = 0;
  for (int j = t; j < B; j += nt) {
    const int q = j >> 3, c = j & 7, e = s_erank[q];
    const bool valid = e >= 0;
    const int k = 8 * e + c;
    float ub = valid ? s_ub[k] : inf;
    float lb = valid ? s_lb[k] : inf;
    float ubu = fused && valid ? s_ubu[k] : inf;
    surv += valid && !(lb >= opt_old);
    float t0 = ub, t1 = 0.0f;
    if (chem) {
      float vmax = 0.0f, vmin = 0.0f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int ox = (c & 1) + (m & 1), oy = ((c >> 1) & 1) + ((m >> 1) & 1),
                  oz = ((c >> 2) & 1) + ((m >> 2) & 1);
        const int i = (oz * 3 + oy) * 3 + ox;
        float v;
        if (p.reuse) {
          // even lattice points are the parent's stored corners: stored
          // corner s sits at (2 (s & 1), 2 ((s >> 1) & 1), 2 (s >> 2))
          const bool even = (ox & 1) == 0 && (oy & 1) == 0 && (oz & 1) == 0;
          const int s = (ox >> 1) | ((oy >> 1) << 1) | ((oz >> 1) << 2);
          int odd = 0;
          for (int r = 0; r < 19; ++r) odd = kOddLattice[r] == i ? r : odd;
          v = even ? __ldcg(in.cvals + 8 * (lc + q) + s)
                   : s_count[19 * q + odd];
          s_ccv[8 * j + m] = v;
        } else {
          v = s_count[27 * q + i];
        }
        if (m == 0) {
          vmax = v;
          vmin = v;
        } else {
          vmax = is_nan(vmax) || is_nan(v) ? __int_as_float(0x7fffffff)
                                           : fmaxf(vmax, v);
          vmin = min_nan(vmin, v);
        }
      }
      const float ub_t = __fmul_rn(__fmul_rn(p.reg, vmax), vmax);
      const float lb_t = __fmul_rn(__fmul_rn(p.reg, vmin), vmin);
      const float ub_add = __fadd_rn(0.0f, ub_t);
      ub = __fadd_rn(ub, ub_add);
      lb = __fadd_rn(lb, __fadd_rn(0.0f, lb_t));
      ubu = __fadd_rn(ubu, ub_add);
      t0 = __fsub_rn(__fsub_rn(ub, ub_t), 0.0f);
      t1 = ub_t;
    }
    s_cub[j] = ub;
    s_cubu[j] = ubu;
    s_key[R + j] = lb;        // pruned below
    s_term[3 * j + 0] = t0;
    s_term[3 * j + 1] = t1;
    s_term[3 * j + 2] = 0.0f;
  }
  if (surv) atomicAdd(&s_surv, surv);
  for (int r = t; r < R; r += nt) s_key[r] = __ldcg(in.lbs + lc + P + r);
  __syncthreads();

  // ---- 5-6. adopt the best child, the threshold, the prune ----
  if (warp == 0) {
    float bv = inf, mu = inf;
    int bi = 0x7fffffff;
    for (int j = tid; j < B; j += 32) {
      const float v = s_cub[j];
      if (arg_before(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
      mu = min_nan(mu, s_cubu[j]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (arg_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
      mu = min_nan(mu, __shfl_xor_sync(0xffffffffu, mu, off));
    }
    if (tid == 0) {
      const float thr_old = __ldcg(in.thr + lane);
      const bool improved = !(bv >= opt_old);   // NaN-infectious <
      const float opt_new = improved ? bv : opt_old;
      const float thr_new =
          fused ? min_nan(thr_old, min_nan(opt_new, mu)) : thr_old;
      s_scal[0] = opt_new;
      s_scal[1] = thr_new;
      s_scal[2] = fused ? thr_new : opt_new;
      s_scal[3] = improved ? 1.0f : 0.0f;
      s_bc = bi;
    }
  }
  __syncthreads();
  const float prune_ref = s_scal[2];
  for (int j = t; j < B; j += nt)
    if (s_key[R + j] >= prune_ref) s_key[R + j] = inf;
  __syncthreads();

  // ---- 7. the merge: each entry's rank among the R + B keys ----
  const bool nan_last = !p.sorted_merge;
  const int pw = p.reuse ? 8 : 0;
  float drop_min = inf;
  for (int e = t; e < N; e += nt) {
    const float v = s_key[e];
    const float k = nan_last || !is_nan(v) ? v : inf;
    int rank = 0;
    for (int f = 0; f < N; ++f) {
      const float w = s_key[f];
      const float kf = nan_last || !is_nan(w) ? w : inf;
      rank += key_less(kf, k, nan_last) || (f < e && key_equal(kf, k, nan_last));
    }
    if (rank < C) {
      const size_t o = lc + rank;
      out.lbs[o] = v;
      // a frontier entry from the input set (device memory), a child
      // from this block's shared memory
#pragma unroll
      for (int a = 0; a < 4; ++a)
        out.nodes[4 * o + a] = e < R ? __ldcg(in.nodes + 4 * (lc + P + e) + a)
                                     : s_child[4 * (e - R) + a];
      if (pw) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
          out.cvals[8 * o + a] = e < R
                                     ? __ldcg(in.cvals + 8 * (lc + P + e) + a)
                                     : s_ccv[8 * (e - R) + a];
      }
    } else if (fabsf(v) != inf && !is_nan(v)) {
      drop_min = fminf(drop_min, v);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    drop_min = fminf(drop_min, __shfl_xor_sync(0xffffffffu, drop_min, off));
  if (tid == 0) s_red[warp] = drop_min;
  __syncthreads();

  // ---- the lane's scalars ----
  if (t == 0) {
    float m = inf;
    for (int w = 0; w < nt / 32; ++w) m = fminf(m, s_red[w]);
    const bool improved = s_scal[3] != 0.0f;
    const int bc = s_bc;
    out.opt_err[lane] = s_scal[0];
    out.thr[lane] = s_scal[1];
    out.min_dropped[lane] = min_nan(__ldcg(in.min_dropped + lane), m);
    out.done[lane] = 0;
    stats[lane] = 8 * s_nexp;
    stats[p.L + lane] = s_surv;
    for (int a = 0; a < 4; ++a)
      out.best_node[4 * lane + a] =
          improved ? s_child[4 * bc + a] : __ldcg(in.best_node + 4 * lane + a);
    for (int a = 0; a < 3; ++a)
      out.ub_terms[3 * lane + a] =
          improved ? s_term[3 * bc + a] : __ldcg(in.ub_terms + 3 * lane + a);
  }
  // the block's shared arrays are free again once every thread is here
  __syncthreads();
}

}  // namespace goicp
