// goicp_inner_step: one whole iteration of the inner translation BnB
// (goicp_tpu_torch/search/inner.py::_make_inner_body) for a batch of lanes,
// in one launch.  The JAX package leaves this iteration to XLA around its
// two Pallas kernels (goicp_tpu/search/inner.py::_make_inner_body, the
// bounds of goicp_tpu/bounds/pallas_eval.py :517/:632 and the counts of
// :702/:778); the port ran it as ~130 torch ops around K3 and K4.
//
// K blocks serve one lane (K3/K4 spread a lane over as many), reading its
// pair's tables through lane_pair (all lanes pair 0 when lane_pair is
// null: the one-pair engines).  Every block of a lane
//   1. computes `done` from the frontier's min lb, the reference error
//      (thr fused, opt_err plain) and the pair's epsilon; a done lane, and
//      a lane of a group the caller marks not live, is copied unchanged
//      (by the lane's first block);
//   2. pops the P lowest-lb nodes (the frontier is sorted: a slice) with
//      their `expand` mask and builds the 8P children, their centres and
//      widths in shared memory;
//   3. evaluates its K-th of the expanded parents' children through the
//      body of K1/K3 (geom_body.cuh; every mode: fused or plain, norm 1/2,
//      untrimmed, static K, dynamic K from trim_count);
//   4. evaluates its K-th of the incompatibility counts at the parents'
//      lattice points through the body of K2/K4 (chem_body.cuh): the 19
//      new points of each parent with its 8 stored corners (corner
//      reuse), or all 27; both into the lane's scratch in device memory.
// The lane's last block to finish (a per-lane ticket) then takes the
// lane's bounds and counts from the scratch and
//   4'. forms each child's max/min over its 8 corners and its terms;
//   5. adopts the first minimum of the children's ub (the first NaN if any,
//      as torch.argmin), updates opt_err, best_node, ub_terms and thr;
//   6. prunes against thr (fused) or opt_err;
//   7. merges the C - P remaining frontier entries with the 8P children by
//      a rank count (each thread one entry: the entries that sort before
//      it), keeping C and the corner payload, and folds the dropped
//      entries' finite minimum into min_dropped;
//   8. writes its lane's evals and geometric survivors; the last block to
//      finish (a ticket) adds them, per group of lanes, to the caller's
//      counters (it, evals, geom_surv, chem_corners) and counts the lanes
//      left not done, so that no torch op follows the launch.
// The tickets are the launch's own: L + 1 words behind its counters in
// o_stats, zeroed by the launcher on the launch's stream, so that launches
// on two streams, or one that was cut short, share no state.
//
// Every float step is the torch body's, one rounding each, with the
// round-to-nearest intrinsics nvcc may not contract into an FMA:
// `cxyz + off * cw`, `lb + reg * vmin * vmin` (as (reg vmin) vmin),
// `ub + (0 + ub_t)` and `(ub - ub_t) - 0` are separate roundings there.
// NaN follows torch: argmin takes the first NaN, minimum and amin/amax
// propagate it, `~(lb >= opt_err)` keeps a NaN child alive.  The merge
// orders as torch.argsort(stable=True) on the concatenated keys: NaN after
// +inf (sorted_merge = 0), or NaN ranked as +inf but keeping its value
// (sorted_merge = 1, _merge_sorted_keep's order for a sorted frontier);
// ties put the frontier's entries first, then the children in index order.
// No float is summed across threads: the bodies sum in their fixed warp
// order, and the counters are integers.
#include "chem_body.cuh"
#include "geom_body.cuh"

namespace goicp {

constexpr int kStepWarps = 8;

// the 19 lattice points of a parent that are not its own cube corners
// (search/inner.py::_ODD_LATTICE), lattice index (z * 3 + y) * 3 + x
__constant__ int kOddLattice[19] = {1,  3,  4,  5,  7,  9,  10, 11, 12, 13,
                                    14, 15, 16, 17, 19, 21, 22, 23, 25};

struct StepParams {
  GeomParams geom;           // tables, trim, norm, fused (centres local)
  ChemParams chem;           // tables; cell_compat null: no chem term
  const int* lane_pair;      // (L,) or null: every lane reads pair 0
  const float* sse;          // (W,) the search epsilon of each pair
  // the lanes' state, read
  const float* nodes;        // (L, cap, 4)
  const float* lbs;          // (L, cap)
  const float* cvals;        // (L, cap, 8) or null: no corner reuse
  const float* opt_err;      // (L,)
  const float* thr;          // (L,)
  const float* best_node;    // (L, 4)
  const float* ub_terms;     // (L, 3)
  const float* min_dropped;  // (L,)
  const unsigned char* done;   // (L,)
  const unsigned char* live;   // (L / group,) or null: every lane live
  const int* cnt_in[4];      // (L / group,) it, evals, geom_surv,
                             // chem_corners; null: 0
  // written
  float* o_nodes;
  float* o_lbs;
  float* o_cvals;
  float* o_opt_err;
  float* o_thr;
  float* o_best_node;
  float* o_ub_terms;
  float* o_min_dropped;
  unsigned char* o_done;
  int* o_stats;              // evals (L), geom_surv (L), counters
                             // (4, L / group), lanes not done (1)
  unsigned int* tickets;     // (L + 1) zeroed: the block that takes a
                             // lane's last ticket finishes that lane, the
                             // one that takes the last of [L] the counters
  float* scratch;            // (L, 3 B + Q): each lane's bounds (ub, ubu,
                             // lb of its children, compacted) and counts
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

__global__ void __launch_bounds__(kStepWarps * 32, 2)
    inner_step_kernel(StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nexp, s_surv, s_last, s_bc, s_lane_last;
  __shared__ float s_red[kStepWarps];
  __shared__ float s_scal[4];            // opt_err, thr, prune_ref, improved

  const int lane = blockIdx.x / p.blocks_per_lane;
  const int part = blockIdx.x % p.blocks_per_lane;
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

  const int grp = lane / p.group;
  const bool live = p.live == nullptr || p.live[grp] != 0;
  const bool done_in = p.done[lane] != 0;
  const float ref = fused ? p.thr[lane] : p.opt_err[lane];
  const float sse = p.sse[pair];
  const float lb0 = p.lbs[lc];
  const bool done = done_in || fabsf(lb0) == inf || __fsub_rn(ref, lb0) < sse;

  if (!live || done) {
    if (part != 0) goto counters;
    // the lane's state as it was (a done lane's done is now set)
    const int pw = p.cvals != nullptr ? 8 : 0;
    for (int i = t; i < 4 * C; i += nt) p.o_nodes[4 * lc + i] = p.nodes[4 * lc + i];
    for (int i = t; i < C; i += nt) p.o_lbs[lc + i] = p.lbs[lc + i];
    for (int i = t; i < pw * C; i += nt)
      p.o_cvals[pw * lc + i] = p.cvals[pw * lc + i];
    if (t < 4) p.o_best_node[4 * lane + t] = p.best_node[4 * lane + t];
    if (t < 3) p.o_ub_terms[3 * lane + t] = p.ub_terms[3 * lane + t];
    if (t == 0) {
      p.o_opt_err[lane] = p.opt_err[lane];
      p.o_thr[lane] = p.thr[lane];
      p.o_min_dropped[lane] = p.min_dropped[lane];
      p.o_done[lane] = live ? 1 : (done_in ? 1 : 0);
      p.o_stats[lane] = 0;
      p.o_stats[p.L + lane] = 0;
    }
  } else {
    const float opt_old = p.opt_err[lane];
    // ---- 1-2. pop, expand, children (compacted for the bounds) ----
    if (t == 0) {
      int e = 0;
      for (int q = 0; q < P; ++q) {
        const float plb = p.lbs[lc + q];
        const bool ex = fabsf(plb) != inf && !is_nan(plb) &&
                        __fsub_rn(ref, plb) >= sse;
        s_erank[q] = ex ? e++ : -1;
      }
      s_nexp = e;
      s_surv = 0;
    }
    __syncthreads();
    for (int j = t; j < B; j += nt) {
      const int q = j >> 3, c = j & 7;
      const float* par = p.nodes + 4 * (lc + q);
      const float cw = __fdiv_rn(par[3], 2.0f);
      const float half = __fdiv_rn(cw, 2.0f);
      const int e = s_erank[q];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float off = static_cast<float>((c >> a) & 1);
        const float x = __fadd_rn(par[a], __fmul_rn(off, cw));
        s_child[4 * j + a] = x;
        if (e >= 0) s_cen[3 * (8 * e + c) + a] = __fadd_rn(x, half);
      }
      s_child[4 * j + 3] = cw;
      if (e >= 0) s_wid[8 * e + c] = cw;
    }
    for (int k = t; k < Q; k += nt) {
      const int q = k / per_parent, m = k % per_parent;
      const int i = p.reuse ? kOddLattice[m] : m;
      const float* par = p.nodes + 4 * (lc + q);
      const float cw = __fdiv_rn(par[3], 2.0f);
      s_corner[3 * k + 0] =
          __fadd_rn(par[0], __fmul_rn(static_cast<float>(i % 3), cw));
      s_corner[3 * k + 1] =
          __fadd_rn(par[1], __fmul_rn(static_cast<float>((i / 3) % 3), cw));
      s_corner[3 * k + 2] =
          __fadd_rn(par[2], __fmul_rn(static_cast<float>(i / 9), cw));
    }
    __syncthreads();

    // ---- 3-4. this block's part of the bounds and the counts ----
    {
      const int K = p.blocks_per_lane;
      const int nb = 8 * s_nexp, nper = (nb + K - 1) / K;
      const int qper = (Q + K - 1) / K;
      float* g_ub = p.scratch + static_cast<size_t>(lane) * (3 * B + Q);
      float* g_ubu = g_ub + B;
      float* g_lb = g_ubu + B;
      float* g_count = g_lb + B;
      const int n0 = min(part * nper, nb), n1 = min(n0 + nper, nb);
      const int q0 = min(part * qper, Q), q1 = min(q0 + qper, Q);
      if (n1 > n0) {
        geom_bounds_body<true>(p.geom, lane, pair, body_smem, n0, n1, s_cen,
                               s_wid, g_ub, fused ? g_ubu : g_lb,
                               fused ? g_lb : nullptr);
        __syncthreads();
      }
      if (q1 > q0)
        chem_incomp_body<true>(p.chem, lane, pair, body_smem, q0, q1,
                               s_corner, g_count);
      // the last of the lane's blocks to finish goes on with the lane
      __threadfence();
      __syncthreads();
      if (t == 0)
        s_lane_last = atomicAdd(&p.tickets[lane], 1u) == K - 1;
      __syncthreads();
      if (!s_lane_last) goto counters;
      __threadfence();
      for (int i = t; i < nb; i += nt) {
        s_ub[i] = __ldcg(g_ub + i);
        s_lb[i] = __ldcg(g_lb + i);
        if (fused) s_ubu[i] = __ldcg(g_ubu + i);
      }
      for (int i = t; i < Q; i += nt) s_count[i] = __ldcg(g_count + i);
      __syncthreads();
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
            v = even ? p.cvals[8 * (lc + q) + s] : s_count[19 * q + odd];
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
    for (int r = t; r < R; r += nt) s_key[r] = p.lbs[lc + P + r];
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
        const bool improved = !(bv >= opt_old);   // NaN-infectious <
        const float opt_new = improved ? bv : opt_old;
        const float thr_new =
            fused ? min_nan(p.thr[lane], min_nan(opt_new, mu)) : p.thr[lane];
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
        p.o_lbs[o] = v;
        const float* src = e < R ? p.nodes + 4 * (lc + P + e)
                                 : s_child + 4 * (e - R);
#pragma unroll
        for (int a = 0; a < 4; ++a) p.o_nodes[4 * o + a] = src[a];
        if (pw) {
          const float* cv = e < R ? p.cvals + 8 * (lc + P + e)
                                  : s_ccv + 8 * (e - R);
#pragma unroll
          for (int a = 0; a < 8; ++a) p.o_cvals[8 * o + a] = cv[a];
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
      p.o_opt_err[lane] = s_scal[0];
      p.o_thr[lane] = s_scal[1];
      p.o_min_dropped[lane] = min_nan(p.min_dropped[lane], m);
      p.o_done[lane] = 0;
      p.o_stats[lane] = 8 * s_nexp;
      p.o_stats[p.L + lane] = s_surv;
      for (int a = 0; a < 4; ++a)
        p.o_best_node[4 * lane + a] =
            improved ? s_child[4 * bc + a] : p.best_node[4 * lane + a];
      for (int a = 0; a < 3; ++a)
        p.o_ub_terms[3 * lane + a] =
            improved ? s_term[3 * bc + a] : p.ub_terms[3 * lane + a];
    }
  }

  // ---- 8. the counters, by the last block to finish ----
counters:
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&p.tickets[p.L], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile int* stats = p.o_stats;
  const volatile unsigned char* o_done = p.o_done;
  const int groups = p.L / p.group;
  int* cnt = p.o_stats + 2 * p.L;
  for (int g = t; g < groups; g += nt) {
    const bool lv = p.live == nullptr || p.live[g] != 0;
    int ev = 0, su = 0;
    for (int l = g * p.group; l < (g + 1) * p.group; ++l) {
      ev += stats[l];
      su += stats[p.L + l];
    }
    const int add[4] = {lv ? 1 : 0, ev, su, lv ? p.group * Q : 0};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cnt[k * groups + g] = (p.cnt_in[k] != nullptr ? p.cnt_in[k][g] : 0) + add[k];
  }
  int active = 0;
  for (int l = t; l < p.L; l += nt) active += o_done[l] == 0;
  active = warp_sum(active);
  if (tid == 0) s_red[warp] = __int_as_float(active);
  __syncthreads();
  if (t == 0) {
    int n = 0;
    for (int w = 0; w < nt / 32; ++w) n += __float_as_int(s_red[w]);
    cnt[4 * groups] = n;
  }
}

}  // namespace goicp

// One launch, after zeroing its tickets (o_stats' last L + 1 words):
// blocks_per_lane blocks a lane of kStepWarps warps (fewer when the
// trimmed rows' scratch of that many warps would not fit), the step's own
// arrays first in shared memory, then the bodies' region: each body stages
// the lane's point data and the pair's tables there when they fit, as its
// standalone kernel's launcher decides.  Any pop and capacity whose arrays
// fit a block's shared memory; cudaErrorInvalidValue for shapes that do
// not.
extern "C" int goicp_inner_step(
    const float* pts, const float* rot_unc, const float* weights,
    const int* cells, const int* nearest_cell, const float* consts,
    const float* trim_count, const float* cell_compat,
    const float* prop_onehot, const float* data_mask, const int* lane_pair,
    const float* sse, const float* nodes, const float* lbs,
    const float* cvals, const float* opt_err, const float* thr,
    const float* best_node, const float* ub_terms, const float* min_dropped,
    const unsigned char* done, const unsigned char* live, const int* it_in,
    const int* evals_in, const int* surv_in, const int* corners_in,
    float* o_nodes, float* o_lbs, float* o_cvals, float* o_opt_err,
    float* o_thr, float* o_best_node, float* o_ub_terms,
    float* o_min_dropped, unsigned char* o_done, int* o_stats,
    float* scratch, int L,
    int cap, int pop, int group, int Nd, int n_cells, int size, int norm,
    int fused, int trim_k, int reuse, int sorted_merge, float reg,
    void* stream) {
  using namespace goicp;
  if (L <= 0 || pop <= 0 || cap <= pop || group <= 0 || L % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepParams p{};
  GeomParams& g = p.geom;
  g.pts = pts;
  g.rot_unc = rot_unc;
  g.weights = weights;
  g.cells = cells;
  g.nearest_cell = nearest_cell;
  g.consts = consts;
  g.trim_count = trim_count;
  g.lane_pair = lane_pair;
  g.L = L;
  g.B = 8 * pop;
  g.Nd = Nd;
  g.C = n_cells;
  g.norm = norm;
  g.fused = fused;
  g.trim_k = trim_k;
  g.n_vox = size * size * size;
  ChemParams& c = p.chem;
  c.pts = pts;
  c.cell_compat = cell_compat;
  c.prop_onehot = prop_onehot;
  c.data_mask = data_mask;
  c.nearest_cell = nearest_cell;
  c.consts = consts;
  c.lane_pair = lane_pair;
  c.L = L;
  c.Nd = Nd;
  c.C = n_cells;
  c.n_vox = g.n_vox;
  p.lane_pair = lane_pair;
  p.sse = sse;
  p.nodes = nodes;
  p.lbs = lbs;
  p.cvals = reuse ? cvals : nullptr;
  p.opt_err = opt_err;
  p.thr = thr;
  p.best_node = best_node;
  p.ub_terms = ub_terms;
  p.min_dropped = min_dropped;
  p.done = done;
  p.live = live;
  p.cnt_in[0] = it_in;
  p.cnt_in[1] = evals_in;
  p.cnt_in[2] = surv_in;
  p.cnt_in[3] = corners_in;
  p.o_nodes = o_nodes;
  p.o_lbs = o_lbs;
  p.o_cvals = o_cvals;
  p.o_opt_err = o_opt_err;
  p.o_thr = o_thr;
  p.o_best_node = o_best_node;
  p.o_ub_terms = o_ub_terms;
  p.o_min_dropped = o_min_dropped;
  p.o_done = o_done;
  p.o_stats = o_stats;
  p.tickets = reinterpret_cast<unsigned int*>(o_stats + 2 * L +
                                              4 * (L / group) + 1);
  p.scratch = scratch;
  p.L = L;
  p.cap = cap;
  p.pop = pop;
  p.group = group;
  p.reuse = reuse && cell_compat != nullptr;
  p.sorted_merge = sorted_merge;
  p.reg = reg;

  const int B = 8 * pop;
  const int Q = cell_compat != nullptr ? (reuse ? 19 : 27) * pop : 0;
  const int N = cap - pop + B;
  const size_t step_words =
      region_words(static_cast<size_t>(B) * (4 + 3 + 1 + 3 + 2 + 3 + 8) +
                   4 * static_cast<size_t>(Q) + N + pop);
  if (step_words >= kMaxDynamicSmem / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  p.step_words = static_cast<int>(step_words);
  const size_t budget = kMaxDynamicSmem / 4 - step_words;
  int warps = kStepWarps;
  while (warps > 1 && geom_rows_words(g, warps) > budget) warps >>= 1;
  const size_t rows = geom_rows_words(g, warps);
  if (rows > budget) return static_cast<int>(cudaErrorInvalidValue);
  size_t gw = rows;
  g.stage_points = gw + geom_points_words(g) <= budget;
  if (g.stage_points) gw += geom_points_words(g);
  g.stage_tables = gw + geom_tables_words(g) <= budget;
  if (g.stage_tables) gw += geom_tables_words(g);
  size_t cw = 0;
  if (cell_compat != nullptr) {
    c.stage_points = chem_points_words(c) <= budget;
    if (c.stage_points) cw += chem_points_words(c);
    c.stage_tables = cw + chem_tables_words(c) <= budget;
    if (c.stage_tables) cw += chem_tables_words(c);
  }
  const size_t words = p.step_words + (gw > cw ? gw : cw);
  static size_t granted = 0;
  const cudaError_t err = allow_smem(inner_step_kernel, 4 * words, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a lane over as many blocks as give each warp about one child (at most
  // 8, K3's spread)
  p.blocks_per_lane = (B + warps - 1) / warps;
  if (p.blocks_per_lane > 8) p.blocks_per_lane = 8;
  const cudaError_t zero = cudaMemsetAsync(
      p.tickets, 0, sizeof(unsigned int) * (L + 1),
      static_cast<cudaStream_t>(stream));
  if (zero != cudaSuccess) return static_cast<int>(zero);
  inner_step_kernel<<<L * p.blocks_per_lane, 32 * warps, 4 * words,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
