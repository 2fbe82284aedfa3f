// One lane's inner-BnB iteration (search/inner.py::_make_inner_body) in
// three stages, shared by the two kernels of inner.cu, the step
// (goicp_inner_step, one iteration a launch, a lane's blocks meeting
// through a ticket and scratch in device memory) and the run
// (goicp_inner_run, the iterations of a whole search in one launch, a
// lane's blocks a thread-block cluster meeting in distributed shared
// memory):
//   lane_head: the pop, the children and the lattice corners (steps 1-2
//     of inner.cu's header), after lane_done's check;
//   lane_bounds: one block's part of the children's bounds and the
//     corners' counts (3-4), through K1/K3's and K2/K4's bodies;
//   lane_tail: the chem terms, the adoption, the prune, the merge and the
//     lane's scalars (4'-7), by the one block that holds every part.
// One source, so that both kernels compile the same float steps and keep
// the same bits.  What an iteration computes, step by step, and its
// rounding and NaN rules are written in inner.cu's header.
//
// The lane's state is read and written through LaneIn / LaneOut at an
// index `slot`: the lane's own index in device memory (the step, and the
// run's lanes whose state does not stay in a block), or 0 in the run's
// shared memory, where a cluster keeps the lane it holds (kShared).
// Device memory is read through L2 (__ldcg): a run reads sets that other
// blocks wrote earlier in the same launch, which no stale L1 line may
// hide.
#pragma once

#include "chem_body.cuh"
#include "geom_body.cuh"

namespace goicp {

constexpr int kStepWarps = 8;

// The probe's stop points (bench/inner_stops.py): a build with
// -DGOICP_INNER_STOP=n ends every iteration after stage n (1 the done
// check and the pop, 2 the children and corners, 3 the bodies' staging
// waits, 4 the geometric body, 5 the chem body, 6 the gather, 7 the chem
// terms and the adoption, 8 the merge); a lane is then done only where
// its input says so, and the run iterates it as many times as max_iters
// (steps in mode stream) says, with no agreement between clusters.  The
// normal build defines no stop: every stage runs.
#ifndef GOICP_INNER_STOP
#define GOICP_INNER_STOP 99
#endif

// the 19 lattice points of a parent that are not its own cube corners
// (search/inner.py::_ODD_LATTICE), lattice index (z * 3 + y) * 3 + x
__constant__ int kOddLattice[19] = {1,  3,  4,  5,  7,  9,  10, 11, 12, 13,
                                    14, 15, 16, 17, 19, 21, 22, 23, 25};

// The index among kOddLattice of odd lattice point i: i less the even
// points below it (the parent's own corners, every coordinate 0 or 2:
// bits 0, 2, 6, 8, 18, 20, 24, 26).  Arithmetic, so that a warp's eight
// children do not serialize on divergent constant-memory reads.
__device__ __forceinline__ int odd_index(int i) {
  constexpr unsigned kEven = 0x5140145u;
  return i - __popc(kEven & ((1u << i) - 1u));
}

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
  int step_words;            // the step's own shared arrays (StepArrays)
  int geom_words;            // the geometric body's region behind the
                             // run's state, then the chem body's (which
                             // reads the points and the nearest-cell
                             // table from the former where it staged
                             // them)
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ float min_nan(float a, float b) {   // minimum
  return is_nan(a) || is_nan(b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// the merge's order: a before b
__device__ __forceinline__ bool key_less(float a, float b, bool nan_last) {
  return nan_last ? (a < b || (is_nan(b) && !is_nan(a))) : a < b;
}

// A key of the merge's order (NaN after +inf, as key_less with nan_last)
// as an unsigned integer of the same order: the zeros equal, every NaN
// equal and last.
__device__ __forceinline__ unsigned key_order(float v) {
  if (is_nan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// argmin's order: NaN first, then the value, then the index
__device__ __forceinline__ bool arg_before(float a, int ia, float b,
                                           int ib) {
  if (is_nan(a) || is_nan(b)) return is_nan(a) && (!is_nan(b) || ia < ib);
  return a < b || (a == b && ia < ib);
}

// a state word: shared memory as it is, device memory through L2
template <bool kShared, typename T>
__device__ __forceinline__ T ld_state(const T* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldcg(p);
}

// The step's shared arrays, in this order from the block's region, each
// found from the region's start and the shape when it is used (a struct
// of pointers would hold some forty registers across a run's loop).  The
// bounds and counts have two copies, `par` choosing one: the run's
// iterations use them in turn, so that a block may send an iteration's
// part to its peers while they still read the one before.
struct StepArrays {
  float* base;
  int P, Q, N;
  int par;
  __device__ __forceinline__ int B() const { return 8 * P; }
  // (B, 4) the children, in parent order
  __device__ __forceinline__ float* child() const { return base; }
  // (B, 3), (B,) the expanded parents' children's centres and widths,
  // compacted
  __device__ __forceinline__ float* cen() const { return base + 4 * B(); }
  __device__ __forceinline__ float* wid() const { return base + 7 * B(); }
  // (B,) each: per child
  __device__ __forceinline__ float* cub() const { return base + 8 * B(); }
  __device__ __forceinline__ float* cubu() const { return base + 9 * B(); }
  // (B, 3) the children's terms, (B, 8) their corner payload
  __device__ __forceinline__ float* term() const { return base + 10 * B(); }
  __device__ __forceinline__ float* ccv() const { return base + 13 * B(); }
  // (Q, 3) the lattice corners
  __device__ __forceinline__ float* corner() const {
    return base + 21 * B();
  }
  // (N,) the rest's keys, then the children's
  __device__ __forceinline__ float* key() const { return corner() + 3 * Q; }
  // (B,) the children's keys in the merge's order, (B,) their indices
  __device__ __forceinline__ float* skey() const { return key() + N; }
  __device__ __forceinline__ int* corder() const {
    return reinterpret_cast<int*>(skey() + B());
  }
  // (P,) an expanded parent's rank, -1 not expanded
  __device__ __forceinline__ int* erank() const { return corder() + B(); }
  // [0] expanded parents, [1] geometric survivors, [2] the adopted child,
  // [3] go (the run), [4] the cluster's next lane (the run)
  __device__ __forceinline__ int* misc() const { return erank() + P; }
  // (kStepWarps,) a warp's minimum; opt_err, thr, prune_ref, improved
  __device__ __forceinline__ float* red() const {
    return reinterpret_cast<float*>(misc() + 8);
  }
  __device__ __forceinline__ float* scal() const { return red() + kStepWarps; }
  // copy par of: (B,) each the bounds ub, ubu, lb, compacted; (Q,) the
  // corners' counts
  __device__ __forceinline__ float* ub() const {
    return scal() + 4 + par * (3 * B() + Q);
  }
  __device__ __forceinline__ float* ubu() const { return ub() + B(); }
  __device__ __forceinline__ float* lb() const { return ub() + 2 * B(); }
  __device__ __forceinline__ float* count() const { return ub() + 3 * B(); }
};

__host__ __device__ __forceinline__ size_t step_array_words(int P, int C,
                                                            int Q) {
  const size_t B = 8 * static_cast<size_t>(P);
  return B * (4 + 3 + 1 + 2 + 3 + 8 + 2) + 3 * static_cast<size_t>(Q) +
         (C - P + B) + P + 8 + kStepWarps + 4 + 2 * (3 * B + Q);
}

__device__ __forceinline__ StepArrays step_arrays(const StepParams& p,
                                                  unsigned char* smem) {
  const int P = p.pop;
  return StepArrays{reinterpret_cast<float*>(smem), P,
                    p.chem.cell_compat != nullptr ? (p.reuse ? 19 : 27) * P
                                                  : 0,
                    p.cap - P + 8 * P, 0};
}

// A lane's state copied whole from `in` to `out` (both in device memory,
// at the lane's index) with `done` as its new flag, by the calling block.
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

// Step 1's test: is the lane done (its flag, an infinite frontier minimum,
// or the reference error within sse, the pair's epsilon, of it).  A probe build
// takes the flag alone.
template <bool kShared>
__device__ __forceinline__ bool lane_done(const StepParams& p,
                                          const LaneIn& in, int slot,
                                          float sse) {
  const bool done_in = ld_state<kShared>(in.done + slot) != 0;
#if GOICP_INNER_STOP < 99
  return done_in;
#else
  const float inf = __int_as_float(0x7f800000);
  const float ref =
      ld_state<kShared>((p.geom.fused ? in.thr : in.opt_err) + slot);
  const float lb0 =
      ld_state<kShared>(in.lbs + static_cast<size_t>(slot) * p.cap);
  return done_in || fabsf(lb0) == inf || __fsub_rn(ref, lb0) < sse;
#endif
}

// Steps 1-2 of a lane that is not done: pop the P lowest-lb nodes (the
// frontier is sorted: a slice) with their `expand` mask, build the 8P
// children (a.child()), the expanded ones' centres and widths compacted
// (a.cen(), a.wid()) and the parents' lattice corners (a.corner()); a.misc()[0]
// the expanded parents, a.misc()[1] zeroed.  The whole block.
template <bool kShared>
__device__ __forceinline__ void lane_head(const StepParams& p,
                                          const LaneIn& in, int slot,
                                          float sse, const StepArrays& a) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int P = p.pop, B = 8 * P;
  const bool chem = p.chem.cell_compat != nullptr;
  const int per_parent = chem ? (p.reuse ? 19 : 27) : 0;
  const int Q = per_parent * P;
  const float inf = __int_as_float(0x7f800000);
  const size_t lc = static_cast<size_t>(slot) * p.cap;
  if (t == 0) {
    const float ref =
        ld_state<kShared>((p.geom.fused ? in.thr : in.opt_err) + slot);
    int e = 0;
    for (int q = 0; q < P; ++q) {
      const float plb = ld_state<kShared>(in.lbs + lc + q);
      const bool ex_ = fabsf(plb) != inf && !is_nan(plb) &&
                       __fsub_rn(ref, plb) >= sse;
      a.erank()[q] = ex_ ? e++ : -1;
    }
    a.misc()[0] = e;
    a.misc()[1] = 0;
  }
  __syncthreads();
#if GOICP_INNER_STOP < 2
  return;
#endif
  for (int j = t; j < B; j += nt) {
    const int q = j >> 3, c = j & 7;
    const float* par = in.nodes + 4 * (lc + q);
    const float cw = __fdiv_rn(ld_state<kShared>(par + 3), 2.0f);
    const float half = __fdiv_rn(cw, 2.0f);
    const int e = a.erank()[q];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float off = static_cast<float>((c >> d) & 1);
      const float x =
          __fadd_rn(ld_state<kShared>(par + d), __fmul_rn(off, cw));
      a.child()[4 * j + d] = x;
      if (e >= 0) a.cen()[3 * (8 * e + c) + d] = __fadd_rn(x, half);
    }
    a.child()[4 * j + 3] = cw;
    if (e >= 0) a.wid()[8 * e + c] = cw;
  }
  for (int k = t; k < Q; k += nt) {
    const int q = k / per_parent, m = k % per_parent;
    const int i = p.reuse ? kOddLattice[m] : m;
    const float* par = in.nodes + 4 * (lc + q);
    const float cw = __fdiv_rn(ld_state<kShared>(par + 3), 2.0f);
    a.corner()[3 * k + 0] = __fadd_rn(
        ld_state<kShared>(par), __fmul_rn(static_cast<float>(i % 3), cw));
    a.corner()[3 * k + 1] =
        __fadd_rn(ld_state<kShared>(par + 1),
                  __fmul_rn(static_cast<float>((i / 3) % 3), cw));
    a.corner()[3 * k + 2] = __fadd_rn(
        ld_state<kShared>(par + 2), __fmul_rn(static_cast<float>(i / 9), cw));
  }
  __syncthreads();
}

// The children [n0, n1) (of the 8 nexp expanded ones) and the corners
// [q0, q1) that block `part` of a lane's blocks_per_lane evaluates.
struct Parts {
  int n0, n1, q0, q1;
};

__device__ __forceinline__ Parts parts(const StepParams& p, int part,
                                       int nexp) {
  const int K = p.blocks_per_lane;
  const int Q = p.chem.cell_compat != nullptr
                    ? (p.reuse ? 19 : 27) * p.pop : 0;
  const int nb = 8 * nexp, nper = (nb + K - 1) / K;
  const int qper = (Q + K - 1) / K;
  const int n0 = min(part * nper, nb), q0 = min(part * qper, Q);
  return Parts{n0, min(n0 + nper, nb), q0, min(q0 + qper, Q)};
}

// Steps 3-4, this block's part of the bounds of the 8 nexp expanded
// children (centres cen, widths wid) and of the counts at the Q corners:
// into o_ub, o_ubu, o_lb (node index) and o_count (corner index), wherever
// they lie (device memory, shared memory, a cluster peer's shared
// memory).  The whole block.
__device__ __forceinline__ void lane_bounds(
    const StepParams& p, int lane, int pair, int part, int nexp,
    const GeomSrc& gs, const ChemSrc& cs, const float* cen,
    const float* wid, const float* corner, float* o_ub, float* o_ubu,
    float* o_lb, float* o_count) {
  const bool fused = p.geom.fused;
  const Parts r = parts(p, part, nexp);
  if (r.n1 > r.n0)
    geom_bounds_body<true>(p.geom, lane, pair, gs, r.n0, r.n1, cen, wid,
                           o_ub, fused ? o_ubu : o_lb,
                           fused ? o_lb : nullptr);
  if (r.q1 > r.q0)
    chem_incomp_body<true>(p.chem, lane, pair, cs, r.q0, r.q1, corner,
                           o_count);
}

// The count of the first n entries of arr (sorted in the merge's order
// under key) that come before x.
template <typename Key>
__device__ __forceinline__ int count_before(const float* arr, int n, float x,
                                            bool nan_last, Key key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(key(arr[mid]), x, nan_last))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// and of those that do not come after it
template <typename Key>
__device__ __forceinline__ int count_not_after(const float* arr, int n,
                                               float x, bool nan_last,
                                               Key key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!key_less(x, key(arr[mid]), nan_last))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Steps 4'-7 of the lane in `in` into `out` (slot: the lane's index in
// both; in and out may share the scalars, not the frontier) by the block
// that ran lane_head and whose a.ub(), a.ubu(), a.lb() hold every child's
// bounds and a.count() every corner's count: each child's chem terms over
// its 8 corners and its corner payload, the adoption, the threshold, the
// prune, the merge and the lane's scalars; a.misc()[1] the geometric
// survivors.  The whole block.
template <bool kShared>
__device__ __forceinline__ void lane_tail(const StepParams& p,
                                          const LaneIn& in,
                                          const LaneOut& out, int slot,
                                          const StepArrays& a) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, tid = t & 31;
  const int P = p.pop, B = 8 * P, C = p.cap, R = C - P, N = R + B;
  const bool chem = p.chem.cell_compat != nullptr;
  const bool fused = p.geom.fused;
  const float inf = __int_as_float(0x7f800000);
  const size_t lc = static_cast<size_t>(slot) * C;
  const float opt_old = ld_state<kShared>(in.opt_err + slot);

  // per child: the masked bounds, the chem terms, its corner payload
  int surv = 0;
  for (int j = t; j < B; j += nt) {
    const int q = j >> 3, c = j & 7, e = a.erank()[q];
    const bool valid = e >= 0;
    const int k = 8 * e + c;
    float ub = valid ? a.ub()[k] : inf;
    float lb = valid ? a.lb()[k] : inf;
    float ubu = fused && valid ? a.ubu()[k] : inf;
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
          v = even ? ld_state<kShared>(in.cvals + 8 * (lc + q) + s)
                   : a.count()[19 * q + odd_index(i)];
          a.ccv()[8 * j + m] = v;
        } else {
          v = a.count()[27 * q + i];
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
    a.cub()[j] = ub;
    a.cubu()[j] = ubu;
    a.key()[R + j] = lb;        // pruned below
    a.term()[3 * j + 0] = t0;
    a.term()[3 * j + 1] = t1;
    a.term()[3 * j + 2] = 0.0f;
  }
  if (surv) atomicAdd(&a.misc()[1], surv);
  for (int r = t; r < R; r += nt)
    a.key()[r] = ld_state<kShared>(in.lbs + lc + P + r);
  __syncthreads();

  // ---- 5-6. adopt the best child, the threshold, the prune ----
  if (warp == 0) {
    float bv = inf, mu = inf;
    int bi = 0x7fffffff;
    for (int j = tid; j < B; j += 32) {
      const float v = a.cub()[j];
      if (arg_before(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
      mu = min_nan(mu, a.cubu()[j]);
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
      const float thr_old = ld_state<kShared>(in.thr + slot);
      const bool improved = !(bv >= opt_old);   // NaN-infectious <
      const float opt_new = improved ? bv : opt_old;
      const float thr_new =
          fused ? min_nan(thr_old, min_nan(opt_new, mu)) : thr_old;
      a.scal()[0] = opt_new;
      a.scal()[1] = thr_new;
      a.scal()[2] = fused ? thr_new : opt_new;
      a.scal()[3] = improved ? 1.0f : 0.0f;
      a.misc()[2] = bi;
    }
  }
  __syncthreads();
  const float prune_ref = a.scal()[2];
  for (int j = t; j < B; j += nt)
    if (a.key()[R + j] >= prune_ref) a.key()[R + j] = inf;
  __syncthreads();
#if GOICP_INNER_STOP < 8
  return;
#endif

  // ---- 7. the merge: each entry's rank among the R + B keys ----
  // The rest of the frontier is in the merge's order (the precondition:
  // every frontier is a merge's output or a root): the children are
  // ranked among themselves (a count over B), and each entry's rank in the
  // other list is a binary search (ties: the frontier first, the children
  // in index order).
  const bool nan_last = !p.sorted_merge;
  auto key = [nan_last, inf](float v) {
    return nan_last || !is_nan(v) ? v : inf;
  };
  const int pw = p.reuse ? 8 : 0;
  float drop_min = inf;
  // entry e (the rest's below R, child e - R above) at output rank `rank`
  auto emit = [&](int e, int rank) {
    const float v = a.key()[e];
    if (rank < C) {
      const size_t o = lc + rank;
      out.lbs[o] = v;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        out.nodes[4 * o + d] =
            e < R ? ld_state<kShared>(in.nodes + 4 * (lc + P + e) + d)
                  : a.child()[4 * (e - R) + d];
      if (pw) {
#pragma unroll
        for (int d = 0; d < 8; ++d)
          out.cvals[8 * o + d] =
              e < R ? ld_state<kShared>(in.cvals + 8 * (lc + P + e) + d)
                    : a.ccv()[8 * (e - R) + d];
      }
    } else if (fabsf(v) != inf && !is_nan(v)) {
      drop_min = fminf(drop_min, v);
    }
  };
  // the children's order among themselves (key, then index): each key as
  // an integer of the merge's order (in a.cub, free since the adoption),
  // then a count a child, into a.skey and a.corder
  unsigned* ord = reinterpret_cast<unsigned*>(a.cub());
  for (int j = t; j < B; j += nt) ord[j] = key_order(key(a.key()[R + j]));
  __syncthreads();
  for (int j = t; j < B; j += nt) {
    const unsigned oj = ord[j];
    int m = 0;
    for (int f = 0; f < B; ++f) {
      const unsigned of = ord[f];
      m += (of < oj) | ((of == oj) & (f < j));
    }
    a.skey()[m] = key(a.key()[R + j]);
    a.corder()[m] = j;
  }
  __syncthreads();
  for (int e = t; e < N; e += nt) {
    if (e < R) {
      emit(e, e + count_before(a.skey(), B, key(a.key()[e]), nan_last,
                               [](float v) { return v; }));
    } else {
      const int m = e - R;
      emit(R + a.corder()[m],
           m + count_not_after(a.key(), R, a.skey()[m], nan_last, key));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    drop_min = fminf(drop_min, __shfl_xor_sync(0xffffffffu, drop_min, off));
  if (tid == 0) a.red()[warp] = drop_min;
  __syncthreads();

  // ---- the lane's scalars ----
  if (t == 0) {
    float m = inf;
    for (int w = 0; w < nt / 32; ++w) m = fminf(m, a.red()[w]);
    const bool improved = a.scal()[3] != 0.0f;
    const int bc = a.misc()[2];
    out.opt_err[slot] = a.scal()[0];
    out.thr[slot] = a.scal()[1];
    out.min_dropped[slot] =
        min_nan(ld_state<kShared>(in.min_dropped + slot), m);
    out.done[slot] = 0;
    for (int d = 0; d < 4; ++d)
      out.best_node[4 * slot + d] =
          improved ? a.child()[4 * bc + d]
                   : ld_state<kShared>(in.best_node + 4 * slot + d);
    for (int d = 0; d < 3; ++d)
      out.ub_terms[3 * slot + d] =
          improved ? a.term()[3 * bc + d]
                   : ld_state<kShared>(in.ub_terms + 3 * slot + d);
  }
  // the block's shared arrays are free again once every thread is here
  __syncthreads();
}

}  // namespace goicp
