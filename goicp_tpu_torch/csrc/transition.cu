// The outer-step transition of every engine that pops rotation cubes, for
// a batch of rows in a few launches (goicp_tpu_torch/search/transition.py
// binds it; harvest_plain / advance_plain there are the same functions in
// torch ops).  The JAX package leaves this work to XLA around its inner
// search: goicp_tpu/search/fused_stream.py::_harvest (:131) and _advance
// (:177), vmapped over the window, and the head and tail of
// goicp_tpu/search/device_engine.py::_make_body (:259-412).  It replaces
// no Pallas kernel; the port ran it as ~60 torch ops a row (the pop) plus
// the harvest, the adoption and the frontier merge, row by row.
//
// goicp_harvest, one block a row: each lane's lower bound lb_safe (the
// minimum of thr or the lb pass's opt_err and min_dropped, and of the
// lane's translation frontier where its search did not finish; or given),
// ubs = active ? opt_err : inf, the first argmin lane (NaN first, as
// torch.argmin), the candidate's ub, R, t = tn[:3] + tn[3] / 2 and terms,
// the incumbent min(opt_err, cand_ub) and improved = !(cand_ub >= opt_err)
// (NaN-infectious), beside a copy of the row's converged flag: the one
// host read of a transition reads those two flags.
//
// goicp_advance, in three modes:
//   pop    (register_device, the batch engine, the sharded engine's pop):
//          the convergence test on the frontier's first lb (or a given
//          per-row min_lb), final_lb, the rot_batch parents' expand flags,
//          their 8 children each, the pi-ball test, rodrigues, the data
//          rotated by every lane's R, the rotation uncertainty, the root
//          corners' incompatibility counts (corner reuse) and the fresh
//          inner state of every lane;
//   adopt  (register_device's tail): the ICP-over-BnB-over-old picks of
//          the incumbent, pruning the children against it, the stable
//          merge of the frontier's rest with the children, min_dropped,
//          pruning the kept entries, the counters, the freeze of a
//          converged row;
//   both   (the streams' _advance): adopt on the whole frontier, then pop
//          the next parents from the merged one; the rest is shifted up
//          and padded with inf lbs and zero nodes.
// A block serves one row: the frontier (2,048 nodes x 5 floats at the
// default capacity, 40 KB) is staged in shared memory first, so a row may
// be written over itself (the streams write their window state in place).
// The merge is a merge path: each child is ranked among the children
// (ties by index), each frontier entry placed after the children below it,
// and each child after the entries at or below it (binary searches):
// exactly torch.argsort(stable=True)'s order of the concatenation, given
// the precondition that the rest of the frontier is sorted ascending and
// holds no NaN.  Every engine keeps it so: the frontier starts as the root
// and inf, the merge writes it in order, and no NaN enters it (a NaN lb
// fails `lb < opt_err` and goes in as inf; the kept entries are pruned to
// inf, never to NaN).  A state that breaks it is merged in another order
// than the torch code's, which the bit-for-bit checks against the CPU
// show.  The per-lane
// work (the rotated data, the uncertainty, the root corners through K2's
// body, chem_body.cuh, and the fresh lanes) runs in a second launch, a
// block a (row, lane).  So a transition batch is three launches, whatever
// its number of rows: harvest, then advance's two.
//
// Every float step is the torch code's, one rounding each, with the
// round-to-nearest intrinsics nvcc may not contract: cxyz + off * cw,
// (sqrt(3) * w) / 2, 2 * sin(a / 2) * |p|, rodrigues (rot_body.cuh), the
// rotated points (rot_body.cuh's rotate_point, rotate's warp order),
// root + off * transWidth.  Python's sqrt(3) and pi meet float32 tensors
// as float32 (torch casts a scalar to the tensor's type), so they are the
// float32 constants below.  No float is summed across threads and there
// is no float atomic; the only cross-thread reductions are minima.
//
// What bounds it on the H100: latency.  A batch moves ~50 KB a row (the
// frontier read and written once) plus the fresh lanes (L x C x 13
// floats) and the rotated points; the launches, and the dependent steps
// of one block, are the cost.
#include "chem_body.cuh"
#include "rot_body.cuh"

namespace goicp {

constexpr int kMaxRows = 256;      // rows a launch carries in its parameters
constexpr int kThreads = 256;
constexpr float kSqrt3f = 1.7320508075688772f;   // float32(sqrt(3))
constexpr float kPif = 3.141592653589793f;       // float32(pi)

enum Mode { kBoth = 0, kPop = 1, kAdopt = 2 };

__device__ __forceinline__ bool nan_(float v) { return v != v; }

__device__ __forceinline__ float inf_() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool finite_(float v) {
  return !nan_(v) && fabsf(v) != inf_();
}

// torch.minimum / amin: NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return nan_(a) || nan_(b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// argmin's order: NaN first, then the value, then the index
__device__ __forceinline__ bool arg_before(float a, int ia, float b,
                                           int ib) {
  if (nan_(a) || nan_(b)) return nan_(a) && (!nan_(b) || ia < ib);
  return a < b || (a == b && ia < ib);
}

// ---------------------------------------------------------------------------
// harvest
// ---------------------------------------------------------------------------

enum HarvestSlot {
  kHLbs, kHRef, kHMinDrop, kHDone, kHLbIn, kHUbErr, kHBestNode, kHUbTerms,
  kHActive, kHRLanes, kHOptErr, kHConv, kHOLbSafe, kHOUbs, kHOCandUb,
  kHOIncumbent, kHOCandR, kHOCandT, kHOCandTerms, kHOFlags, kHSlots
};

struct HarvestParams {
  const void* p[kHSlots];
  int L, C;
  int rows[kMaxRows];
};

template <typename T>
__device__ __forceinline__ const T* in_(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
__device__ __forceinline__ T* out_(const void* p) {
  return static_cast<T*>(const_cast<void*>(p));
}

__global__ void __launch_bounds__(kThreads) harvest_kernel(HarvestParams hp) {
  extern __shared__ float s_ubs[];   // (L,)
  const int i = blockIdx.x, w = hp.rows[i];
  const int L = hp.L, C = hp.C;
  const int t = threadIdx.x, warp = t >> 5, tid = t & 31;
  const size_t wl = static_cast<size_t>(w) * L;
  const float inf = inf_();
  const void* const* p = hp.p;

  for (int l = warp; l < L; l += kThreads / 32) {
    float lb;
    if (p[kHLbIn] != nullptr) {
      lb = in_<float>(p[kHLbIn])[wl + l];
    } else {
      // rem_min = amin(lbs): NaN-propagating, over the lane's C entries
      const float* row = in_<float>(p[kHLbs]) + (wl + l) * C;
      float m = inf;
      for (int c = tid; c < C; c += 32) m = min_nan(m, row[c]);
      for (int off = 16; off > 0; off >>= 1)
        m = min_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
      lb = min_nan(in_<float>(p[kHRef])[wl + l],
                   in_<float>(p[kHMinDrop])[wl + l]);
      if (!in_<unsigned char>(p[kHDone])[wl + l]) lb = min_nan(lb, m);
    }
    if (tid == 0) {
      const float u =
          in_<unsigned char>(p[kHActive])[wl + l] ? in_<float>(p[kHUbErr])[wl + l]
                                                  : inf;
      out_<float>(p[kHOLbSafe])[static_cast<size_t>(i) * L + l] = lb;
      out_<float>(p[kHOUbs])[static_cast<size_t>(i) * L + l] = u;
      s_ubs[l] = u;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  float bv = inf;
  int bi = 0x7fffffff;
  for (int l = tid; l < L; l += 32)
    if (arg_before(s_ubs[l], l, bv, bi)) {
      bv = s_ubs[l];
      bi = l;
    }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (arg_before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (tid != 0) return;
  const size_t lane = wl + bi;
  const float opt = in_<float>(p[kHOptErr])[w];
  const float* tn = in_<float>(p[kHBestNode]) + 4 * lane;
  const float* R = in_<float>(p[kHRLanes]) + 9 * lane;
  const float* terms = in_<float>(p[kHUbTerms]) + 3 * lane;
  out_<float>(p[kHOCandUb])[i] = bv;
  out_<float>(p[kHOIncumbent])[i] = min_nan(opt, bv);
  for (int k = 0; k < 9; ++k) out_<float>(p[kHOCandR])[9 * i + k] = R[k];
  const float half = __fdiv_rn(tn[3], 2.0f);
  for (int a = 0; a < 3; ++a) {
    out_<float>(p[kHOCandT])[3 * i + a] = __fadd_rn(tn[a], half);
    out_<float>(p[kHOCandTerms])[3 * i + a] = terms[a];
  }
  unsigned char* flags = out_<unsigned char>(p[kHOFlags]) + 2 * i;
  flags[0] = !(bv >= opt);   // NaN-infectious <
  flags[1] = p[kHConv] != nullptr ? in_<unsigned char>(p[kHConv])[w] : 0;
}

// ---------------------------------------------------------------------------
// advance
// ---------------------------------------------------------------------------

enum AdvanceSlot {
  // the state's rows (W of them), read at in_row
  kFrNodes, kFrLbs, kOptErr, kOptR, kOptT, kComp, kTerms, kLastIcp,
  kMinDropped, kIt, kEvals, kInnerIt, kIcpRuns, kGeomSurv, kChemCorners,
  kConverged, kFinalLb,
  // the pop context at in_row: the children (both, adopt), the pop's own
  // converged and final_lb (adopt)
  kActive, kChildNodes, kPConv, kPFinal,
  // the inner search's work at in_row, or null: the scalar ints
  kWEvals, kWIt, kWSurv, kWCorners,
  // harvest's outputs (n rows)
  kLbSafe, kCandUb, kIncumbent, kCandR, kCandT, kCandTerms, kFlags,
  // the refine block's (n rows), or null: no row refined
  kIcpR, kIcpT, kIcpErr, kIcpTerms, kIcpIncomp, kBnbComp, kDoIcp,
  kMinLb,   // (n,) or null: the frontier's own first lb
  // the pairs (W rows) and K2's tables (cell_compat null: no root corners)
  kData, kNormData, kSse, kCellCompat, kPropOnehot, kDataMask, kNearestCell,
  kConsts,
  // written at out_row
  kOFrNodes, kOFrLbs, kOOptErr, kOOptR, kOOptT, kOComp, kOTerms, kOLastIcp,
  kOMinDropped, kOIt, kOEvals, kOInnerIt, kOIcpRuns, kOGeomSurv,
  kOChemCorners, kOConverged, kOFinalLb,
  kOPopLb, kOExpand, kOChildNodes, kOWidths, kOActive, kORLanes,
  kOPts, kOMrd, kONodes, kOLbs, kOIOpt, kOIThr, kOBestNode, kOUbTerms,
  kOIMinDropped, kODone, kOCvals, kOIIt, kOIEvals, kOISurv, kOICorners,
  kASlots
};

enum AdvanceInt {
  kMode, kN, kLanes, kCr, kPr, kCap, kNd, kNCells, kSize, kIcpOnImprove,
  kSEvals, kSIt, kSSurv, kSCorners, kAInts
};

struct AdvanceParams {
  const void* p[kASlots];
  int mode, L, Cr, Pr, C, Nd, icp_on_improve;
  int s_work[4];        // evals, it, geom_surv, chem_corners when null
  float root[4];        // the translation root: x, y, z, width
  ChemParams chem;      // pts set per block; cell_compat null: no corners
  int rows[kMaxRows];
  int out_rows[kMaxRows];
};

template <typename T>
__device__ __forceinline__ T get_(const void* p, size_t i, T fallback) {
  return p != nullptr ? static_cast<const T*>(p)[i] : fallback;
}

// One block a row: adopt (adopt, both), merge, then pop (pop, both).
__global__ void __launch_bounds__(kThreads) advance_row_kernel(
    AdvanceParams ap) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_f[8];        // opt_new, min_drop, min_lb, final_lb
  __shared__ int s_b[4];          // improved, icp_improved, frozen, conv
  __shared__ float s_red[kThreads / 32];

  const void* const* p = ap.p;
  const int i = blockIdx.x, w = ap.rows[i], o = ap.out_rows[i];
  const int L = ap.L, Cr = ap.Cr, Pr = ap.Pr, mode = ap.mode;
  const int t = threadIdx.x, warp = t >> 5, tid = t & 31;
  const float inf = inf_();
  const bool adopts = mode != kPop;
  // the frontier's rest merged with the children: all of it (both) or
  // what the pop left (adopt)
  const int r0 = mode == kAdopt ? Pr : 0, R = Cr - r0;
  const size_t wc = static_cast<size_t>(w) * Cr, oc = static_cast<size_t>(o) * Cr;
  const size_t wl = static_cast<size_t>(w) * L, ol = static_cast<size_t>(o) * L;

  float* s_fl = sm;                       // (Cr,) the old frontier's lbs
  float* s_fn = s_fl + Cr;                // (Cr, 4) and nodes
  float* s_ck = s_fn + 4 * Cr;            // (L,) the children's keys
  float* s_cs = s_ck + L;                 // (L,) the keys sorted
  float* s_cn = s_cs + L;                 // (L, 4) the children's nodes
  int* s_cr = reinterpret_cast<int*>(s_cn + 4 * L);   // (L,) their ranks
  float* s_par = mode == kPop ? sm     // (Pr, 5) the parents: lb, node
                               : reinterpret_cast<float*>(s_cr + L);

  if (adopts) {
    // ---- adopt: the scalars ----
    if (t == 0) {
      const unsigned char* flags = in_<unsigned char>(p[kFlags]);
      const bool improved = flags[2 * i] != 0;
      const bool do_icp = get_<unsigned char>(p[kDoIcp], i, 0) != 0;
      const float icp_err = do_icp ? in_<float>(p[kIcpErr])[i] : inf;
      const bool icp_improved =
          do_icp && !(icp_err >= in_<float>(p[kIncumbent])[i]);
      const float opt_old = in_<float>(p[kOptErr])[w];
      s_f[0] = icp_improved ? icp_err
                            : (improved ? in_<float>(p[kCandUb])[i] : opt_old);
      s_b[0] = improved;
      s_b[1] = icp_improved;
      s_b[2] = mode == kAdopt && (in_<unsigned char>(p[kConverged])[w] ||
                                  in_<unsigned char>(p[kPConv])[w]);
    }
    // ---- stage the old frontier and the children ----
    for (int e = t; e < Cr; e += kThreads) {
      s_fl[e] = in_<float>(p[kFrLbs])[wc + e];
      for (int a = 0; a < 4; ++a)
        s_fn[4 * e + a] = in_<float>(p[kFrNodes])[4 * (wc + e) + a];
    }
    for (int j = t; j < L; j += kThreads)
      for (int a = 0; a < 4; ++a)
        s_cn[4 * j + a] = in_<float>(p[kChildNodes])[4 * (wl + j) + a];
    __syncthreads();
    const float opt_new = s_f[0];
    for (int j = t; j < L; j += kThreads) {
      const float lb = in_<float>(p[kLbSafe])[static_cast<size_t>(i) * L + j];
      s_ck[j] = in_<unsigned char>(p[kActive])[wl + j] && lb < opt_new ? lb
                                                                        : inf;
    }
    __syncthreads();
    // each child's rank among the children: smaller keys, then ties by
    // index
    for (int j = t; j < L; j += kThreads) {
      const float k = s_ck[j];
      int rank = 0;
      for (int m = 0; m < L; ++m)
        rank += s_ck[m] < k || (m < j && s_ck[m] == k);
      s_cr[j] = rank;
      s_cs[rank] = k;
    }
    __syncthreads();

    // ---- the merge: each entry's place; the kept ones written ----
    // both: position q < Pr is parent q, position q < Cr goes to q - Pr;
    // adopt: position q < Cr goes to q (frozen: the old frontier instead).
    const bool frozen = s_b[2] != 0;
    float drop = inf;
    for (int e = t; e < R + L; e += kThreads) {
      const float v = e < R ? s_fl[r0 + e] : s_ck[e - R];
      const float* node = e < R ? s_fn + 4 * (r0 + e) : s_cn + 4 * (e - R);
      int pos;
      if (e < R) {
        int lo = 0, hi = L;      // children with a key < v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_cs[mid] < v) lo = mid + 1; else hi = mid;
        }
        pos = e + lo;
      } else {
        const int j = e - R;
        int lo = 0, hi = R;      // rest entries with a value <= v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_fl[r0 + mid] <= v) lo = mid + 1; else hi = mid;
        }
        pos = s_cr[j] + lo;
      }
      if (pos >= Cr) {
        if (finite_(v)) drop = fminf(drop, v);
        continue;
      }
      const float kept = v >= opt_new ? inf : v;   // prune vs the incumbent
      if (mode == kBoth && pos < Pr) {
        s_par[5 * pos] = kept;
        for (int a = 0; a < 4; ++a) s_par[5 * pos + 1 + a] = node[a];
        continue;
      }
      if (frozen) continue;
      const int q = mode == kBoth ? pos - Pr : pos;
      out_<float>(p[kOFrLbs])[oc + q] = kept;
      for (int a = 0; a < 4; ++a)
        out_<float>(p[kOFrNodes])[4 * (oc + q) + a] = node[a];
    }
    for (int off = 16; off > 0; off >>= 1)
      drop = fminf(drop, __shfl_xor_sync(0xffffffffu, drop, off));
    if (tid == 0) s_red[warp] = drop;
    if (frozen)   // a frozen row keeps its whole old frontier
      for (int e = t; e < Cr; e += kThreads) {
        out_<float>(p[kOFrLbs])[oc + e] = s_fl[e];
        for (int a = 0; a < 4; ++a)
          out_<float>(p[kOFrNodes])[4 * (oc + e) + a] = s_fn[4 * e + a];
      }
    if (mode == kBoth)   // the rest shifted up: inf lbs, zero nodes behind
      for (int e = Cr - Pr + t; e < Cr; e += kThreads) {
        out_<float>(p[kOFrLbs])[oc + e] = inf;
        for (int a = 0; a < 4; ++a)
          out_<float>(p[kOFrNodes])[4 * (oc + e) + a] = 0.0f;
      }
    __syncthreads();

    // ---- the row's adopted values and counters ----
    if (t == 0) {
      float md = inf;
      for (int k = 0; k < kThreads / 32; ++k) md = fminf(md, s_red[k]);
      const bool improved = s_b[0] != 0, icp_improved = s_b[1] != 0;
      const bool do_icp = get_<unsigned char>(p[kDoIcp], i, 0) != 0;
      const bool keep_old = frozen;
      const float md_old = in_<float>(p[kMinDropped])[w];
      out_<float>(p[kOOptErr])[o] = keep_old ? in_<float>(p[kOptErr])[w] : opt_new;
      out_<float>(p[kOMinDropped])[o] = keep_old ? md_old : min_nan(md_old, md);
      // the refine block's values; a row that did not refine takes the
      // dummies (identity, 0, inf, 0, 0, 0), which no pick selects
      for (int k = 0; k < 9; ++k) {
        const float icp_v =
            do_icp ? in_<float>(p[kIcpR])[9 * i + k] : (k % 4 == 0 ? 1.0f : 0.0f);
        const float v = icp_improved ? icp_v
                        : improved   ? in_<float>(p[kCandR])[9 * i + k]
                                     : in_<float>(p[kOptR])[9 * w + k];
        out_<float>(p[kOOptR])[9 * o + k] =
            keep_old ? in_<float>(p[kOptR])[9 * w + k] : v;
      }
      for (int a = 0; a < 3; ++a) {
        const float it_v = do_icp ? in_<float>(p[kIcpT])[3 * i + a] : 0.0f;
        const float tv = icp_improved ? it_v
                         : improved   ? in_<float>(p[kCandT])[3 * i + a]
                                      : in_<float>(p[kOptT])[3 * w + a];
        out_<float>(p[kOOptT])[3 * o + a] =
            keep_old ? in_<float>(p[kOptT])[3 * w + a] : tv;
        const float im_v = do_icp ? in_<float>(p[kIcpTerms])[3 * i + a] : 0.0f;
        const float mv = icp_improved ? im_v
                         : improved   ? in_<float>(p[kCandTerms])[3 * i + a]
                                      : in_<float>(p[kTerms])[3 * w + a];
        out_<float>(p[kOTerms])[3 * o + a] =
            keep_old ? in_<float>(p[kTerms])[3 * w + a] : mv;
      }
      const int comp_old = in_<int>(p[kComp])[w];
      const int comp = icp_improved ? (do_icp ? in_<int>(p[kIcpIncomp])[i] : 0)
                       : improved   ? (do_icp ? in_<int>(p[kBnbComp])[i] : 0)
                                    : comp_old;
      out_<int>(p[kOComp])[o] = keep_old ? comp_old : comp;
      const bool li_old = in_<unsigned char>(p[kLastIcp])[w] != 0;
      const bool li = icp_improved || (!improved && li_old);
      out_<unsigned char>(p[kOLastIcp])[o] = keep_old ? li_old : li;
      // the counters: + the inner search's work (none when frozen)
      const int z = frozen ? 0 : 1;
      const int adds[4] = {
          get_<int>(p[kWEvals], w, ap.s_work[0]),
          get_<int>(p[kWIt], w, ap.s_work[1]),
          get_<int>(p[kWSurv], w, ap.s_work[2]),
          get_<int>(p[kWCorners], w, ap.s_work[3])};
      const int slots[4][2] = {{kEvals, kOEvals}, {kInnerIt, kOInnerIt},
                               {kGeomSurv, kOGeomSurv},
                               {kChemCorners, kOChemCorners}};
      for (int k = 0; k < 4; ++k)
        out_<int>(p[slots[k][1]])[o] = in_<int>(p[slots[k][0]])[w] + z * adds[k];
      out_<int>(p[kOIcpRuns])[o] =
          in_<int>(p[kIcpRuns])[w] + z * (ap.icp_on_improve ? improved : 1);
      if (p[kIt] != nullptr && p[kOIt] != nullptr)
        out_<int>(p[kOIt])[o] = in_<int>(p[kIt])[w] + 1;
      if (mode == kAdopt) {
        out_<unsigned char>(p[kOConverged])[o] = frozen;
        out_<float>(p[kOFinalLb])[o] = in_<float>(p[kPFinal])[w];
      }
    }
    if (mode == kAdopt) return;
    __syncthreads();
  } else {
    for (int e = t; e < 5 * Pr; e += kThreads) {
      const int q = e / 5, a = e % 5;
      s_par[e] = a == 0 ? in_<float>(p[kFrLbs])[wc + q]
                        : in_<float>(p[kFrNodes])[4 * (wc + q) + a - 1];
    }
    __syncthreads();
  }

  // ---- the pop: convergence, final_lb, the parents' expand flags ----
  const float opt = mode == kBoth ? s_f[0] : in_<float>(p[kOptErr])[w];
  const float sse = in_<float>(p[kSse])[w];
  if (t == 0) {
    const float min_lb = get_<float>(p[kMinLb], i, s_par[0]);
    const bool conv = fabsf(min_lb) == inf || __fsub_rn(opt, min_lb) <= sse ||
                      nan_(opt);
    const bool conv_old = in_<unsigned char>(p[kConverged])[w] != 0;
    const float final_lb =
        conv && !conv_old ? min_lb : in_<float>(p[kFinalLb])[w];
    s_b[3] = conv;
    out_<unsigned char>(p[kOConverged])[o] = mode == kBoth ? (conv_old || conv)
                                                           : conv;
    out_<float>(p[kOFinalLb])[o] = final_lb;
    if (mode == kBoth) {   // the new inner search's counters
      out_<int>(p[kOIIt])[o] = 0;
      out_<int>(p[kOIEvals])[o] = 0;
      out_<int>(p[kOISurv])[o] = 0;
      out_<int>(p[kOICorners])[o] = 0;
    }
  }
  __syncthreads();
  const bool conv = s_b[3] != 0;
  for (int q = t; q < Pr; q += kThreads) {
    const float lb = s_par[5 * q];
    const bool ex = finite_(lb) && __fsub_rn(opt, lb) > sse && !conv;
    if (p[kOPopLb] != nullptr) {
      out_<float>(p[kOPopLb])[static_cast<size_t>(o) * Pr + q] = lb;
      out_<unsigned char>(p[kOExpand])[static_cast<size_t>(o) * Pr + q] = ex;
    }
  }

  // ---- the children: nodes, widths, the pi-ball, rodrigues ----
  for (int l = t; l < L; l += kThreads) {
    const int q = l >> 3, c = l & 7;
    const float* par = s_par + 5 * q;
    const float lb = par[0];
    const bool ex = finite_(lb) && __fsub_rn(opt, lb) > sse && !conv;
    const float cw = __fdiv_rn(par[4], 2.0f);
    const float half = __fdiv_rn(cw, 2.0f);
    float cxyz[3], cen[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float off = static_cast<float>((c >> a) & 1);
      cxyz[a] = __fadd_rn(par[1 + a], __fmul_rn(off, cw));
      cen[a] = __fadd_rn(cxyz[a], half);
    }
    const float nrm = norm3_of(cen[0], cen[1], cen[2]);
    const bool inside =
        __fsub_rn(nrm, __fdiv_rn(__fmul_rn(kSqrt3f, cw), 2.0f)) <= kPif;
    float R[9];
    rodrigues_of(cen, nrm, R);
    float* cn = out_<float>(p[kOChildNodes]) + 4 * (ol + l);
    for (int a = 0; a < 3; ++a) cn[a] = cxyz[a];
    cn[3] = cw;
    out_<float>(p[kOWidths])[ol + l] = cw;
    out_<unsigned char>(p[kOActive])[ol + l] = inside && ex;
    for (int k = 0; k < 9; ++k) out_<float>(p[kORLanes])[9 * (ol + l) + k] = R[k];
  }
}

// One block a (row, lane): the rotated data, the rotation uncertainty, the
// root corners' counts and the fresh inner state.  Reads what the row
// kernel wrote: the lane's R, width and active flag (and, both, the
// adopted incumbent).
__global__ void __launch_bounds__(kThreads) advance_lane_kernel(
    AdvanceParams ap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_R[9], s_corner[8 * 3], s_cv[8];
  const void* const* p = ap.p;
  const int L = ap.L, C = ap.C, Nd = ap.Nd;
  const int i = blockIdx.x / L, l = blockIdx.x % L;
  const int w = ap.rows[i], o = ap.out_rows[i];
  const int t = threadIdx.x;
  const size_t ol = static_cast<size_t>(o) * L + l;
  const float inf = inf_();
  const bool corners = ap.chem.cell_compat != nullptr;

  if (t < 9) s_R[t] = in_<float>(p[kORLanes])[9 * ol + t];
  if (corners && t < 24) {
    const int k = t / 3, a = t % 3;
    const float off = static_cast<float>((k >> a) & 1);
    s_corner[t] = __fadd_rn(ap.root[a], __fmul_rn(off, ap.root[3]));
  }
  __syncthreads();

  // the data rotated by the lane's R, and 2 sin(min(sqrt3 w / 2, pi) / 2)
  // times each point's norm
  const float wd = in_<float>(p[kOWidths])[ol];
  float ang = __fdiv_rn(__fmul_rn(kSqrt3f, wd), 2.0f);
  ang = ang > kPif ? kPif : ang;        // clamp(max=pi); NaN stays
  float sn, cs;
  sincos32(__fdiv_rn(ang, 2.0f), &sn, &cs);
  const float two_s = __fmul_rn(2.0f, sn);
  const float* data = in_<float>(p[kData]) + static_cast<size_t>(w) * Nd * 3;
  const float* nrm = in_<float>(p[kNormData]) + static_cast<size_t>(w) * Nd;
  float* pts = out_<float>(p[kOPts]) + ol * Nd * 3;
  float* mrd = out_<float>(p[kOMrd]) + ol * Nd;
  for (int n = t; n < Nd; n += kThreads) {
    float v[3];
    rotate_point(s_R, data + 3 * n, v);
    for (int a = 0; a < 3; ++a) pts[3 * n + a] = v[a];
    mrd[n] = __fmul_rn(two_s, nrm[n]);
  }

  // the root translation cube's 8 corner counts (K2's body, the lane's
  // rotated points just written)
  if (corners) {
    __threadfence();
    __syncthreads();
    ChemParams c = ap.chem;
    c.pts = out_<float>(p[kOPts]) + static_cast<size_t>(o) * L * Nd * 3;
    chem_incomp_body<true>(c, l, w, smem, 0, 8, s_corner, s_cv);
    __syncthreads();
  }

  // the fresh inner state: the root at slot 0, the incumbent, done =
  // !active (a converged pop leaves no lane active)
  const float inc = ap.mode == kBoth ? in_<float>(p[kOOptErr])[o]
                                     : in_<float>(p[kOptErr])[w];
  float* nodes = out_<float>(p[kONodes]) + ol * C * 4;
  float* lbs = out_<float>(p[kOLbs]) + ol * C;
  for (int k = t; k < 4 * C; k += kThreads) nodes[k] = k < 4 ? ap.root[k] : 0.0f;
  for (int k = t; k < C; k += kThreads) lbs[k] = k == 0 ? 0.0f : inf;
  if (p[kOCvals] != nullptr) {
    float* cv = out_<float>(p[kOCvals]) + ol * C * 8;
    for (int k = t; k < 8 * C; k += kThreads) cv[k] = k < 8 ? s_cv[k] : 0.0f;
  }
  if (t < 4) out_<float>(p[kOBestNode])[4 * ol + t] = 0.0f;
  if (t < 3) out_<float>(p[kOUbTerms])[3 * ol + t] = 0.0f;
  if (t == 0) {
    out_<float>(p[kOIOpt])[ol] = inc;
    out_<float>(p[kOIThr])[ol] = inc;
    out_<float>(p[kOIMinDropped])[ol] = inf;
    out_<unsigned char>(p[kODone])[ol] = !in_<unsigned char>(p[kOActive])[ol];
  }
}

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace goicp

// One launch for n rows (in launches of at most kMaxRows): slots are the
// HarvestSlot pointers, ints = (L, C).
extern "C" int goicp_harvest(const unsigned long long* slots, int n_slots,
                             const int* ints, int n_ints, const int* rows,
                             int n, void* stream) {
  using namespace goicp;
  if (n_slots != kHSlots || n_ints != 2 || n < 0) return invalid();
  HarvestParams hp{};
  for (int k = 0; k < kHSlots; ++k)
    hp.p[k] = reinterpret_cast<const void*>(slots[k]);
  hp.L = ints[0];
  hp.C = ints[1];
  if (hp.L <= 0 || hp.C <= 0 || hp.L > 32 * 1024) return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < n; r0 += kMaxRows) {
    const int m = n - r0 < kMaxRows ? n - r0 : kMaxRows;
    for (int k = 0; k < m; ++k) hp.rows[k] = rows[r0 + k];
    // the row-indexed outputs of this launch start at row r0
    HarvestParams h = hp;
    const size_t L = hp.L;
    auto shift = [&](int slot, size_t per_row) {
      if (h.p[slot] != nullptr)
        h.p[slot] = static_cast<const char*>(h.p[slot]) + per_row * r0;
    };
    shift(kHOLbSafe, 4 * L);
    shift(kHOUbs, 4 * L);
    shift(kHOCandUb, 4);
    shift(kHOIncumbent, 4);
    shift(kHOCandR, 36);
    shift(kHOCandT, 12);
    shift(kHOCandTerms, 12);
    shift(kHOFlags, 2);
    harvest_kernel<<<m, kThreads, 4 * L, s>>>(h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The row kernel, then (pop, both) the lane kernel, for n rows (in
// launches of at most kMaxRows): slots are the AdvanceSlot pointers, ints
// the AdvanceInt values, root the translation root (x, y, z, width),
// out_rows null: row k of the outputs is k.  cudaErrorInvalidValue for a
// frontier whose arrays do not fit a block's shared memory.
extern "C" int goicp_advance(const unsigned long long* slots, int n_slots,
                             const int* ints, int n_ints, const float* root,
                             const int* rows, const int* out_rows, int n,
                             void* stream) {
  using namespace goicp;
  if (n_slots != kASlots || n_ints != kAInts || n < 0) return invalid();
  AdvanceParams ap{};
  for (int k = 0; k < kASlots; ++k)
    ap.p[k] = reinterpret_cast<const void*>(slots[k]);
  ap.mode = ints[kMode];
  ap.L = ints[kLanes];
  ap.Cr = ints[kCr];
  ap.Pr = ints[kPr];
  ap.C = ints[kCap];
  ap.Nd = ints[kNd];
  ap.icp_on_improve = ints[kIcpOnImprove];
  for (int k = 0; k < 4; ++k) ap.s_work[k] = ints[kSEvals + k];
  for (int k = 0; k < 4; ++k) ap.root[k] = root[k];
  if (ap.mode < kBoth || ap.mode > kAdopt || ap.Pr <= 0 || ap.L != 8 * ap.Pr ||
      ap.Cr <= ap.Pr || ap.C <= 0 || ap.Nd <= 0)
    return invalid();
  ChemParams& c = ap.chem;
  c.cell_compat = static_cast<const float*>(ap.p[kCellCompat]);
  c.prop_onehot = static_cast<const float*>(ap.p[kPropOnehot]);
  c.data_mask = static_cast<const float*>(ap.p[kDataMask]);
  c.nearest_cell = static_cast<const int*>(ap.p[kNearestCell]);
  c.consts = static_cast<const float*>(ap.p[kConsts]);
  c.L = ap.L;
  c.Q = 8;
  c.Nd = ap.Nd;
  c.C = ints[kNCells];
  c.n_vox = ints[kSize] * ints[kSize] * ints[kSize];

  // the row kernel's shared memory: the frontier, the children, the
  // parents (the pop alone stages only the parents)
  const size_t row_words =
      (ap.mode == kPop ? 0 : 5 * static_cast<size_t>(ap.Cr) + 8 * ap.L) +
      5 * static_cast<size_t>(ap.Pr);
  if (4 * row_words > kMaxDynamicSmem) return invalid();
  static size_t granted_row = 0, granted_lane = 0;
  cudaError_t err = allow_smem(advance_row_kernel, 4 * row_words, &granted_row);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t lane_words = 0;
  if (c.cell_compat != nullptr) {
    c.stage_points = 4 * chem_points_words(c) <= kMaxDynamicSmem;
    if (c.stage_points) lane_words += chem_points_words(c);
    c.stage_tables = 4 * (lane_words + chem_tables_words(c)) <= kMaxDynamicSmem;
    if (c.stage_tables) lane_words += chem_tables_words(c);
    err = allow_smem(advance_lane_kernel, 4 * lane_words, &granted_lane);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < n; r0 += kMaxRows) {
    const int m = n - r0 < kMaxRows ? n - r0 : kMaxRows;
    AdvanceParams a = ap;
    for (int k = 0; k < m; ++k) {
      a.rows[k] = rows[r0 + k];
      a.out_rows[k] = out_rows != nullptr ? out_rows[r0 + k] : r0 + k;
    }
    // the harvest's, the refine block's and min_lb's rows of this launch
    // start at row r0
    const size_t L = ap.L;
    auto shift = [&](int slot, size_t per_row) {
      if (a.p[slot] != nullptr)
        a.p[slot] = static_cast<const char*>(a.p[slot]) + per_row * r0;
    };
    shift(kLbSafe, 4 * L);
    shift(kCandUb, 4);
    shift(kIncumbent, 4);
    shift(kCandR, 36);
    shift(kCandT, 12);
    shift(kCandTerms, 12);
    shift(kFlags, 2);
    shift(kIcpR, 36);
    shift(kIcpT, 12);
    shift(kIcpErr, 4);
    shift(kIcpTerms, 12);
    shift(kIcpIncomp, 4);
    shift(kBnbComp, 4);
    shift(kDoIcp, 1);
    shift(kMinLb, 4);
    advance_row_kernel<<<m, kThreads, 4 * row_words, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (ap.mode == kAdopt) continue;
    advance_lane_kernel<<<m * ap.L, kThreads, 4 * lane_words, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
