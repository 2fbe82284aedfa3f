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
// goicp_harvest (the body in harvest_body.cuh): a finished inner search's
// harvest, one block a row (each lane's lb_safe and ub, the first argmin
// lane's candidate, the incumbent and the flags improved, converged); or
// the fused stream's event head alone, one block (the flags of every row,
// the served rows, their harvest and the event's words), for a chunk's
// first event.  The later events' heads run at the end of the inner run
// that precedes them (inner.cu), as register_device's and the batch
// engine's harvests do.
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
// goicp_advance is one launch in every mode, a thread-block cluster a row
// (one block in adopt mode).  Rank 0 does the row's work: it stages the
// frontier (2,048 nodes x 5 floats at the default capacity, 40 KB) in
// shared memory with one bulk copy a field (cp.async.bulk, completed on an
// mbarrier; the host requires 16-byte aligned frontier rows) and, while the
// copy is in flight, loads the scalars the adoption and the pop read (a
// load a thread), writes the adopted values and counters and forms the
// children's keys and ranks; then the merge into shared memory, written
// out with one bulk copy a field, the pop and rodrigues.  A row may be
// written over itself (the streams write their window state in place):
// each of rank 0's threads reads an element before it writes it, the
// frontier is read whole before any of it is written, and the other
// blocks write only after the cluster barrier that follows.
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
// show.  The per-lane work (the rotated data, the uncertainty, the root
// corners through K2's body, chem_body.cuh, and the fresh lanes) is
// spread over the cluster's K = min(8, L) blocks, L / K lanes each: every
// block starts loading the pair's data, point norms and K2's tables into
// its own shared memory at once; rank 0 writes each block's lanes' R,
// rotation factor and active flag and the incumbent into that block's
// shared memory (distributed shared memory: a lane block never reads the
// row being written), and after the cluster barrier every block writes
// its lanes.  So a transition batch is one launch of advance, whatever
// its number of rows, after the harvest (at the end of the inner run, or
// goicp_harvest).
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
// floats) and the rotated points, microseconds of bandwidth; the cost is
// one serial chain a row (stage, merge, pop, rodrigues) and the launches.
// One launch instead of a row kernel and a lane kernel removes a launch
// and the lanes' wait for it; the bulk copy puts the frontier's load
// under the scalars and the children's ranks; the lane blocks' loads run
// under rank 0's chain, and each block stages the pair's tables once for
// its L / K lanes instead of once a lane.  What it did not buy, measured
// on the H100 (chip_smoke.py phase 2's graph_ms, PERF.md §6): the
// launch's card time, ~0.018 ms for two rows as for the two launches
// before; rank 0's serial chain is what is left.
#include <cooperative_groups.h>

#include "chem_body.cuh"
#include "harvest_body.cuh"
#include "rot_body.cuh"

namespace goicp {

namespace cg = cooperative_groups;

constexpr int kMaxRows = 256;      // rows a launch carries in its parameters
constexpr int kThreads = 256;      // a harvest block
// an advance block: rank 0's chain is one dependent pass a frontier entry
// or lane a thread, so the more threads, the shorter it is
constexpr int kAdvThreads = 1024;

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

// ---------------------------------------------------------------------------
// harvest
// ---------------------------------------------------------------------------

// goicp_harvest's pointer slots (search/transition.py's _HARVEST_IN,
// _HARVEST_OUT, then the event head's own); the last four only in the
// event mode
enum HarvestSlot {
  kHLbs, kHRef, kHMinDrop, kHDone, kHLbIn, kHUbErr, kHBestNode, kHUbTerms,
  kHActive, kHRLanes, kHOptErr, kHConv, kHOLbSafe, kHOUbs, kHOCandUb,
  kHOIncumbent, kHOCandR, kHOCandT, kHOCandTerms, kHOFlags, kHSlots,
  kHIt = kHSlots, kHInnerIt, kHOWords, kHOFin0, kHEventSlots
};

template <typename T>
__device__ __forceinline__ const T* in_(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
__device__ __forceinline__ T* out_(const void* p) {
  return static_cast<T*>(const_cast<void*>(p));
}

struct HarvestParams {
  HarvestIo io;
  int rows[kMaxRows];
};

// a block a row
__global__ void __launch_bounds__(kThreads)
    harvest_kernel(const __grid_constant__ HarvestParams hp) {
  extern __shared__ float s_ubs[];   // (L,)
  const int i = blockIdx.x, w = hp.rows[i];
  harvest_rows(hp.io, [w](int) { return w; }, 1, i, s_ubs, hp.io.L, nullptr);
}

struct EventParams {
  HarvestIo io;
  EventIo ev;
  int cap;                           // the block's shared words
  int n_iters;                       // the event words' global iterations
};

// the event head alone (a chunk's first event): one block
__global__ void __launch_bounds__(kThreads)
    event_kernel(const __grid_constant__ EventParams ep) {
  extern __shared__ int s_ev[];
  event_head(ep.ev, ep.io, ep.n_iters, s_ev, ep.cap);
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

// The shared memory of an advance block, in 32-bit words from the start
// of the dynamic region, every region 16-byte aligned.  The row region is
// rank 0's alone (the other blocks of the cluster hold it unused: one
// launch, one size); the lane region is every block's.  The regions a
// stage flag names are staged where they fit, in that order (else read
// from device memory through the same pointers).
struct AdvanceLayout {
  // the row region: the old and the new frontier's lbs and nodes, the
  // children's keys, the keys sorted, the children's nodes and ranks
  // (adopt, both); the parents (lb, node)
  size_t fl, fn, ol, on, ck, cs, cn, cr, par;
  // the lane region (pop, both): the block's lanes' R, 2 sin(angle / 2),
  // active flags and root corner counts; the pair's data and point norms
  // (stage_data), the lanes' rotated points (stage_pts), the pair's
  // one-hot rows and mask (stage_pm), its nearest-cell table and
  // compatibility rows (stage_tab)
  size_t lR, l2s, la, cv, data, norm, pts, onehot, mask, table, compat;
  int stage_data, stage_pts, stage_pm, stage_tab;
  size_t words;
};

inline size_t take_words(size_t* at, size_t n) {
  const size_t here = *at;
  *at += region_words(n);
  return here;
}

inline AdvanceLayout advance_layout(int mode, int Cr, int Pr, int L, int Nd,
                                    int lanes_per_block, bool corners,
                                    int n_vox, int n_cells) {
  const bool adopts = mode != kPop, pops = mode != kAdopt;
  const size_t fr = adopts ? static_cast<size_t>(Cr) : 0;
  const size_t ch = adopts ? static_cast<size_t>(L) : 0;
  const size_t lb = pops ? static_cast<size_t>(lanes_per_block) : 0;
  const size_t nd = Nd;
  AdvanceLayout a{};
  size_t w = 0;
  a.fl = take_words(&w, fr);
  a.fn = take_words(&w, 4 * fr);
  a.ol = take_words(&w, fr);
  a.on = take_words(&w, 4 * fr);
  a.ck = take_words(&w, ch);
  a.cs = take_words(&w, ch);
  a.cn = take_words(&w, 4 * ch);
  a.cr = take_words(&w, ch);
  a.par = take_words(&w, 5 * static_cast<size_t>(Pr));
  a.lR = take_words(&w, 9 * lb);
  a.l2s = take_words(&w, lb);
  a.la = take_words(&w, lb);
  a.cv = take_words(&w, 8 * lb);
  const size_t cap = kMaxDynamicSmem / 4;
  auto fits = [&](size_t n) { return pops && w + n <= cap; };
  if ((a.stage_data = fits(region_words(3 * nd) + region_words(nd)))) {
    a.data = take_words(&w, 3 * nd);
    a.norm = take_words(&w, nd);
  }
  if ((a.stage_pts = corners && fits(region_words(3 * nd * lb))))
    a.pts = take_words(&w, 3 * nd * lb);
  if ((a.stage_pm = corners && fits(region_words(9 * nd) + region_words(nd)))) {
    a.onehot = take_words(&w, 9 * nd);
    a.mask = take_words(&w, nd);
  }
  if ((a.stage_tab = corners && fits(region_words(n_vox) +
                                     region_words(9 * static_cast<size_t>(n_cells))))) {
    a.table = take_words(&w, n_vox);
    a.compat = take_words(&w, 9 * static_cast<size_t>(n_cells));
  }
  a.words = w;
  return a;
}

struct AdvanceParams {
  const void* p[kASlots];
  int mode, L, Cr, Pr, C, Nd, icp_on_improve;
  int K;                // the cluster's blocks (1 in adopt mode)
  int s_work[4];        // evals, it, geom_surv, chem_corners when null
  float root[4];        // the translation root: x, y, z, width
  ChemParams chem;      // K2's tables (cell_compat null: no corners)
  AdvanceLayout lay;
  int rows[kMaxRows];
  int out_rows[kMaxRows];
};

template <typename T>
__device__ __forceinline__ T get_(const void* p, size_t i, T fallback) {
  return p != nullptr ? static_cast<const T*>(p)[i] : fallback;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the frontier's bulk copy: one thread arms the barrier with the bytes to
// come and starts the copies; every thread waits on phase 0
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait0(unsigned long long* bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared memory written by threads, then read by a bulk copy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the cluster barrier in two halves: every block arrives at its start and
// waits before the first access to another block's shared memory (which
// must not come before that block has started)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One cluster of K blocks a row (one block in adopt mode).  Rank 0 does
// the row's work: adopt (adopt, both), merge, then pop (pop, both), and
// writes each block's lanes' R, rotation factor and active flag, and the
// incumbent, into that block's shared memory.  Every block then serves
// L / K lanes: the rotated data, the rotation uncertainty, the root
// corners' counts and the fresh inner state.
__global__ void __launch_bounds__(kAdvThreads) advance_kernel(AdvanceParams ap) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_f[2];        // the adopted incumbent; a lane block's copy
  __shared__ int s_b[4];          // improved, icp_improved, frozen, conv
  __shared__ float s_red[kAdvThreads / 32];
  __shared__ float s_in[8];       // the adoption's inputs
  __shared__ float s_pp[5];       // min_lb, converged, final_lb, sse, min_dropped
  __shared__ float s_corner[8 * 3];
  __shared__ __align__(8) unsigned long long s_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const void* const* p = ap.p;
  const int K = ap.K;
  const int rank = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x / K, w = ap.rows[i], o = ap.out_rows[i];
  const int L = ap.L, Cr = ap.Cr, Pr = ap.Pr, mode = ap.mode, Nd = ap.Nd;
  const int t = threadIdx.x, warp = t >> 5, tid = t & 31;
  const float inf = inf_();
  const bool adopts = mode != kPop, pops = mode != kAdopt;
  const AdvanceLayout& lay = ap.lay;
  const int lpb = L / K, l0 = rank * lpb;     // this block's lanes
  const size_t wc = static_cast<size_t>(w) * Cr, oc = static_cast<size_t>(o) * Cr;
  const size_t wl = static_cast<size_t>(w) * L, ol = static_cast<size_t>(o) * L;
  const bool corners = ap.chem.cell_compat != nullptr;
  const ChemParams& c = ap.chem;
  if (pops) cluster_arrive();

  // ---- every block: start the lanes' loads (the pair's data and point
  // norms, and K2's one-hot rows, mask and tables) before anything else ----
  const size_t pw = static_cast<size_t>(w);
  const float* g_data = in_<float>(p[kData]) + pw * Nd * 3;
  const float* g_norm = in_<float>(p[kNormData]) + pw * Nd;
  const float* g_onehot = corners ? c.prop_onehot + pw * Nd * 9 : nullptr;
  const float* g_mask = corners ? c.data_mask + pw * Nd : nullptr;
  const int* g_table = corners ? c.nearest_cell + pw * c.n_vox : nullptr;
  const float* g_compat = corners ? c.cell_compat + pw * c.C * 9 : nullptr;
  if (pops) {
    if (lay.stage_data) {
      async_copy_words(sm + lay.data, g_data, 3 * Nd);
      async_copy_words(sm + lay.norm, g_norm, Nd);
    }
    if (lay.stage_pm) {
      async_copy_words(sm + lay.onehot, g_onehot, 9 * Nd);
      async_copy_words(sm + lay.mask, g_mask, Nd);
    }
    if (lay.stage_tab) {
      async_copy_words(sm + lay.table, g_table, c.n_vox);
      async_copy_words(sm + lay.compat, g_compat, 9 * c.C);
    }
    if (t < 24) {
      const int k = t / 3, a = t % 3;
      const float off = static_cast<float>((k >> a) & 1);
      s_corner[t] = __fadd_rn(ap.root[a], __fmul_rn(off, ap.root[3]));
    }
  }
  async_commit();

  bool stored = false;      // rank 0's thread 0 has bulk stores in flight
  if (rank == 0) {
    float* s_fl = sm + lay.fl;             // (Cr,) the old frontier's lbs
    float* s_fn = sm + lay.fn;             // (Cr, 4) and nodes
    float* s_ol = sm + lay.ol;             // (Cr,) the new frontier's lbs
    float* s_on = sm + lay.on;             // (Cr, 4) and nodes
    float* s_ck = sm + lay.ck;             // (L,) the children's keys
    float* s_cs = sm + lay.cs;             // (L,) the keys sorted
    float* s_cn = sm + lay.cn;             // (L, 4) the children's nodes
    int* s_cr = reinterpret_cast<int*>(sm + lay.cr);   // (L,) their ranks
    float* s_par = sm + lay.par;           // (Pr, 5) the parents: lb, node
    // the frontier's rest merged with the children: all of it (both) or
    // what the pop left (adopt)
    const int r0 = mode == kAdopt ? Pr : 0, R = Cr - r0;

    // ---- the pop's scalars, loaded now (no load on the chain after the
    // merge) ----
    if (pops && t >= 8 && t < 12) {
      float v;
      switch (t) {
        case 8: v = get_<float>(p[kMinLb], i, 0.0f); break;
        case 9: v = in_<unsigned char>(p[kConverged])[w]; break;
        case 10: v = in_<float>(p[kFinalLb])[w]; break;
        default: v = in_<float>(p[kSse])[w]; break;
      }
      s_pp[t - 8] = v;
    }
    if (adopts) {
      // ---- the old frontier: one bulk copy a field (the host checked
      // that both ends are 16-byte aligned), in flight while the scalars,
      // the adopted values, the children's keys and their ranks are
      // formed ----
      const float* g_fl = in_<float>(p[kFrLbs]) + wc;
      const float* g_fn = in_<float>(p[kFrNodes]) + 4 * wc;
      const uint32_t b_fl = 4 * static_cast<uint32_t>(Cr), b_fn = 4 * b_fl;
      if (t == 0) bar_init(&s_bar);
      __syncthreads();
      if (t == 0) {
        bar_expect(&s_bar, b_fl + b_fn);
        bulk_load(s_fl, g_fl, b_fl, &s_bar);
        bulk_load(s_fn, g_fn, b_fn, &s_bar);
      }
      // ---- adopt: the scalars, their loads in flight together (a load a
      // thread), then combined ----
      if (t < 8) {
        float v;
        switch (t) {
          case 0: v = in_<unsigned char>(p[kFlags])[2 * i]; break;
          case 1: v = get_<unsigned char>(p[kDoIcp], i, 0); break;
          case 2: v = get_<float>(p[kIcpErr], i, inf); break;
          case 3: v = in_<float>(p[kIncumbent])[i]; break;
          case 4: v = in_<float>(p[kOptErr])[w]; break;
          case 5: v = in_<float>(p[kCandUb])[i]; break;
          case 6: v = in_<unsigned char>(p[kConverged])[w]; break;
          default: v = get_<unsigned char>(p[kPConv], w, 0); break;
        }
        s_in[t] = v;
      }
      if (t == 12) s_pp[4] = in_<float>(p[kMinDropped])[w];
      for (int j = t; j < L; j += kAdvThreads)
        for (int a = 0; a < 4; ++a)
          s_cn[4 * j + a] = in_<float>(p[kChildNodes])[4 * (wl + j) + a];
      __syncthreads();
      if (t == 0) {
        const bool improved = s_in[0] != 0.0f;
        const bool do_icp = s_in[1] != 0.0f;
        const float icp_err = do_icp ? s_in[2] : inf;
        const bool icp_improved = do_icp && !(icp_err >= s_in[3]);
        s_f[0] = icp_improved ? icp_err : (improved ? s_in[5] : s_in[4]);
        s_b[0] = improved;
        s_b[1] = icp_improved;
        s_b[2] = mode == kAdopt && (s_in[6] != 0.0f || s_in[7] != 0.0f);
      }
      __syncthreads();
      const float opt_new = s_f[0];
      const bool improved = s_b[0] != 0, icp_improved = s_b[1] != 0;
      const bool frozen = s_b[2] != 0;
      const bool do_icp = s_in[1] != 0.0f;

      // ---- the row's adopted values and counters, a thread a value, their
      // loads in flight together and with the frontier's copy (each
      // element is read and written by one thread, so a row written over
      // itself reads it before it writes it); opt_err and min_dropped
      // after the merge ----
      {
        // a row that did not refine takes the refine block's dummies
        // (identity, 0, inf, 0, 0, 0), which no pick selects
        auto pick = [&](int old_slot, int cand_slot, int icp_slot, int k,
                        int per, float dummy) {
          const float old_v = in_<float>(p[old_slot])[per * w + k];
          const float icp_v =
              do_icp ? in_<float>(p[icp_slot])[per * i + k] : dummy;
          const float v = icp_improved ? icp_v
                          : improved   ? in_<float>(p[cand_slot])[per * i + k]
                                       : old_v;
          return frozen ? old_v : v;
        };
        if (t < 9) {
          out_<float>(p[kOOptR])[9 * o + t] =
              pick(kOptR, kCandR, kIcpR, t, 9, t % 4 == 0 ? 1.0f : 0.0f);
        } else if (t < 12) {
          out_<float>(p[kOOptT])[3 * o + t - 9] =
              pick(kOptT, kCandT, kIcpT, t - 9, 3, 0.0f);
        } else if (t < 15) {
          out_<float>(p[kOTerms])[3 * o + t - 12] =
              pick(kTerms, kCandTerms, kIcpTerms, t - 12, 3, 0.0f);
        } else if (t == 15) {
          const int comp_old = in_<int>(p[kComp])[w];
          const int comp =
              icp_improved ? (do_icp ? in_<int>(p[kIcpIncomp])[i] : 0)
              : improved   ? (do_icp ? in_<int>(p[kBnbComp])[i] : 0)
                           : comp_old;
          out_<int>(p[kOComp])[o] = frozen ? comp_old : comp;
        } else if (t == 16) {
          const bool li_old = in_<unsigned char>(p[kLastIcp])[w] != 0;
          const bool li = icp_improved || (!improved && li_old);
          out_<unsigned char>(p[kOLastIcp])[o] = frozen ? li_old : li;
        } else if (t < 21) {
          // the counters: + the inner search's work (none when frozen)
          const int k = t - 17;
          const int in_slot[4] = {kEvals, kInnerIt, kGeomSurv, kChemCorners};
          const int out_slot[4] = {kOEvals, kOInnerIt, kOGeomSurv,
                                   kOChemCorners};
          const int work_slot[4] = {kWEvals, kWIt, kWSurv, kWCorners};
          const int add = get_<int>(p[work_slot[k]], w, ap.s_work[k]);
          out_<int>(p[out_slot[k]])[o] =
              in_<int>(p[in_slot[k]])[w] + (frozen ? 0 : add);
        } else if (t == 21) {
          out_<int>(p[kOIcpRuns])[o] =
              in_<int>(p[kIcpRuns])[w] +
              (frozen ? 0 : (ap.icp_on_improve ? improved : 1));
        } else if (t == 22) {
          if (p[kIt] != nullptr && p[kOIt] != nullptr)
            out_<int>(p[kOIt])[o] = in_<int>(p[kIt])[w] + 1;
        } else if (t == 24 && mode == kAdopt) {
          out_<float>(p[kOFinalLb])[o] = in_<float>(p[kPFinal])[w];
        }
      }

      for (int j = t; j < L; j += kAdvThreads) {
        const float lb = in_<float>(p[kLbSafe])[static_cast<size_t>(i) * L + j];
        s_ck[j] =
            in_<unsigned char>(p[kActive])[wl + j] && lb < opt_new ? lb : inf;
      }
      __syncthreads();
      // each child's rank among the children: smaller keys, then ties by
      // index
      for (int j = t; j < L; j += kAdvThreads) {
        const float k = s_ck[j];
        int rank_j = 0;
        for (int m = 0; m < L; ++m)
          rank_j += s_ck[m] < k || (m < j && s_ck[m] == k);
        s_cr[j] = rank_j;
        s_cs[rank_j] = k;
      }
      bar_wait0(&s_bar);
      __syncthreads();

      // ---- the merge into shared memory: each entry's place ----
      // both: position q < Pr is parent q, position q < Cr goes to q - Pr;
      // adopt: position q < Cr goes to q (frozen: the old frontier instead).
      float drop = inf;
      for (int e = t; e < R + L; e += kAdvThreads) {
        const float v = e < R ? s_fl[r0 + e] : s_ck[e - R];
        const float4 node = e < R ? reinterpret_cast<const float4*>(s_fn)[r0 + e]
                                  : reinterpret_cast<const float4*>(s_cn)[e - R];
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
          float* par = s_par + 5 * pos;
          par[0] = kept;
          par[1] = node.x;
          par[2] = node.y;
          par[3] = node.z;
          par[4] = node.w;
        } else {
          const int q = mode == kBoth ? pos - Pr : pos;
          s_ol[q] = kept;
          reinterpret_cast<float4*>(s_on)[q] = node;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        drop = fminf(drop, __shfl_xor_sync(0xffffffffu, drop, off));
      if (tid == 0) s_red[warp] = drop;
      if (mode == kBoth)   // the rest shifted up: inf lbs, zero nodes behind
        for (int e = Cr - Pr + t; e < Cr; e += kAdvThreads) {
          s_ol[e] = inf;
          reinterpret_cast<float4*>(s_on)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      // ---- the new frontier (a frozen row: its old one) out of shared
      // memory, one bulk copy a field ----
      const float* src_l = frozen ? s_fl : s_ol;
      const float* src_n = frozen ? s_fn : s_on;
      fence_async_shared();
      __syncthreads();
      if (t == 0) {
        bulk_store(out_<float>(p[kOFrLbs]) + oc, src_l, b_fl);
        bulk_store(out_<float>(p[kOFrNodes]) + 4 * oc, src_n, b_fn);
        bulk_commit();
        stored = true;
      }
      if (t == 0) {
        float md = inf;
        for (int k = 0; k < kAdvThreads / 32; ++k) md = fminf(md, s_red[k]);
        const float md_old = s_pp[4];
        out_<float>(p[kOOptErr])[o] = frozen ? s_in[4] : opt_new;
        out_<float>(p[kOMinDropped])[o] = frozen ? md_old : min_nan(md_old, md);
        if (mode == kAdopt) out_<unsigned char>(p[kOConverged])[o] = frozen;
      }
      if (mode == kAdopt) {
        if (stored) bulk_wait_all();
        return;
      }
    } else {
      for (int e = t; e < 5 * Pr; e += kAdvThreads) {
        const int q = e / 5, a = e % 5;
        s_par[e] = a == 0 ? in_<float>(p[kFrLbs])[wc + q]
                          : in_<float>(p[kFrNodes])[4 * (wc + q) + a - 1];
      }
      if (t == 0) s_f[0] = in_<float>(p[kOptErr])[w];
      __syncthreads();
    }

    // ---- the pop: convergence, final_lb, the parents' expand flags ----
    const float opt = s_f[0];
    const float sse = s_pp[3];
    if (t == 0) {
      const float min_lb = p[kMinLb] != nullptr ? s_pp[0] : s_par[0];
      const bool conv = fabsf(min_lb) == inf ||
                        __fsub_rn(opt, min_lb) <= sse || nan_(opt);
      const bool conv_old = s_pp[1] != 0.0f;
      const float final_lb = conv && !conv_old ? min_lb : s_pp[2];
      s_b[3] = conv;
      out_<unsigned char>(p[kOConverged])[o] =
          mode == kBoth ? (conv_old || conv) : conv;
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
    for (int q = t; q < Pr; q += kAdvThreads) {
      const float lb = s_par[5 * q];
      const bool ex = finite_(lb) && __fsub_rn(opt, lb) > sse && !conv;
      if (p[kOPopLb] != nullptr) {
        out_<float>(p[kOPopLb])[static_cast<size_t>(o) * Pr + q] = lb;
        out_<unsigned char>(p[kOExpand])[static_cast<size_t>(o) * Pr + q] = ex;
      }
    }

    // ---- the children: nodes, widths, the pi-ball, rodrigues, and each
    // lane's rotation factor 2 sin(min(sqrt3 w / 2, pi) / 2), written into
    // the shared memory of the block that serves the lane ----
    cluster_wait();                       // every block has started
    for (int l = t; l < L; l += kAdvThreads) {
      const int q = l >> 3, ci = l & 7;
      const float* par = s_par + 5 * q;
      const float lb = par[0];
      const bool ex = finite_(lb) && __fsub_rn(opt, lb) > sse && !conv;
      const float cw = __fdiv_rn(par[4], 2.0f);
      const float half = __fdiv_rn(cw, 2.0f);
      float cxyz[3], cen[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float off = static_cast<float>((ci >> a) & 1);
        cxyz[a] = __fadd_rn(par[1 + a], __fmul_rn(off, cw));
        cen[a] = __fadd_rn(cxyz[a], half);
      }
      const float nrm = norm3_of(cen[0], cen[1], cen[2]);
      const bool inside =
          __fsub_rn(nrm, __fdiv_rn(__fmul_rn(kSqrt3f, cw), 2.0f)) <= kPif;
      float Rl[9];
      rodrigues_of(cen, nrm, Rl);
      const float sine2 = rot_unc_sine2(cw);
      float* cn = out_<float>(p[kOChildNodes]) + 4 * (ol + l);
      for (int a = 0; a < 3; ++a) cn[a] = cxyz[a];
      cn[3] = cw;
      out_<float>(p[kOWidths])[ol + l] = cw;
      out_<unsigned char>(p[kOActive])[ol + l] = inside && ex;
      for (int k = 0; k < 9; ++k)
        out_<float>(p[kORLanes])[9 * (ol + l) + k] = Rl[k];
      const int owner = l / lpb, j = l - owner * lpb;
      float* dst = cluster.map_shared_rank(sm, owner);
      for (int k = 0; k < 9; ++k) dst[lay.lR + 9 * j + k] = Rl[k];
      dst[lay.l2s + j] = sine2;
      dst[lay.la + j] = inside && ex ? 1.0f : 0.0f;
    }
    if (t < K) *cluster.map_shared_rank(&s_f[1], t) = opt;
  } else if (pops) {
    cluster_wait();
  }
  if (!pops) return;

  // ---- every block: its lanes' R, rotation factor, active flag and the
  // incumbent in its own shared memory after the cluster barrier ----
  cluster.sync();
  async_wait<0>();
  __syncthreads();

  // ---- the rotated data and the rotation uncertainty of the block's
  // lanes (kept in shared memory for the corners where they fit) ----
  const float* data = lay.stage_data ? sm + lay.data : g_data;
  const float* nrm = lay.stage_data ? sm + lay.norm : g_norm;
  float* o_pts = out_<float>(p[kOPts]);
  float* o_mrd = out_<float>(p[kOMrd]);
  float* pts = lay.stage_pts ? sm + lay.pts : o_pts + (ol + l0) * Nd * 3;
  for (int e = t; e < lpb * Nd; e += kAdvThreads) {
    const int j = e / Nd, n = e - j * Nd;
    const size_t lane = ol + l0 + j;
    float v[3];
    rotate_point(sm + lay.lR + 9 * j, data + 3 * n, v);
    for (int a = 0; a < 3; ++a) {
      o_pts[(lane * Nd + n) * 3 + a] = v[a];
      if (lay.stage_pts) pts[3 * e + a] = v[a];
    }
    o_mrd[lane * Nd + n] = __fmul_rn(sm[lay.l2s + j], nrm[n]);
  }

  // ---- the root translation cube's 8 corner counts of each lane, a warp
  // a (lane, corner): K2's per-point code (chem_body.cuh's point_incomp)
  // on the lane's rotated points ----
  float* s_cv = sm + lay.cv;
  if (corners) {
    __syncthreads();
    const float* onehot = lay.stage_pm ? sm + lay.onehot : g_onehot;
    const float* mask = lay.stage_pm ? sm + lay.mask : g_mask;
    const int* table =
        lay.stage_tab ? reinterpret_cast<const int*>(sm + lay.table) : g_table;
    const float* compat = lay.stage_tab ? sm + lay.compat : g_compat;
    const GridConsts g = load_consts(c.consts + pw * 5);
    for (int jq = warp; jq < 8 * lpb; jq += kAdvThreads / 32) {
      const int j = jq >> 3;
      const float* cor = s_corner + 3 * (jq & 7);
      const float* pj = pts + static_cast<size_t>(j) * Nd * 3;
      int count = 0;
      for (int n = tid; n < Nd; n += 32) {
        const float* pt = pj + 3 * n;
        const int vx = clamp_voxel(voxel_raw(pt[0], cor[0], g.lo[0], g.scale), g.size);
        const int vy = clamp_voxel(voxel_raw(pt[1], cor[1], g.lo[1], g.scale), g.size);
        const int vz = clamp_voxel(voxel_raw(pt[2], cor[2], g.lo[2], g.scale), g.size);
        count += point_incomp(
            onehot + 9 * n,
            compat + 9 * static_cast<size_t>(table[flat_voxel(vx, vy, vz, g.size)]),
            mask[n]);
      }
      count = warp_sum(count);
      if (tid == 0) s_cv[jq] = static_cast<float>(count);
    }
    __syncthreads();
  }

  // ---- the fresh inner state: the root at slot 0, the incumbent, done =
  // !active (a converged pop leaves no lane active) ----
  const int C = ap.C;
  const float inc = s_f[1];
  const size_t lb0 = ol + l0;
  float* nodes = out_<float>(p[kONodes]) + lb0 * C * 4;
  float* lbs = out_<float>(p[kOLbs]) + lb0 * C;
  for (int e = t; e < lpb * 4 * C; e += kAdvThreads) {
    const int k = e % (4 * C);
    nodes[e] = k < 4 ? ap.root[k] : 0.0f;
  }
  for (int e = t; e < lpb * C; e += kAdvThreads) lbs[e] = e % C == 0 ? 0.0f : inf;
  if (p[kOCvals] != nullptr) {
    float* cv = out_<float>(p[kOCvals]) + lb0 * C * 8;
    for (int e = t; e < lpb * 8 * C; e += kAdvThreads) {
      const int j = e / (8 * C), k = e - j * 8 * C;
      cv[e] = k < 8 ? s_cv[8 * j + k] : 0.0f;
    }
  }
  for (int e = t; e < lpb * 4; e += kAdvThreads)
    out_<float>(p[kOBestNode])[4 * lb0 + e] = 0.0f;
  for (int e = t; e < lpb * 3; e += kAdvThreads)
    out_<float>(p[kOUbTerms])[3 * lb0 + e] = 0.0f;
  for (int j = t; j < lpb; j += kAdvThreads) {
    out_<float>(p[kOIOpt])[lb0 + j] = inc;
    out_<float>(p[kOIThr])[lb0 + j] = inc;
    out_<float>(p[kOIMinDropped])[lb0 + j] = inf;
    out_<unsigned char>(p[kODone])[lb0 + j] = !(sm[lay.la + j] != 0.0f);
  }
  if (stored) bulk_wait_all();   // the frontier's stores read shared memory
}

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace goicp

static goicp::HarvestIo harvest_io(const unsigned long long* slots, int L,
                                   int C) {
  auto f = [slots](int k) {
    return reinterpret_cast<float*>(static_cast<uintptr_t>(slots[k]));
  };
  auto u8 = [slots](int k) {
    return reinterpret_cast<unsigned char*>(static_cast<uintptr_t>(slots[k]));
  };
  using namespace goicp;
  return HarvestIo{f(kHLbs),      f(kHRef),        f(kHMinDrop),
                   u8(kHDone),    f(kHLbIn),       f(kHUbErr),
                   f(kHBestNode), f(kHUbTerms),    u8(kHActive),
                   f(kHRLanes),   f(kHOptErr),     u8(kHConv),
                   f(kHOLbSafe),  f(kHOUbs),       f(kHOCandUb),
                   f(kHOIncumbent), f(kHOCandR),   f(kHOCandT),
                   f(kHOCandTerms), u8(kHOFlags),  L, C};
}

// Two modes.  The harvest of n rows (n_slots = kHSlots, ints = (L, C)):
// one launch of a block a row (in launches of at most kMaxRows).  The
// event head (n_slots = kHEventSlots, ints = (L, C, W, K, max_outer_steps,
// inner_max_iters, the global iterations for the words); rows and n
// unused): one launch of one block, which
// writes the served rows' harvest into rows 0 .. K - 1 of the outputs, the
// event's words and, where its slot is not null, fin0.
extern "C" int goicp_harvest(const unsigned long long* slots, int n_slots,
                             const int* ints, int n_ints, const int* rows,
                             int n, void* stream) {
  using namespace goicp;
  const bool event = n_slots == kHEventSlots;
  if ((n_slots != kHSlots && !event) || n_ints != (event ? 7 : 2) || n < 0)
    return invalid();
  const int L = ints[0], C = ints[1];
  if (L <= 0 || C <= 0 || L > 32 * 1024) return invalid();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HarvestIo io = harvest_io(slots, L, C);
  if (event) {
    EventParams ep{};
    ep.io = io;
    ep.ev = EventIo{
        reinterpret_cast<const unsigned char*>(slots[kHConv]),
        reinterpret_cast<const int*>(slots[kHIt]),
        reinterpret_cast<const unsigned char*>(slots[kHDone]),
        reinterpret_cast<const int*>(slots[kHInnerIt]),
        reinterpret_cast<unsigned char*>(slots[kHOFin0]),
        reinterpret_cast<int*>(slots[kHOWords]),
        ints[2], ints[3], ints[4], ints[5]};
    ep.n_iters = ints[6];
    const int W = ep.ev.W, K = ep.ev.K;
    if (W <= 0 || K <= 0 || K > W || ep.ev.conv == nullptr ||
        ep.ev.it == nullptr || ep.ev.inner_it == nullptr ||
        ep.ev.words == nullptr || io.lb_in != nullptr)
      return invalid();
    // the served rows' words, then the ubs of as many rows at a time as
    // fit 48 KB
    const int head = event_words(W, K);
    const int fit = (12 * 1024 - head) / L;
    if (fit < 1) return invalid();
    ep.cap = head + (K < fit ? K : fit) * L;
    event_kernel<<<1, kThreads, 4 * static_cast<size_t>(ep.cap), s>>>(ep);
    return static_cast<int>(cudaGetLastError());
  }
  if (4 * static_cast<size_t>(L) > 48 * 1024) return invalid();
  HarvestParams hp{};
  hp.io = io;
  for (int r0 = 0; r0 < n; r0 += kMaxRows) {
    const int m = n - r0 < kMaxRows ? n - r0 : kMaxRows;
    for (int k = 0; k < m; ++k) hp.rows[k] = rows[r0 + k];
    // the row-indexed outputs of this launch start at row r0
    HarvestParams h = hp;
    const size_t rL = static_cast<size_t>(r0) * L;
    h.io.lb_safe += rL;
    h.io.ubs += rL;
    h.io.cand_ub += r0;
    h.io.incumbent += r0;
    h.io.cand_R += 9 * static_cast<size_t>(r0);
    h.io.cand_t += 3 * static_cast<size_t>(r0);
    h.io.cand_terms += 3 * static_cast<size_t>(r0);
    h.io.flags += 2 * static_cast<size_t>(r0);
    harvest_kernel<<<m, kThreads, 4 * static_cast<size_t>(L), s>>>(h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// How many clusters of K advance blocks of `smem` bytes the card holds at
// once, asked once a shape.
static cudaError_t advance_clusters(int K, size_t smem, int* n) {
  struct Entry {
    int K;
    size_t smem;
    int n;
  };
  static Entry cache[16];
  static int used = 0;
  for (int e = 0; e < used; ++e)
    if (cache[e].K == K && cache[e].smem == smem) {
      *n = cache[e].n;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(goicp::kAdvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(n, goicp::advance_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 16) cache[used++] = Entry{K, smem, *n};
  return cudaSuccess;
}

// One launch of advance_kernel for n rows (in launches of at most
// kMaxRows): a cluster of min(8, L) blocks a row in pop and both modes,
// one block a row in adopt mode.  slots are the AdvanceSlot pointers, ints
// the AdvanceInt values, root the translation root (x, y, z, width),
// out_rows null: row k of the outputs is k.  cudaErrorInvalidValue for a
// frontier whose arrays do not fit a block's shared memory or (adopt and
// both modes) whose rows are not 16-byte aligned (the bulk copies' rule:
// Cr a multiple of 4 and the four frontier arrays 16-byte aligned),
// cudaErrorCooperativeLaunchTooLarge where not one cluster fits the card.
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
  if (ap.mode != kPop) {
    if (ap.Cr % 4 != 0) return invalid();
    const int frontier[4] = {kFrLbs, kFrNodes, kOFrLbs, kOFrNodes};
    for (int k : frontier)
      if (slots[k] % 16 != 0) return invalid();
  }
  ap.K = ap.mode == kAdopt ? 1 : (ap.L < 8 ? ap.L : 8);
  const int lanes_per_block = ap.L / ap.K;
  ChemParams& c = ap.chem;
  c.cell_compat = static_cast<const float*>(ap.p[kCellCompat]);
  c.prop_onehot = static_cast<const float*>(ap.p[kPropOnehot]);
  c.data_mask = static_cast<const float*>(ap.p[kDataMask]);
  c.nearest_cell = static_cast<const int*>(ap.p[kNearestCell]);
  c.consts = static_cast<const float*>(ap.p[kConsts]);
  c.C = ints[kNCells];
  c.n_vox = ints[kSize] * ints[kSize] * ints[kSize];

  // the shared memory: the row's and the lanes' regions, then what of
  // the data, the rotated points and K2's rows and tables fits
  ap.lay = advance_layout(ap.mode, ap.Cr, ap.Pr, ap.L, ap.Nd, lanes_per_block,
                          c.cell_compat != nullptr, c.n_vox, c.C);
  const size_t smem = 4 * ap.lay.words;
  if (smem > kMaxDynamicSmem) return invalid();
  static size_t granted = 0;
  cudaError_t err = allow_smem(advance_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = 0;
  err = advance_clusters(ap.K, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ap.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kAdvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
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
    cfg.gridDim = dim3(m * ap.K);
    if ((err = cudaLaunchKernelEx(&cfg, advance_kernel, a)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
