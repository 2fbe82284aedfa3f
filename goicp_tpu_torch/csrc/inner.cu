// The inner translation BnB (goicp_tpu_torch/search/inner.py) on the card,
// two entries over one lane body (inner_body.cuh):
//
//   goicp_inner_step: one whole iteration of the inner translation BnB
//     (search/inner.py::_make_inner_body) for a batch of lanes, in one
//     launch;
//   goicp_inner_run: the iterations themselves, in one launch, until the
//     search ends (the JAX package's lax.while_loops,
//     goicp_tpu/search/inner.py:207-220 and goicp_tpu/search/
//     fused_stream.py:322-382; search/inner.py::inner_run_plain is the
//     same loop in Python, a host read after every step).
//
// The JAX package leaves the iteration to XLA around its two Pallas
// kernels (goicp_tpu/search/inner.py::_make_inner_body, the bounds of
// goicp_tpu/bounds/pallas_eval.py :517/:632 and the counts of :702/:778);
// the port ran it as ~130 torch ops around K3 and K4.
//
// K blocks serve one lane (K3/K4 spread a lane over as many), reading its
// pair's tables through lane_pair (all lanes pair 0 when lane_pair is
// null: the one-pair engines).  An iteration of a lane
//   1. computes `done` from the frontier's min lb, the reference error
//      (thr fused, opt_err plain) and the pair's epsilon; a done lane, and
//      a lane of a group the caller marks not live, keeps its state (a
//      done lane with its flag set);
//   2. pops the P lowest-lb nodes (the frontier is sorted: a slice) with
//      their `expand` mask and builds the 8P children, their centres and
//      widths and the parents' lattice corners in shared memory;
//   3. evaluates, in each block, its K-th of the expanded parents'
//      children through the body of K1/K3 (geom_body.cuh; every mode:
//      fused or plain, norm 1/2, untrimmed, static K, dynamic K from
//      trim_count);
//   4. evaluates its K-th of the incompatibility counts at the parents'
//      lattice points through the body of K2/K4 (chem_body.cuh): the 19
//      new points of each parent with its 8 stored corners (corner
//      reuse), or all 27.
// One block then holds every block's bounds and counts (the step: the
// lane's last block to finish, through scratch in device memory and a
// per-lane ticket; the run: the cluster's rank 0, into whose shared
// memory the other blocks write them) and
//   4'. forms each child's max/min over its 8 corners and its terms;
//   5. adopts the first minimum of the children's ub (the first NaN if any,
//      as torch.argmin), updates opt_err, best_node, ub_terms and thr;
//   6. prunes against thr (fused) or opt_err;
//   7. merges the C - P remaining frontier entries with the 8P children,
//      keeping C and the corner payload, and folds the dropped entries'
//      finite minimum into min_dropped: the children are ranked among
//      themselves and each entry finds its rank in the other list by
//      binary search.  The precondition: the rest (entries P..C-1 of the
//      frontier) is in the merge's order below, as every merge leaves it
//      and every root is; the kernels do not check it (chip_smoke.py's
//      phase 2 and the tests hold their inputs to it);
//   8. counts its lane's evals and geometric survivors; the counters (it,
//      evals, geom_surv, chem_corners per group of lanes) and the lanes
//      left not done are formed once, by one block, so that no torch op
//      follows the launch.
// The step's tickets are the launch's own: L + 1 words behind its
// counters in o_stats, zeroed by the launcher on the launch's stream, so
// that launches on two streams, or one that was cut short, share no state.
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
//
// The run (goicp_inner_run) is one launch and nothing else: no memset, the
// launch leaves its sync words zero as it found them.  What bounds an
// iteration is its dependent chain, not bytes or operations, so:
//   * a lane is a thread-block cluster of its K <= 8 blocks.  A cluster
//     that holds one lane from the start of its search to the end (every
//     lane in modes search and groups; in mode stream where the card
//     holds a cluster a lane at once) keeps the lane's state (frontier,
//     lbs, corner payload, scalars) resident in the shared memory of each
//     of its blocks alike: it reads the caller's input once and writes set
//     A once, and each block stages the lane's points and its pair's
//     tables once, not once an iteration.  Each block pops and builds the
//     children and corners itself, evaluates its part, sends the part to
//     the other blocks (distributed shared memory; two copies of the
//     bounds used in turn, so that no block waits for the others to have
//     read the last), and after one cluster barrier adopts and merges as
//     the others do;
//   * a lane whose state stays in device memory (lanes striding in mode
//     stream; a capacity too large for shared memory, where the state
//     alternates between the lane's rows of set A and set B and ends in
//     A) is rank 0's: it pops, the other blocks read the children in its
//     shared memory and write their bounds into its arrays, two cluster
//     barriers an iteration, and rank 0 adopts and merges;
//   * modes search and groups: no grid barrier.  Lanes are independent (a
//     done lane's state is frozen), so each cluster iterates its lane
//     until the lane is done or its group's it reaches max_iters, then
//     takes the next lane from a work counter, never waiting on another
//     cluster.  Each lane records its steps, evals and survivors; the last
//     cluster to finish (a ticket) forms the counters from those records
//     (chem_corners with the staged compaction's width rule below);
//   * mode stream, whose stop rule joins the groups, agrees after every
//     iteration: each block adds one to an arrival count and, once every
//     block of the grid has arrived, reads the lanes' done iterations and
//     decides the stop itself; no block forms anything between
//     iterations.  When the lanes outnumber the clusters the card holds at
//     once they stride over the clusters, their state in device memory
//     alternating between the two output sets (iteration i reads set
//     (i - 1) % 2, the caller's input at i = 0, and writes set i % 2; a
//     lane that no longer steps is copied into each set once; after an
//     even number of iterations the lanes still differing are copied from
//     set B into set A);
//   * each of the four routes (a held lane or one in device memory; modes
//     search and groups, or stream) is a kernel of its own
//     (run_kernels), which the host picks, so that each holds its own
//     route's registers only.
// Three stop modes, each the torch loop it replaces iteration for
// iteration (search/inner.py::inner_run_plain):
//   search (inner_bnb): while a lane is not done and it < max_iters; one
//     group; chem_corners adds corners_per_lane x the width of the stage
//     the staged compaction would be in (L; stage_w1 once the lanes not
//     done before the iteration are <= stage_w1; stage_w2 once <=
//     stage_w2), the compaction itself being no-op on every lane;
//   groups (the batch engine): while some group is live, a group live
//     until all its lanes are done or its `it` reaches max_iters;
//   stream (the fused stream's global iterations between transitions):
//     the groups `live` says, at least one iteration, until a `watch`ed
//     group's search is complete (all done or it >= max_iters) or `steps`
//     iterations ran, or after one iteration where `once` is set (the
//     stream's rows all finished, or eager's row newly finished).
// An iteration counts only the groups that step in it.
#include <climits>
#include <cooperative_groups.h>

#include "inner_body.cuh"

namespace goicp {

namespace cg = cooperative_groups;

// Sum and maximum over the block, every thread gets it.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int s[kStepWarps];
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s[w];
  return total;
}

__device__ __forceinline__ int block_max(int v) {
  __shared__ int s[kStepWarps];
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = s[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    m = max(m, s[w]);
  return m;
}

// The chem body's sources behind the geometric body's region (with copy,
// the copies started), its points and nearest-cell table read from the latter's
// where it staged them.
__device__ __forceinline__ ChemSrc stage_chem(const StepParams& p, int lane,
                                              int pair, unsigned char* body,
                                              const GeomSrc& gs, bool copy) {
  if (p.chem.cell_compat == nullptr) return ChemSrc{};
  return chem_stage(p.chem, lane, pair,
                    body + 4 * static_cast<size_t>(p.geom_words), copy,
                    p.geom.stage_points ? gs.pts : nullptr,
                    p.geom.stage_tables ? gs.table : nullptr, gs.consts);
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStepWarps * 32, 2)
    inner_step_kernel(StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lane_last, s_last;

  const int lane = blockIdx.x / p.blocks_per_lane;
  const int part = blockIdx.x % p.blocks_per_lane;
  const int t = threadIdx.x, nt = blockDim.x;
  const int B = 8 * p.pop;
  const int Q = p.chem.cell_compat != nullptr
                    ? (p.reuse ? 19 : 27) * p.pop : 0;
  const bool live = p.live == nullptr || p.live[lane / p.group] != 0;
  const int pair = p.lane_pair != nullptr ? p.lane_pair[lane] : 0;
  const float sse = p.sse[pair];
  const StepArrays a = step_arrays(p, smem);
  if (!live || lane_done<false>(p, p.in, lane, sse)) {
    // the lane's state as it was (a done lane's done is now set)
    if (part == 0) {
      copy_lane(p, p.in, p.out, lane,
                live || __ldcg(p.in.done + lane) != 0);
      if (t == 0) p.o_stats[lane] = p.o_stats[p.L + lane] = 0;
    }
  } else {
    unsigned char* body = smem + 4 * static_cast<size_t>(p.step_words);
    const GeomSrc gs = geom_stage(p.geom, lane, pair, body, true);
    const ChemSrc cs = stage_chem(p, lane, pair, body, gs, true);
    lane_head<false>(p, p.in, lane, sse, a);
    const int nexp = a.misc()[0];
    float* sc = p.scratch + static_cast<size_t>(lane) * (3 * B + Q);
    lane_bounds(p, lane, pair, part, nexp, gs, cs, a.cen(), a.wid(), a.corner(),
                sc, sc + B, sc + 2 * B, sc + 3 * B);
    async_wait<0>();
    // the last of the lane's blocks to finish goes on with the lane
    __threadfence();
    __syncthreads();
    if (t == 0)
      s_lane_last =
          atomicAdd(&p.tickets[lane], 1u) == p.blocks_per_lane - 1u;
    __syncthreads();
    if (s_lane_last) {
      __threadfence();
      for (int i = t; i < 8 * nexp; i += nt) {
        a.ub()[i] = __ldcg(sc + i);
        a.lb()[i] = __ldcg(sc + 2 * B + i);
        if (p.geom.fused) a.ubu()[i] = __ldcg(sc + B + i);
      }
      for (int i = t; i < Q; i += nt) a.count()[i] = __ldcg(sc + 3 * B + i);
      __syncthreads();
      lane_tail<false>(p, p.in, p.out, lane, a);
      if (t == 0) {
        p.o_stats[lane] = 8 * nexp;
        p.o_stats[p.L + lane] = a.misc()[1];
      }
    }
  }

  // ---- 8. the counters, by the last block to finish ----
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&p.tickets[p.L], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile int* stats = p.o_stats;
  const volatile unsigned char* o_done = p.out.done;
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
      cnt[k * groups + g] =
          (p.cnt_in[k] != nullptr ? p.cnt_in[k][g] : 0) + add[k];
  }
  int active = 0;
  for (int l = t; l < p.L; l += nt) active += o_done[l] == 0;
  active = block_sum(active);
  if (t == 0) cnt[4 * groups] = active;
}

// ---------------------------------------------------------------------------
// the run
// ---------------------------------------------------------------------------

enum RunMode { kSearch = 0, kGroups = 1, kStream = 2 };

// the run's sync words, zero at the launch's start and left zero at its
// end: the work counter, the finish ticket, the stream's arrivals
enum SyncWord { kWork = 0, kTicket = 1, kArrive = 2 };

// an agreement that waits this long has lost a block: end the launch
// with an error instead of spinning on
constexpr unsigned long long kSpinLimitNs = 10ull * 1000 * 1000 * 1000;

struct RunParams {
  StepParams step;           // the tables, the input set (step.in), set A
                             // (step.out), cnt_in
  LaneOut set_b;             // the second output set
  const unsigned char* live;   // stream: (groups,) the groups that step
  const unsigned char* watch;  // stream: (groups,) the groups whose
                               // complete search ends the run (null: all)
  const unsigned char* once;   // stream: () set: one iteration (null: 0)
  int* cnt;                  // (4, groups) it, evals, geom_surv,
                             // chem_corners after the run
  int* info;                 // [0] iterations run, [1] lanes not done,
                             // [2] the grid's clusters, [3] the lanes
                             // whose state stayed in shared memory
  unsigned int* sync;        // SyncWord
  // (L,) each, written by the lane's cluster: the copies of a lane that
  // no longer steps (stream, state in device memory), its evals and
  // geometric survivors, its steps (search, groups), the iteration whose
  // step found it done (stream; -1 done before, INT_MAX not done)
  int *frozen, *lane_ev, *lane_su, *lane_steps, *done_at;
  int mode, max_iters, steps, stage_w1, stage_w2;
  int resident;              // a held lane's state in rank 0's shared
                             // memory (state_words behind the step's)
  int state_words;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A held lane's state in rank 0's shared memory: two frontier buffers
// (nodes, lbs, corner payload) used in turn, one set of scalars (opt_err,
// thr, best_node, ub_terms, min_dropped, done), each buffer's fields
// found when it is used.
struct Resident {
  float* s;
  int C, reuse;
  __device__ __forceinline__ LaneOut buf(int b) const {
    const int per = (5 + (reuse ? 8 : 0)) * C;
    float* f = s + b * per;
    float* sc = s + 2 * per;
    return LaneOut{f, f + 4 * C, reuse ? f + 5 * C : nullptr, sc, sc + 1,
                   sc + 2, sc + 6, sc + 9,
                   reinterpret_cast<unsigned char*>(sc + 10)};
  }
};

__host__ __device__ __forceinline__ size_t resident_words(int C,
                                                          bool reuse) {
  return region_words(2 * static_cast<size_t>(5 + (reuse ? 8 : 0)) * C +
                      11);
}

__device__ __forceinline__ Resident resident_state(const StepParams& p,
                                                   unsigned char* smem) {
  return Resident{reinterpret_cast<float*>(
                      smem + 4 * static_cast<size_t>(p.step_words)),
                  p.cap, p.reuse};
}

// The lane's input into buffer 0 (the frontier by asynchronous copies,
// complete after async_wait<0> and a barrier), by rank 0.
__device__ __forceinline__ void load_lane(const StepParams& p,
                                          const Resident& st, int lane) {
  const int t = threadIdx.x, C = p.cap;
  const size_t lc = static_cast<size_t>(lane) * C;
  const LaneOut& b = st.buf(0);
  async_copy_words(b.nodes, p.in.nodes + 4 * lc, 4 * C);
  async_copy_words(b.lbs, p.in.lbs + lc, C);
  if (p.reuse) async_copy_words(b.cvals, p.in.cvals + 8 * lc, 8 * C);
  async_commit();
  if (t < 4) b.best_node[t] = __ldcg(p.in.best_node + 4 * lane + t);
  if (t < 3) b.ub_terms[t] = __ldcg(p.in.ub_terms + 3 * lane + t);
  if (t == 0) {
    b.opt_err[0] = __ldcg(p.in.opt_err + lane);
    b.thr[0] = __ldcg(p.in.thr + lane);
    b.min_dropped[0] = __ldcg(p.in.min_dropped + lane);
    b.done[0] = __ldcg(p.in.done + lane);
  }
}

// The state in buffer `cur` into set A at the lane's index, by rank 0.
__device__ __forceinline__ void store_lane(const StepParams& p,
                                           const Resident& st, int cur,
                                           int lane) {
  const int t = threadIdx.x, nt = blockDim.x, C = p.cap;
  const size_t lc = static_cast<size_t>(lane) * C;
  const LaneOut& b = st.buf(cur);
  const LaneOut& o = p.out;
  __syncthreads();
  for (int i = t; i < 4 * C; i += nt) o.nodes[4 * lc + i] = b.nodes[i];
  for (int i = t; i < C; i += nt) o.lbs[lc + i] = b.lbs[i];
  if (p.reuse)
    for (int i = t; i < 8 * C; i += nt) o.cvals[8 * lc + i] = b.cvals[i];
  if (t < 4) o.best_node[4 * lane + t] = b.best_node[t];
  if (t < 3) o.ub_terms[3 * lane + t] = b.ub_terms[t];
  if (t == 0) {
    o.opt_err[lane] = b.opt_err[0];
    o.thr[lane] = b.thr[0];
    o.min_dropped[lane] = b.min_dropped[0];
    o.done[lane] = b.done[0];
  }
}

// Rank 0 sets word `idx` of every block's misc to v (thread k the k-th
// block's); the others read it after the next cluster barrier.
__device__ __forceinline__ void push(cg::cluster_group& cluster,
                                     const StepArrays& a, int idx, int v) {
  if (threadIdx.x < cluster.num_blocks())
    cluster.map_shared_rank(a.misc(), threadIdx.x)[idx] = v;
}

// Where the bodies read the lane's data: their regions, the copies into
// them started with copy (complete after async_wait<0> and a barrier).
struct LaneSrc {
  GeomSrc g;
  ChemSrc c;
};

__device__ __forceinline__ LaneSrc stage_lane(const StepParams& p, int lane,
                                              int pair, unsigned char* body,
                                              bool copy) {
  const GeomSrc gs = geom_stage(p.geom, lane, pair, body, copy);
  return LaneSrc{gs, stage_chem(p, lane, pair, body, gs, copy)};
}

// ---- a held lane: every block of the cluster keeps its state ----

// One iteration of a held lane that steps.  Every block keeps the lane's
// state alike (Resident, buffer cur): it pops and builds the children and
// corners itself, evaluates its part of them into copy a.par of its
// bounds, sends that part to every other block, and after one cluster
// barrier adopts and merges as the others do, into buffer cur ^ 1.  The
// whole cluster.
__device__ __forceinline__ void held_iteration(cg::cluster_group& cluster,
                                               const StepParams& p,
                                               const StepArrays& a,
                                               const Resident& st, int cur,
                                               int lane, int pair, float sse,
                                               int part, unsigned char* body) {
  const LaneIn in = as_input(st.buf(cur));
  lane_head<true>(p, in, 0, sse, a);
#if GOICP_INNER_STOP >= 3
  const LaneSrc src = stage_lane(p, lane, pair, body, false);
  lane_bounds(p, lane, pair, part, a.misc()[0], src.g, src.c, a.cen(),
              a.wid(), a.corner(), a.ub(), a.ubu(), a.lb(), a.count());
#endif
#if GOICP_INNER_STOP >= 6
  // this block's part into every other block's copy
  const Parts pr = parts(p, part, a.misc()[0]);
  const int n = pr.n1 - pr.n0, m = 3 * n + (pr.q1 - pr.q0);
  const int K = static_cast<int>(cluster.num_blocks());
  __syncthreads();
  for (int i = threadIdx.x; i < (K - 1) * m; i += blockDim.x) {
    const int j = i % m;
    const unsigned peer = (part + 1 + i / m) % K;
    float* arr = j < n ? a.ub() : (j < 2 * n ? a.ubu()
                                   : (j < 3 * n ? a.lb() : a.count()));
    const int at = j < 3 * n ? pr.n0 + j % n : pr.q0 + j - 3 * n;
    cluster.map_shared_rank(arr, peer)[at] = arr[at];
  }
  cluster.sync();
#endif
#if GOICP_INNER_STOP >= 7
  lane_tail<true>(p, in, st.buf(cur ^ 1), 0, a);
#endif
}

// Modes search and groups, each lane's state held in its cluster: each
// cluster iterates a lane until it is done or its group's it reaches
// max_iters, then takes the next lane from the work counter.
__device__ void run_lanes_held(const RunParams& r,
                               cg::cluster_group& cluster, StepArrays a,
                               unsigned char* smem, unsigned char* body,
                               int part, int cid, int n_clusters) {
  __shared__ int s_next;
  const StepParams& p = r.step;
  const int t = threadIdx.x;
  const Resident st = resident_state(p, smem);
  int lane = cid;
  while (lane < p.L) {
    const int pair = p.lane_pair != nullptr ? p.lane_pair[lane] : 0;
    const float sse = p.sse[pair];
    // the steps this lane may make: its group's it up to max_iters
    const int cap =
        r.max_iters - (r.mode == kGroups && p.cnt_in[0] != nullptr
                           ? p.cnt_in[0][lane / p.group] : 0);
    stage_lane(p, lane, pair, body, true);
    load_lane(p, st, lane);
    async_wait<0>();
    __syncthreads();
    int steps = 0, ev = 0, su = 0, cur = 0;
    for (; steps < cap && st.buf(0).done[0] == 0; ++steps) {
      if (lane_done<true>(p, as_input(st.buf(cur)), 0, sse)) {
        // the step that finds the lane done: its flag set
        __syncthreads();
        if (t == 0) st.buf(0).done[0] = 1;
        ++steps;
        break;
      }
      a.par = steps & 1;
      held_iteration(cluster, p, a, st, cur, lane, pair, sse, part, body);
      ev += 8 * a.misc()[0];
      su += a.misc()[1];
#if GOICP_INNER_STOP >= 8
      cur ^= 1;   // the merge's output (a probe stopped before the merge
                  // iterates on its input)
#endif
    }
    if (part == 0) {
      store_lane(p, st, cur, lane);
      if (t == 0) {
        r.lane_ev[lane] = ev;
        r.lane_su[lane] = su;
        r.lane_steps[lane] = steps;
        s_next = n_clusters +
                 static_cast<int>(atomicAdd(r.sync + kWork, 1u));
      }
      __syncthreads();
      push(cluster, a, 4, s_next);
    }
    cluster.sync();
    lane = a.misc()[4];
  }
}

// Mode stream: after iteration i, every block arrives, waits for the
// grid, and decides from the lanes' done iterations whether the run
// stops there (the same answer in every block).
__device__ bool run_agree(const RunParams& r, int i) {
#if GOICP_INNER_STOP < 99
  return i + 1 >= r.steps;
#else
  const StepParams& p = r.step;
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    atomicAdd(r.sync + kArrive, 1u);
    const unsigned target = gridDim.x * static_cast<unsigned>(i + 1);
    const volatile unsigned* arrived = r.sync + kArrive;
    const unsigned long long t0 = global_ns();
    while (*arrived < target) {
      if (global_ns() - t0 > kSpinLimitNs) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  const int n = i + 1, groups = p.L / p.group;
  int due = 0;
  for (int g = t; g < groups; g += nt) {
    const bool lv = r.live == nullptr || r.live[g] != 0;
    const int it = (p.cnt_in[0] != nullptr ? p.cnt_in[0][g] : 0) +
                   (lv ? n : 0);
    bool all_done = true;
    for (int l = g * p.group; l < (g + 1) * p.group; ++l)
      all_done = all_done && __ldcg(r.done_at + l) < n;
    due |= (all_done || it >= r.max_iters) &&
           (r.watch == nullptr || r.watch[g] != 0);
  }
  due = __syncthreads_or(due);
  return due || n >= r.steps || (r.once != nullptr && r.once[0] != 0);
#endif
}

// Mode stream, one lane a cluster (L <= the clusters), its state held in
// the cluster; -> the iterations the run made.
__device__ int run_stream_held(const RunParams& r,
                               cg::cluster_group& cluster, StepArrays a,
                               unsigned char* smem, unsigned char* body,
                               int part, int lane) {
  const StepParams& p = r.step;
  const int t = threadIdx.x;
  const Resident st = resident_state(p, smem);
  const int pair = p.lane_pair != nullptr ? p.lane_pair[lane] : 0;
  const float sse = p.sse[pair];
  const bool live = r.live == nullptr || r.live[lane / p.group] != 0;
  if (part == 0 && t == 0)
    r.done_at[lane] = __ldcg(p.in.done + lane) != 0 ? -1 : INT_MAX;
  stage_lane(p, lane, pair, body, true);
  load_lane(p, st, lane);
  async_wait<0>();
  __syncthreads();
  int ev = 0, su = 0, cur = 0, i = 0;
  for (;; ++i) {
    if (live && st.buf(0).done[0] == 0) {
      if (lane_done<true>(p, as_input(st.buf(cur)), 0, sse)) {
        __syncthreads();
        if (t == 0) {
          st.buf(0).done[0] = 1;
          if (part == 0) r.done_at[lane] = i;
        }
      } else {
        a.par = i & 1;
        held_iteration(cluster, p, a, st, cur, lane, pair, sse, part, body);
        ev += 8 * a.misc()[0];
        su += a.misc()[1];
#if GOICP_INNER_STOP >= 8
        cur ^= 1;
#endif
      }
    }
    if (run_agree(r, i)) break;
  }
  if (part == 0) {
    store_lane(p, st, cur, lane);
    if (t == 0) {
      r.lane_ev[lane] = ev;
      r.lane_su[lane] = su;
    }
  }
  return i + 1;
}

// ---- lanes whose state stays in device memory ----

// The lane's go (misc word 3) and expanded parents (word 0) from rank 0 to
// every block and a cluster barrier; then, where the lane steps, the
// bounds of each block's part into rank 0's arrays and a second barrier.
// staged: the lane's data is in the bodies' regions already (a held
// lane), else it is staged now (a striding lane).  -> whether the lane
// steps.
__device__ __forceinline__ bool cluster_bounds(cg::cluster_group& cluster,
                                               const StepParams& p,
                                               const StepArrays& a,
                                               int lane, int pair, int part,
                                               int go, bool staged,
                                               unsigned char* body) {
  if (part == 0) {
    push(cluster, a, 3, go);
    push(cluster, a, 0, a.misc()[0]);
  }
  cluster.sync();
  if (!a.misc()[3]) return false;
#if GOICP_INNER_STOP >= 3
  const LaneSrc src = stage_lane(p, lane, pair, body, !staged);
  lane_bounds(p, lane, pair, part, a.misc()[0], src.g, src.c,
              cluster.map_shared_rank(a.cen(), 0),
              cluster.map_shared_rank(a.wid(), 0),
              cluster.map_shared_rank(a.corner(), 0),
              cluster.map_shared_rank(a.ub(), 0),
              cluster.map_shared_rank(a.ubu(), 0),
              cluster.map_shared_rank(a.lb(), 0),
              cluster.map_shared_rank(a.count(), 0));
  async_wait<0>();             // a part with no work staged all the same
  cluster.sync();
#endif
  return true;
}

// Modes search and groups, the lanes' state in device memory (too large
// for shared memory): each cluster iterates a lane to its end, its state
// alternating between its rows of set A and set B and ending in A, then
// takes the next from the work counter.  Rank 0 pops, adopts and merges.
__device__ void run_lanes_global(const RunParams& r,
                                 cg::cluster_group& cluster,
                                 const StepArrays& a, unsigned char* body,
                                 int part, int cid, int n_clusters) {
  __shared__ int s_next;
  const StepParams& p = r.step;
  const int t = threadIdx.x;
  int lane = cid;
  while (lane < p.L) {
    const int pair = p.lane_pair != nullptr ? p.lane_pair[lane] : 0;
    const int cap =
        r.max_iters - (r.mode == kGroups && p.cnt_in[0] != nullptr
                           ? p.cnt_in[0][lane / p.group] : 0);
    stage_lane(p, lane, pair, body, true);
    async_wait<0>();
    __syncthreads();
    int steps = 0, ev = 0, su = 0;
    for (;; ++steps) {
      // step j reads set (j - 1) % 2 (the input at j = 0), writes j % 2
      const LaneIn in = steps == 0 ? p.in
                                   : as_input(steps % 2 == 1 ? p.out
                                                             : r.set_b);
      const LaneOut out = steps % 2 == 0 ? p.out : r.set_b;
      int go = 0;
      if (part == 0 && steps < cap && __ldcg(in.done + lane) == 0) {
        if (lane_done<false>(p, in, lane, p.sse[pair])) {
          copy_lane(p, in, out, lane, true);
          ++steps;
        } else {
          lane_head<false>(p, in, lane, p.sse[pair], a);
          go = 1;
        }
      }
      if (!cluster_bounds(cluster, p, a, lane, pair, part, go, true, body))
        break;
#if GOICP_INNER_STOP >= 7
      if (part == 0) {
        lane_tail<false>(p, in, out, lane, a);
        ev += 8 * a.misc()[0];
        su += a.misc()[1];
      }
#endif
    }
    if (part == 0) {
      if (steps % 2 == 0) {
        const LaneIn src = steps == 0 ? p.in : as_input(r.set_b);
        copy_lane(p, src, p.out, lane, __ldcg(src.done + lane) != 0);
      }
      if (t == 0) {
        r.lane_ev[lane] = ev;
        r.lane_su[lane] = su;
        r.lane_steps[lane] = steps;
        s_next = n_clusters +
                 static_cast<int>(atomicAdd(r.sync + kWork, 1u));
      }
      __syncthreads();
      push(cluster, a, 4, s_next);
    }
    cluster.sync();
    lane = a.misc()[4];
  }
}

// Mode stream, a lane's iteration i with its state in device memory, by
// rank 0: pop the lane where it steps, else copy it (once into each set);
// -> whether it steps.
__device__ __forceinline__ int stream_head_global(const RunParams& r,
                                                  const StepArrays& a,
                                                  const LaneIn& in,
                                                  const LaneOut& out,
                                                  int lane, int pair, int i) {
  const StepParams& p = r.step;
  const int t = threadIdx.x;
  const bool live = r.live == nullptr || r.live[lane / p.group] != 0;
  const bool done_in = __ldcg(in.done + lane) != 0;
  const float sse = p.sse[pair];
  if (live && !lane_done<false>(p, in, lane, sse)) {
    lane_head<false>(p, in, lane, sse, a);
    return 1;
  }
  if (t == 0 && live && !done_in) r.done_at[lane] = i;
  const int copies = r.frozen[lane];
  __syncthreads();
  if (copies < 2) {
    if (t == 0) r.frozen[lane] = copies + 1;
    copy_lane(p, in, out, lane, live || done_in);
  }
  return 0;
}

// Mode stream, the lanes' state in device memory (more lanes than
// clusters, or a state too large for shared memory): each cluster strides
// over its lanes every iteration; -> the iterations the run made.
__device__ int run_stream_global(const RunParams& r,
                                 cg::cluster_group& cluster,
                                 const StepArrays& a, unsigned char* body,
                                 int part, int cid, int n_clusters) {
  const StepParams& p = r.step;
  const int t = threadIdx.x;
  const bool held = n_clusters >= p.L;
  if (part == 0 && t == 0)
    for (int l = cid; l < p.L; l += n_clusters) {
      r.done_at[l] = __ldcg(p.in.done + l) != 0 ? -1 : INT_MAX;
      r.lane_ev[l] = r.lane_su[l] = r.frozen[l] = 0;
    }
  if (held) {
    stage_lane(p, cid, p.lane_pair != nullptr ? p.lane_pair[cid] : 0, body,
               true);
    async_wait<0>();
    __syncthreads();
  }
  int i = 0;
  for (;; ++i) {
    const LaneIn in = i == 0 ? p.in : as_input(i % 2 == 1 ? p.out : r.set_b);
    const LaneOut out = i % 2 == 0 ? p.out : r.set_b;
    for (int lane = cid; lane < p.L; lane += n_clusters) {
      const int pair = p.lane_pair != nullptr ? p.lane_pair[lane] : 0;
      const int go = part == 0
                         ? stream_head_global(r, a, in, out, lane, pair, i)
                         : 0;
      if (!cluster_bounds(cluster, p, a, lane, pair, part, go, held, body))
        continue;
#if GOICP_INNER_STOP >= 7
      if (part == 0) {
        lane_tail<false>(p, in, out, lane, a);
        if (t == 0) {
          r.lane_ev[lane] += 8 * a.misc()[0];
          r.lane_su[lane] += a.misc()[1];
        }
      }
#endif
    }
    if (run_agree(r, i)) break;
  }
  const int n = i + 1;
  if (part == 0 && n % 2 == 0)
    // the result into set A: set B's lanes that still differ
    for (int lane = cid; lane < p.L; lane += n_clusters)
      if (r.frozen[lane] < 2)
        copy_lane(p, as_input(r.set_b), p.out, lane,
                  __ldcg(r.set_b.done + lane) != 0);
  return n;
}

// The iterations of a search of `it` whose stage is wider than w: those
// before the lanes not done at their start fall to w or fewer.  From
// each lane's last iteration last(l) (its steps - 1 where it ended done,
// so -1 done from the start; it - 1 where it ran to max_iters): the
// largest last(m) + 1 with more than w lanes' last(l) >= last(m), 0 if
// none.  The whole block.
template <typename Last>
__device__ int stage_iterations(Last last, int L, int w) {
  int best = 0;
  for (int m = threadIdx.x; m < L; m += blockDim.x) {
    const int em = last(m);
    int c = 0;
    for (int l = 0; l < L; ++l) c += last(l) >= em;
    if (c > w) best = max(best, em + 1);
  }
  return block_max(best);
}

// The counters and info from the lanes' records, by the rank 0 of the
// last cluster to finish (a ticket), which then zeroes the sync words.
// scratch: the block's shared arrays, free by now (scratch_words).
__device__ void run_finish(const RunParams& r, int n, int n_clusters,
                           int* scratch, int scratch_words) {
  __shared__ int s_last;
  const StepParams& p = r.step;
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(r.sync + kTicket, 1u) ==
             static_cast<unsigned>(n_clusters - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int L = p.L, G = p.group, groups = L / G;
  const int Q = p.chem.cell_compat != nullptr
                    ? (p.reuse ? 19 : 27) * p.pop : 0;
  auto put = [&](int g, int S, int ev, int su) {
    const int add[4] = {S, ev, su, S * G * Q};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.cnt[k * groups + g] =
          (p.cnt_in[k] != nullptr ? p.cnt_in[k][g] : 0) + add[k];
  };
  int it = 0;
  if (groups == 1) {
    // one group (search): its lanes' records summed by the whole block
    int ev = 0, su = 0, smax = 0;
    for (int l = t; l < L; l += nt) {
      ev += __ldcg(r.lane_ev + l);
      su += __ldcg(r.lane_su + l);
      if (r.mode != kStream) smax = max(smax, __ldcg(r.lane_steps + l));
    }
    ev = block_sum(ev);
    su = block_sum(su);
    it = r.mode == kStream ? (r.live == nullptr || r.live[0] ? n : 0)
                           : block_max(smax);
    if (t == 0) put(0, it, ev, su);
  } else {
    for (int g = t; g < groups; g += nt) {
      int ev = 0, su = 0, smax = 0;
      for (int l = g * G; l < (g + 1) * G; ++l) {
        ev += __ldcg(r.lane_ev + l);
        su += __ldcg(r.lane_su + l);
        if (r.mode != kStream) smax = max(smax, __ldcg(r.lane_steps + l));
      }
      const bool lv = r.live == nullptr || r.live[g] != 0;
      const int S = r.mode == kStream ? (lv ? n : 0) : smax;
      put(g, S, ev, su);
      it = max(it, S);
    }
    it = block_max(it);
  }
  if (r.mode == kSearch) {
    // chem_corners by the width of each iteration's stage, from each
    // lane's last iteration (in shared memory where it fits)
    auto last_global = [&](int l) {
      return __ldcg(p.out.done + l) != 0 ? __ldcg(r.lane_steps + l) - 1
                                         : it - 1;
    };
    const bool staged = L <= scratch_words;
    if (staged)
      for (int l = t; l < L; l += nt) scratch[l] = last_global(l);
    __syncthreads();
    auto last = [&](int l) { return staged ? scratch[l] : last_global(l); };
    const int w1 = r.stage_w1, w2 = r.stage_w2;
    const int t1 = w1 > 0 ? stage_iterations(last, L, w1) : it;
    const int t2 = w2 > 0 ? stage_iterations(last, L, w2) : it;
    if (t == 0)
      r.cnt[3] = (p.cnt_in[3] != nullptr ? p.cnt_in[3][0] : 0) +
                 Q * (L * t1 + w1 * (t2 - t1) + w2 * (it - t2));
  }
  int active = 0;
  for (int l = t; l < L; l += nt) active += __ldcg(p.out.done + l) == 0;
  active = block_sum(active);
  if (t == 0) {
    r.info[0] = r.mode == kStream ? n : it;
    r.info[1] = active;
    r.info[2] = n_clusters;
    r.info[3] = r.resident ? L : 0;
    r.sync[kWork] = 0;
    r.sync[kTicket] = 0;
    r.sync[kArrive] = 0;
  }
}

// the run's four routes, each a kernel of its own (the host picks one)
enum RunRoute { kLanesHeld = 0, kStreamHeld = 1, kLanesGlobal = 2,
                kStreamGlobal = 3 };

template <int kRoute>
__global__ void __launch_bounds__(kStepWarps * 32, 2)
    inner_run_kernel(const __grid_constant__ RunParams r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StepParams& p = r.step;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.blocks_per_lane;               // the cluster's size
  const int part = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / K, n_clusters = gridDim.x / K;
  const StepArrays a = step_arrays(p, smem);
  unsigned char* body =
      smem + 4 * static_cast<size_t>(p.step_words + r.state_words);
  int n = 0;
  if constexpr (kRoute == kStreamHeld)
    n = run_stream_held(r, cluster, a, smem, body, part, cid);
  else if constexpr (kRoute == kLanesHeld)
    run_lanes_held(r, cluster, a, smem, body, part, cid, n_clusters);
  else if constexpr (kRoute == kStreamGlobal)
    n = run_stream_global(r, cluster, a, body, part, cid, n_clusters);
  else
    run_lanes_global(r, cluster, a, body, part, cid, n_clusters);
  if (part == 0)
    run_finish(r, n, n_clusters, reinterpret_cast<int*>(smem), p.step_words);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// the run's kernels by route
static void (*const run_kernels[4])(RunParams) = {
    inner_run_kernel<kLanesHeld>, inner_run_kernel<kStreamHeld>,
    inner_run_kernel<kLanesGlobal>, inner_run_kernel<kStreamGlobal>};

// dynamic shared memory a block may take with two blocks on an SM
constexpr size_t kTwoPerSm = 112 * 1024;

// The parameters both entries share, and their launch plan: kStepWarps
// warps a block (fewer when the trimmed rows' scratch of that many warps
// would not fit), the step's own arrays first in shared memory, then (the
// run, where it fits) the resident lane state, then the bodies' regions,
// the geometric body's first, the chem body's behind it reading the
// lane's points and the pair's nearest-cell table from the former's
// staging.  Everything is staged where it fits two blocks an SM, else
// where it fits one, else, in that order, what fits; a lane over as many
// blocks as give each warp about one child (at most 8, K3's spread).  Any
// pop and capacity whose arrays fit a block's shared memory;
// cudaErrorInvalidValue for shapes that do not.
static cudaError_t plan_step(
    goicp::StepParams& p, const float* pts, const float* rot_unc,
    const float* weights, const int* cells, const int* nearest_cell,
    const float* consts, const float* trim_count, const float* cell_compat,
    const float* prop_onehot, const float* data_mask, const int* lane_pair,
    const float* sse, int L, int cap, int pop, int group, int Nd,
    int n_cells, int size, int norm, int fused, int trim_k, int reuse,
    int sorted_merge, float reg, bool run, int* warps_out,
    size_t* words_out, int* state_words_out) {
  using namespace goicp;
  if (L <= 0 || pop <= 0 || cap <= pop || group <= 0 || L % group != 0)
    return cudaErrorInvalidValue;
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
  p.L = L;
  p.cap = cap;
  p.pop = pop;
  p.group = group;
  p.reuse = reuse && cell_compat != nullptr;
  p.sorted_merge = sorted_merge;
  p.reg = reg;

  const int B = 8 * pop;
  const int Q = cell_compat != nullptr ? (reuse ? 19 : 27) * pop : 0;
  const size_t words_max = kMaxDynamicSmem / 4;
  const size_t step_words = region_words(step_array_words(pop, cap, Q));
  if (step_words >= words_max) return cudaErrorInvalidValue;
  p.step_words = static_cast<int>(step_words);
  size_t state = run ? resident_words(cap, p.reuse != 0) : 0;
  if (step_words + state >= words_max) state = 0;
  int warps = kStepWarps;
  while (warps > 1 &&
         step_words + state + geom_rows_words(g, warps) > words_max)
    warps >>= 1;
  const size_t rows = geom_rows_words(g, warps);
  if (step_words + state + rows > words_max) {
    if (state == 0) return cudaErrorInvalidValue;
    state = 0;                     // the state in device memory instead
  }
  const size_t fixed = step_words + state + rows;
  const bool chem = cell_compat != nullptr;
  const size_t all = fixed + geom_points_words(g) + geom_tables_words(g) +
                     (chem ? chem_points_words(c, true) +
                                 chem_tables_words(c, true)
                           : 0);
  size_t avail = (all <= kTwoPerSm / 4 ? kTwoPerSm / 4 : words_max) - fixed;
  auto take = [&avail](size_t w) {
    if (w > avail) return 0;
    avail -= w;
    return 1;
  };
  size_t gw = rows;
  if ((g.stage_points = take(geom_points_words(g))))
    gw += geom_points_words(g);
  if ((g.stage_tables = take(geom_tables_words(g))))
    gw += geom_tables_words(g);
  size_t cw = 0;
  if (chem) {
    const size_t pts_w = chem_points_words(c, g.stage_points != 0);
    const size_t tab_w = chem_tables_words(c, g.stage_tables != 0);
    if ((c.stage_points = take(pts_w))) cw += pts_w;
    if ((c.stage_tables = take(tab_w))) cw += tab_w;
  }
  p.geom_words = static_cast<int>(gw);
  *words_out = step_words + state + gw + cw;
  *state_words_out = static_cast<int>(state);
  *warps_out = warps;
  p.blocks_per_lane = (B + warps - 1) / warps;
  if (p.blocks_per_lane > 8) p.blocks_per_lane = 8;
  return cudaSuccess;
}

static goicp::LaneIn lane_in(const float* nodes, const float* lbs,
                             const float* cvals, const float* opt_err,
                             const float* thr, const float* best_node,
                             const float* ub_terms, const float* min_dropped,
                             const unsigned char* done) {
  return goicp::LaneIn{nodes, lbs, cvals, opt_err, thr, best_node, ub_terms,
                       min_dropped, done};
}

static goicp::LaneOut lane_out(float* nodes, float* lbs, float* cvals,
                               float* opt_err, float* thr, float* best_node,
                               float* ub_terms, float* min_dropped,
                               unsigned char* done) {
  return goicp::LaneOut{nodes, lbs, cvals, opt_err, thr, best_node, ub_terms,
                        min_dropped, done};
}

}  // namespace goicp

// One launch, after zeroing its tickets (o_stats' last L + 1 words), of
// blocks_per_lane blocks a lane (plan_step).
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
  StepParams p{};
  int warps = 0, state = 0;
  size_t words = 0;
  const cudaError_t plan = plan_step(
      p, pts, rot_unc, weights, cells, nearest_cell, consts, trim_count,
      cell_compat, prop_onehot, data_mask, lane_pair, sse, L, cap, pop,
      group, Nd, n_cells, size, norm, fused, trim_k, reuse, sorted_merge,
      reg, false, &warps, &words, &state);
  if (plan != cudaSuccess) return static_cast<int>(plan);
  const bool rz = p.reuse != 0;
  p.in = lane_in(nodes, lbs, rz ? cvals : nullptr, opt_err, thr, best_node,
                 ub_terms, min_dropped, done);
  p.out = lane_out(o_nodes, o_lbs, rz ? o_cvals : nullptr, o_opt_err, o_thr,
                   o_best_node, o_ub_terms, o_min_dropped, o_done);
  p.live = live;
  p.cnt_in[0] = it_in;
  p.cnt_in[1] = evals_in;
  p.cnt_in[2] = surv_in;
  p.cnt_in[3] = corners_in;
  p.o_stats = o_stats;
  p.tickets = reinterpret_cast<unsigned int*>(o_stats + 2 * L +
                                              4 * (L / group) + 1);
  p.scratch = scratch;
  static size_t granted = 0;
  const cudaError_t err = allow_smem(inner_step_kernel, 4 * words, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaError_t zero = cudaMemsetAsync(
      p.tickets, 0, sizeof(unsigned int) * (L + 1),
      static_cast<cudaStream_t>(stream));
  if (zero != cudaSuccess) return static_cast<int>(zero);
  inner_step_kernel<<<L * p.blocks_per_lane, 32 * warps, 4 * words,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `blocks` blocks of `threads` threads and `smem`
// bytes of the run's route `route` the card holds at once, asked once per
// shape.
static cudaError_t resident_clusters(int route, int blocks, int threads,
                                     size_t smem, int* n) {
  struct Entry {
    int route, blocks, threads;
    size_t smem;
    int n;
  };
  static Entry cache[16];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].route == route && cache[i].blocks == blocks &&
        cache[i].threads == threads && cache[i].smem == smem) {
      *n = cache[i].n;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(n, goicp::run_kernels[route], &cfg);
  if (err != cudaSuccess) return err;
  if (used < 16) cache[used++] = Entry{route, blocks, threads, smem, *n};
  return cudaSuccess;
}

// n_bytes of zeros at p on the stream, by a memset (no kernel launch): a
// run's int words when its buffers are made (the kernel leaves its sync
// words zero after that).
extern "C" int goicp_zero_words(void* p, long long n_bytes, void* stream) {
  return static_cast<int>(cudaMemsetAsync(
      p, 0, static_cast<size_t>(n_bytes), static_cast<cudaStream_t>(stream)));
}

// the run's slots and ints (search/inner.py's _run_specs and inner_run)
constexpr int kRunSlots = 47, kRunInts = 17;

// One launch of the run: a cluster of blocks_per_lane blocks a lane
// (plan_step), as many clusters as the card holds at once up to one a
// lane.  slots: pts, rot_unc, weights, cells, nearest_cell, consts,
// trim_count, cell_compat, prop_onehot, data_mask, lane_pair, sse; the 9
// input lane fields (nodes, lbs, cvals, opt_err, thr, best_node,
// ub_terms, min_dropped, done); live, watch, once; it, evals, geom_surv,
// chem_corners in; output sets A and B (9 each); the int words: counters
// (4, groups), info (4), the sync words (4: zero, and left zero), then L
// each of frozen, lane evals, lane survivors, lane steps, done
// iterations.  ints: L, cap, pop, group, Nd, n_cells, size, norm, fused,
// trim_k, reuse, sorted_merge, mode, max_iters, steps, stage_w1,
// stage_w2.  cudaErrorCooperativeLaunchTooLarge where not one cluster
// fits.
extern "C" int goicp_inner_run(const unsigned long long* slots, int n_slots,
                               const int* ints, int n_ints, float reg,
                               void* stream) {
  using namespace goicp;
  if (n_slots != kRunSlots || n_ints != kRunInts)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [slots](int k) {
    return reinterpret_cast<float*>(static_cast<uintptr_t>(slots[k]));
  };
  auto i32 = [slots](int k) {
    return reinterpret_cast<int*>(static_cast<uintptr_t>(slots[k]));
  };
  auto u8 = [slots](int k) {
    return reinterpret_cast<unsigned char*>(
        static_cast<uintptr_t>(slots[k]));
  };
  const int L = ints[0], cap = ints[1], pop = ints[2], group = ints[3];
  const int mode = ints[12], steps = ints[14];
  if (mode < kSearch || mode > kStream || (mode == kStream && steps < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  RunParams r{};
  StepParams& p = r.step;
  int warps = 0, state = 0;
  size_t words = 0;
  auto plan = [&](bool held) {
    return plan_step(p, f(0), f(1), f(2), i32(3), i32(4), f(5), f(6), f(7),
                     f(8), f(9), i32(10), f(11), L, cap, pop, group, ints[4],
                     ints[5], ints[6], ints[7], ints[8], ints[9], ints[10],
                     ints[11], reg, held, &warps, &words, &state);
  };
  const cudaError_t planned = plan(true);
  if (planned != cudaSuccess) return static_cast<int>(planned);

  static size_t granted[4] = {0, 0, 0, 0};
  // the state in shared memory where it fits and a cluster holds a lane
  // for the whole run: always in modes search and groups (a cluster takes
  // lanes one after another), in mode stream where the card holds a
  // cluster a lane at once (else the lanes stride, their state in device
  // memory, and the shared memory is planned again without it)
  int route = state > 0 ? (mode == kStream ? kStreamHeld : kLanesHeld)
                        : (mode == kStream ? kStreamGlobal : kLanesGlobal);
  int resident = 0;
  for (;;) {
    const cudaError_t err =
        allow_smem(run_kernels[route], 4 * words, &granted[route]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaError_t occ = resident_clusters(
        route, p.blocks_per_lane, 32 * warps, 4 * words, &resident);
    if (occ != cudaSuccess) return static_cast<int>(occ);
    if (route != kStreamHeld || resident >= L) break;
    const cudaError_t again = plan(false);
    if (again != cudaSuccess) return static_cast<int>(again);
    route = kStreamGlobal;
  }
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int K = p.blocks_per_lane;
  const bool rz = p.reuse != 0;
  p.in = lane_in(f(12), f(13), rz ? f(14) : nullptr, f(15), f(16), f(17),
                 f(18), f(19), u8(20));
  p.out = lane_out(f(28), f(29), rz ? f(30) : nullptr, f(31), f(32), f(33),
                   f(34), f(35), u8(36));
  r.set_b = lane_out(f(37), f(38), rz ? f(39) : nullptr, f(40), f(41),
                     f(42), f(43), f(44), u8(45));
  for (int k = 0; k < 4; ++k) p.cnt_in[k] = i32(24 + k);
  const int groups = L / group;
  r.live = mode == kStream ? u8(21) : nullptr;
  r.watch = mode == kStream ? u8(22) : nullptr;
  r.once = mode == kStream ? u8(23) : nullptr;
  r.cnt = i32(46);
  r.info = r.cnt + 4 * groups;
  r.sync = reinterpret_cast<unsigned int*>(r.info + 4);
  r.frozen = r.info + 8;
  r.lane_ev = r.frozen + L;
  r.lane_su = r.lane_ev + L;
  r.lane_steps = r.lane_su + L;
  r.done_at = r.lane_steps + L;
  r.mode = mode;
  r.max_iters = ints[13];
  r.steps = steps;
  r.stage_w1 = ints[15];
  r.stage_w2 = ints[16];
  r.state_words = state;
  const int n_clusters = resident < L ? resident : L;
  r.resident = route == kLanesHeld || route == kStreamHeld;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n_clusters * K);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 4 * words;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch =
      cudaLaunchKernelEx(&cfg, run_kernels[route], r);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}
