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
//      reuse), or all 27.
// One block then takes every block's bounds and counts (the step: the
// lane's last block to finish, through scratch in device memory and a
// per-lane ticket; the run: the cluster's rank 0, from the other blocks'
// shared memory) and
//   4'. forms each child's max/min over its 8 corners and its terms;
//   5. adopts the first minimum of the children's ub (the first NaN if any,
//      as torch.argmin), updates opt_err, best_node, ub_terms and thr;
//   6. prunes against thr (fused) or opt_err;
//   7. merges the C - P remaining frontier entries with the 8P children by
//      a rank count (each thread one entry: the entries that sort before
//      it), keeping C and the corner payload, and folds the dropped
//      entries' finite minimum into min_dropped;
//   8. writes its lane's evals and geometric survivors; one block (the
//      step: the last to finish, a ticket; the run: the last to reach the
//      grid barrier) adds them, per group of lanes, to the counters (it,
//      evals, geom_surv, chem_corners) and counts the lanes left not done,
//      so that no torch op follows the launch.
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
// The run (goicp_inner_run).  What bounds an iteration on this card is its
// dependent chain, not bytes or operations (the K3/K4 bodies take ~0.015
// ms of an iteration's ~0.04 ms on the card, PERF.md), and a loop on the
// host adds a launch and a host read to every iteration.  So:
//   * a lane is a thread-block cluster of its K <= 8 blocks: each block
//     writes its bounds and counts into its own shared memory, rank 0
//     reads the others' through distributed shared memory between two
//     cluster barriers (no scratch in device memory, no ticket, no fence);
//   * the grid is persistent: as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters, never guessed; a shape that fits
//     none is refused), the lanes strided over them, one lane of a
//     cluster after another;
//   * between iterations a grid barrier (an arrival count and a
//     generation word of the launch's own, zeroed on its stream): the last
//     block to arrive forms the counters as step 8 does, the next
//     iteration's live groups and the stop word, then lets the others go;
//   * the lanes' state alternates between the launch's two output sets
//     (iteration i reads set (i - 1) % 2, the caller's input at i = 0, and
//     writes set i % 2); a lane that no longer steps is copied into each
//     set once and then left alone; after an even number of iterations
//     the lanes still differing are copied from set B into set A, so that
//     the result is always in set A and the caller reads nothing to find
//     it.
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
#include <cooperative_groups.h>

#include "inner_body.cuh"

namespace goicp {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

// the step's exchange: each block's share to the lane's scratch in device
// memory, the last block to finish (a per-lane ticket) reads every share
struct TicketExchange {
  float* scratch;
  unsigned int* tickets;
  int blocks, B, Q;

  __device__ __forceinline__ void parts(float*, float*, float*, float*,
                                        int lane, float*& ub, float*& ubu,
                                        float*& lb, float*& count) const {
    ub = scratch + static_cast<size_t>(lane) * (3 * B + Q);
    ubu = ub + B;
    lb = ubu + B;
    count = lb + B;
  }

  __device__ __forceinline__ bool gather(int lane, int, int nb, int, int Q_,
                                         int, bool fused, float* s_ub,
                                         float* s_ubu, float* s_lb,
                                         float* s_count) const {
    __shared__ int s_lane_last;
    const int t = threadIdx.x, nt = blockDim.x;
    float *g_ub, *g_ubu, *g_lb, *g_count;
    parts(nullptr, nullptr, nullptr, nullptr, lane, g_ub, g_ubu, g_lb,
          g_count);
    // the last of the lane's blocks to finish goes on with the lane
    __threadfence();
    __syncthreads();
    if (t == 0) s_lane_last = atomicAdd(&tickets[lane], 1u) == blocks - 1;
    __syncthreads();
    if (!s_lane_last) return false;
    __threadfence();
    for (int i = t; i < nb; i += nt) {
      s_ub[i] = __ldcg(g_ub + i);
      s_lb[i] = __ldcg(g_lb + i);
      if (fused) s_ubu[i] = __ldcg(g_ubu + i);
    }
    for (int i = t; i < Q_; i += nt) s_count[i] = __ldcg(g_count + i);
    __syncthreads();
    return true;
  }
};

__global__ void __launch_bounds__(kStepWarps * 32, 2)
    inner_step_kernel(StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ int s_red[kStepWarps];

  const int lane = blockIdx.x / p.blocks_per_lane;
  const int part = blockIdx.x % p.blocks_per_lane;
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, tid = t & 31;
  const int Q = p.chem.cell_compat != nullptr
                    ? (p.reuse ? 19 : 27) * p.pop : 0;
  const bool live = p.live == nullptr || p.live[lane / p.group] != 0;
  TicketExchange ex{p.scratch, p.tickets, p.blocks_per_lane, 8 * p.pop, Q};
  step_lane(p, p.in, p.out, lane, part, live, p.o_stats, nullptr, smem, ex);

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
      cnt[k * groups + g] = (p.cnt_in[k] != nullptr ? p.cnt_in[k][g] : 0) + add[k];
  }
  int active = 0;
  for (int l = t; l < p.L; l += nt) active += o_done[l] == 0;
  active = warp_sum(active);
  if (tid == 0) s_red[warp] = active;
  __syncthreads();
  if (t == 0) {
    int n = 0;
    for (int w = 0; w < nt / 32; ++w) n += s_red[w];
    cnt[4 * groups] = n;
  }
}

// ---------------------------------------------------------------------------
// the run
// ---------------------------------------------------------------------------

enum RunMode { kSearch = 0, kGroups = 1, kStream = 2 };

// a grid barrier that waits this long has lost a block: end the launch
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
                             // [2] the grid's clusters
  unsigned int* sync;        // zeroed: [0] arrivals, [1] generation,
                             // [2] stop, [3] lanes not done before the
                             // next iteration
  int* frozen;               // (L,) zeroed: copies of a lane that no
                             // longer steps
  int* lane_stats;           // (2 L) each lane's evals and survivors of
                             // the iteration
  int* live_next;            // groups: (groups,) live in the next iteration
  int mode, max_iters, steps, stage_w1, stage_w2;
};

// the lanes' cluster exchange: each block's share stays in its own shared
// memory, rank 0 reads the others' between two cluster barriers
struct ClusterExchange {
  __device__ __forceinline__ void parts(float* s_ub, float* s_ubu,
                                        float* s_lb, float* s_count, int,
                                        float*& ub, float*& ubu, float*& lb,
                                        float*& count) const {
    ub = s_ub;
    ubu = s_ubu;
    lb = s_lb;
    count = s_count;
  }

  __device__ __forceinline__ bool gather(int, int part, int nb, int nper,
                                         int Q, int qper, bool fused,
                                         float* s_ub, float* s_ubu,
                                         float* s_lb, float* s_count) const {
    cg::cluster_group cluster = cg::this_cluster();
    const int t = threadIdx.x, nt = blockDim.x;
    cluster.sync();            // every block's share is in its memory
    if (part == 0) {
      for (int i = t; i < nb; i += nt) {
        const unsigned r = i / nper;
        if (r == 0) continue;
        s_ub[i] = cluster.map_shared_rank(s_ub, r)[i];
        s_lb[i] = cluster.map_shared_rank(s_lb, r)[i];
        if (fused) s_ubu[i] = cluster.map_shared_rank(s_ubu, r)[i];
      }
      for (int i = t; i < Q; i += nt) {
        const unsigned r = i / qper;
        if (r != 0) s_count[i] = cluster.map_shared_rank(s_count, r)[i];
      }
    }
    cluster.sync();            // read: the other blocks may go on
    return part == 0;
  }
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Sum over the block, every thread gets it.
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

// does group g step in iteration `it` (groups: from the inputs at it = 0,
// else what the last barrier decided)
__device__ __forceinline__ bool run_live(const RunParams& r, int it, int g) {
  const StepParams& p = r.step;
  if (r.mode == kSearch) return true;
  if (r.mode == kStream) return r.live == nullptr || r.live[g] != 0;
  if (it > 0) return *static_cast<const volatile int*>(r.live_next + g) != 0;
  if (p.cnt_in[0] != nullptr && p.cnt_in[0][g] >= r.max_iters) return false;
  for (int l = g * p.group; l < (g + 1) * p.group; ++l)
    if (p.in.done[l] == 0) return true;
  return false;
}

// Step 8 of iteration `it` and the decision about the next, by the last
// block at the barrier (the whole block): the counters of every group, the
// next iteration's live groups, the lanes not done and the stop word.
__device__ void run_counters(const RunParams& r, int it) {
  const StepParams& p = r.step;
  const int t = threadIdx.x, nt = blockDim.x;
  const int L = p.L, groups = L / p.group;
  const int Q = p.chem.cell_compat != nullptr
                    ? (p.reuse ? 19 : 27) * p.pop : 0;
  const volatile unsigned char* done = (it % 2 == 0 ? p.out : r.set_b).done;
  const volatile int* stats = r.lane_stats;
  volatile int* cnt = r.cnt;
  volatile unsigned int* sync = r.sync;
  int a = 0, b = 0;
  for (int l = t; l < L; l += nt) {
    a += done[l] == 0;
    if (it == 0) b += p.in.done[l] == 0;
  }
  const int n_after = block_sum(a);
  const int n_before = it == 0 ? block_sum(b) : static_cast<int>(sync[3]);
  // the stage the staged compaction would run this iteration in
  const int width = r.stage_w1 > 0 && n_before <= r.stage_w1
                        ? (r.stage_w2 > 0 && n_before <= r.stage_w2
                               ? r.stage_w2 : r.stage_w1)
                        : L;
  int more = 0, due = 0;
  for (int g = t; g < groups; g += nt) {
    const bool lv = run_live(r, it, g);
    int ev = 0, su = 0;
    bool all_done = true;
    for (int l = g * p.group; l < (g + 1) * p.group; ++l) {
      ev += stats[l];
      su += stats[L + l];
      all_done = all_done && done[l] != 0;
    }
    const int corners = !lv ? 0 : (r.mode == kSearch ? Q * width
                                                     : p.group * Q);
    const int add[4] = {lv ? 1 : 0, ev, su, corners};
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int base = it > 0 ? cnt[k * groups + g]
                              : (p.cnt_in[k] != nullptr ? p.cnt_in[k][g] : 0);
      v[k] = base + add[k];
      cnt[k * groups + g] = v[k];
    }
    const bool complete = all_done || v[0] >= r.max_iters;
    if (r.mode == kGroups) {
      r.live_next[g] = complete ? 0 : 1;
      more |= !complete;
    }
    if (r.mode == kStream)
      due |= complete && (r.watch == nullptr || r.watch[g] != 0);
  }
  more = __syncthreads_or(more);
  due = __syncthreads_or(due);
  if (t == 0) {
    const int n = it + 1;
    const bool stop = r.mode == kSearch
                          ? n_after == 0 || n >= r.max_iters
                          : (r.mode == kGroups
                                 ? !more
                                 : due || n >= r.steps ||
                                       (r.once != nullptr && r.once[0] != 0));
    sync[2] = stop ? 1u : 0u;
    sync[3] = static_cast<unsigned>(n_after);
    r.info[0] = n;
    r.info[1] = n_after;
    r.info[2] = static_cast<int>(gridDim.x) / p.blocks_per_lane;
  }
}

// The grid barrier after iteration `it`; false when the run stops there.
__device__ bool run_barrier(const RunParams& r, int it) {
  __shared__ int s_last, s_stop;
  __shared__ unsigned int s_gen;
  volatile unsigned int* sync = r.sync;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int gen = sync[1];
    __threadfence();
    const bool last = atomicAdd(r.sync, 1u) == gridDim.x - 1;
    if (!last) {
      const unsigned long long t0 = global_ns();
      while (sync[1] == gen) {
        if (global_ns() - t0 > kSpinLimitNs) __trap();
        __nanosleep(64);
      }
      __threadfence();
    }
    s_last = last;
    s_gen = gen;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    run_counters(r, it);
    __syncthreads();
    if (threadIdx.x == 0) {
      sync[0] = 0;
      __threadfence();
      atomicExch(r.sync + 1, s_gen + 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) s_stop = static_cast<int>(sync[2]);
  __syncthreads();
  return s_stop == 0;
}

__global__ void __launch_bounds__(kStepWarps * 32, 2)
    inner_run_kernel(RunParams r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StepParams& p = r.step;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.blocks_per_lane;              // the cluster's size
  const int part = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / K, n_clusters = gridDim.x / K;
  const int t = threadIdx.x, nt = blockDim.x;
  const int groups = p.L / p.group;
  ClusterExchange ex;

  // a first iteration at all (every block alike, from the inputs)
  bool go = true;
  if (r.mode == kSearch) {
    int a = 0;
    for (int l = t; l < p.L; l += nt) a |= p.in.done[l] == 0;
    go = __syncthreads_or(a) && r.max_iters > 0;
  } else if (r.mode == kGroups) {
    int a = 0;
    for (int g = t; g < groups; g += nt) a |= run_live(r, 0, g);
    go = __syncthreads_or(a);
  }
  int it = 0;
  for (; go; ++it) {
    const LaneIn in = it == 0 ? p.in : as_input(it % 2 == 1 ? p.out : r.set_b);
    const LaneOut out = it % 2 == 0 ? p.out : r.set_b;
    for (int lane = cid; lane < p.L; lane += n_clusters)
      step_lane(p, in, out, lane, part, run_live(r, it, lane / p.group),
                r.lane_stats, r.frozen, smem, ex);
    go = run_barrier(r, it);
  }

  // the result into set A: the input after no iteration, set B's lanes
  // that still differ after an even number
  if (part == 0 && it % 2 == 0)
    for (int lane = cid; lane < p.L; lane += n_clusters) {
      if (it == 0)
        copy_lane(p, p.in, p.out, lane, p.in.done[lane] != 0);
      else if (r.frozen[lane] < 2)
        copy_lane(p, as_input(r.set_b), p.out, lane, r.set_b.done[lane] != 0);
    }
  if (it == 0 && blockIdx.x == 0) {
    for (int i = t; i < 4 * groups; i += nt)
      r.cnt[i] = p.cnt_in[i / groups] != nullptr
                     ? p.cnt_in[i / groups][i % groups] : 0;
    int a = 0;
    for (int l = t; l < p.L; l += nt) a += p.in.done[l] == 0;
    a = block_sum(a);
    if (t == 0) {
      r.info[0] = 0;
      r.info[1] = a;
      r.info[2] = n_clusters;
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The parameters both entries share, and their launch plan: kStepWarps
// warps a block (fewer when the trimmed rows' scratch of that many warps
// would not fit), the step's own arrays first in shared memory, then the
// bodies' region: each body stages the lane's point data and the pair's
// tables there when they fit, as its standalone kernel's launcher decides;
// a lane over as many blocks as give each warp about one child (at most
// 8, K3's spread).  Any pop and capacity whose arrays fit a block's shared
// memory; cudaErrorInvalidValue for shapes that do not.
static cudaError_t plan_step(
    goicp::StepParams& p, const float* pts, const float* rot_unc,
    const float* weights, const int* cells, const int* nearest_cell,
    const float* consts, const float* trim_count, const float* cell_compat,
    const float* prop_onehot, const float* data_mask, const int* lane_pair,
    const float* sse, int L, int cap, int pop, int group, int Nd,
    int n_cells, int size, int norm, int fused, int trim_k, int reuse,
    int sorted_merge, float reg, int* warps_out, size_t* words_out) {
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
  const int N = cap - pop + B;
  const size_t step_words =
      region_words(static_cast<size_t>(B) * (4 + 3 + 1 + 3 + 2 + 3 + 8) +
                   4 * static_cast<size_t>(Q) + N + pop);
  if (step_words >= kMaxDynamicSmem / 4) return cudaErrorInvalidValue;
  p.step_words = static_cast<int>(step_words);
  const size_t budget = kMaxDynamicSmem / 4 - step_words;
  int warps = kStepWarps;
  while (warps > 1 && geom_rows_words(g, warps) > budget) warps >>= 1;
  const size_t rows = geom_rows_words(g, warps);
  if (rows > budget) return cudaErrorInvalidValue;
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
  *words_out = p.step_words + (gw > cw ? gw : cw);
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
  int warps = 0;
  size_t words = 0;
  const cudaError_t plan = plan_step(
      p, pts, rot_unc, weights, cells, nearest_cell, consts, trim_count,
      cell_compat, prop_onehot, data_mask, lane_pair, sse, L, cap, pop,
      group, Nd, n_cells, size, norm, fused, trim_k, reuse, sorted_merge,
      reg, &warps, &words);
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
// bytes the card holds at once, asked once per shape.
static cudaError_t resident_clusters(int blocks, int threads, size_t smem,
                                     int* n) {
  struct Entry {
    int blocks, threads;
    size_t smem;
    int n;
  };
  static Entry cache[16];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].blocks == blocks && cache[i].threads == threads &&
        cache[i].smem == smem) {
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
      cudaOccupancyMaxActiveClusters(n, goicp::inner_run_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 16) cache[used++] = Entry{blocks, threads, smem, *n};
  return cudaSuccess;
}

// One launch of the run: a cluster of blocks_per_lane blocks a lane
// (plan_step), as many clusters as the card holds at once up to one a
// lane, after zeroing the launch's barrier words and copy counts (o_int's
// info, sync and frozen words).  o_int: counters (4, groups), info (4),
// sync (4), frozen (L), lane stats (2 L), live_next (groups).
// cudaErrorCooperativeLaunchTooLarge where not one cluster fits.
extern "C" int goicp_inner_run(
    const float* pts, const float* rot_unc, const float* weights,
    const int* cells, const int* nearest_cell, const float* consts,
    const float* trim_count, const float* cell_compat,
    const float* prop_onehot, const float* data_mask, const int* lane_pair,
    const float* sse, const float* nodes, const float* lbs,
    const float* cvals, const float* opt_err, const float* thr,
    const float* best_node, const float* ub_terms, const float* min_dropped,
    const unsigned char* done, const unsigned char* live,
    const unsigned char* watch, const unsigned char* once,
    const int* it_in, const int* evals_in,
    const int* surv_in, const int* corners_in, float* a_nodes,
    float* a_lbs, float* a_cvals, float* a_opt_err, float* a_thr,
    float* a_best_node, float* a_ub_terms, float* a_min_dropped,
    unsigned char* a_done, float* b_nodes, float* b_lbs, float* b_cvals,
    float* b_opt_err, float* b_thr, float* b_best_node, float* b_ub_terms,
    float* b_min_dropped, unsigned char* b_done, int* o_int, int L, int cap,
    int pop, int group, int Nd, int n_cells, int size, int norm, int fused,
    int trim_k, int reuse, int sorted_merge, int mode, int max_iters,
    int steps, int stage_w1, int stage_w2, float reg, void* stream) {
  using namespace goicp;
  if (mode < kSearch || mode > kStream || (mode == kStream && steps < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  RunParams r{};
  StepParams& p = r.step;
  int warps = 0;
  size_t words = 0;
  const cudaError_t plan = plan_step(
      p, pts, rot_unc, weights, cells, nearest_cell, consts, trim_count,
      cell_compat, prop_onehot, data_mask, lane_pair, sse, L, cap, pop,
      group, Nd, n_cells, size, norm, fused, trim_k, reuse, sorted_merge,
      reg, &warps, &words);
  if (plan != cudaSuccess) return static_cast<int>(plan);
  const bool rz = p.reuse != 0;
  p.in = lane_in(nodes, lbs, rz ? cvals : nullptr, opt_err, thr, best_node,
                 ub_terms, min_dropped, done);
  p.out = lane_out(a_nodes, a_lbs, rz ? a_cvals : nullptr, a_opt_err, a_thr,
                   a_best_node, a_ub_terms, a_min_dropped, a_done);
  r.set_b = lane_out(b_nodes, b_lbs, rz ? b_cvals : nullptr, b_opt_err,
                     b_thr, b_best_node, b_ub_terms, b_min_dropped, b_done);
  p.cnt_in[0] = it_in;
  p.cnt_in[1] = evals_in;
  p.cnt_in[2] = surv_in;
  p.cnt_in[3] = corners_in;
  const int groups = L / group;
  r.live = mode == kStream ? live : nullptr;
  r.watch = mode == kStream ? watch : nullptr;
  r.once = mode == kStream ? once : nullptr;
  r.cnt = o_int;
  r.info = o_int + 4 * groups;
  r.sync = reinterpret_cast<unsigned int*>(r.info + 4);
  r.frozen = r.info + 8;
  r.lane_stats = r.frozen + L;
  r.live_next = r.lane_stats + 2 * L;
  r.mode = mode;
  r.max_iters = max_iters;
  r.steps = steps;
  r.stage_w1 = stage_w1;
  r.stage_w2 = stage_w2;

  static size_t granted = 0;
  const cudaError_t err = allow_smem(inner_run_kernel, 4 * words, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int K = p.blocks_per_lane;
  int resident = 0;
  const cudaError_t occ = resident_clusters(K, 32 * warps, 4 * words,
                                            &resident);
  if (occ != cudaSuccess) return static_cast<int>(occ);
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int n_clusters = resident < L ? resident : L;
  const cudaError_t zero = cudaMemsetAsync(
      r.info, 0, sizeof(int) * (8 + L), static_cast<cudaStream_t>(stream));
  if (zero != cudaSuccess) return static_cast<int>(zero);
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
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, inner_run_kernel, r);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}
