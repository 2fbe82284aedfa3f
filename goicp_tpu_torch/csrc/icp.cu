// icp: the whole ICP event of goicp_tpu_torch/icp/icp.py::icp_run in one
// launch; the refine route (search/pick.py::icp_refine: every refining row
// of a transition, each an event with its seeds before it and its
// rescoring and pick after it, in one launch); the initial route
// (pick.py::icp_init: a pair's initial incumbent, the event from the
// initial seeds, its rescoring, the initial error and the pick, in one
// launch); and the Kabsch step alone (kabsch_from_H) for a batch of 3x3 H.
//
// Not a port of a TPU kernel: the JAX package's ICP
// (goicp_tpu/icp/icp.py:174, icp_run, a lax.while_loop that XLA compiles)
// has no Pallas kernel.  The port's plain loop (icp.py::icp_run_plain)
// steps every row from the host: one ICP iteration is ~1,000 small
// launches (the ordered sums of csrc/ordered_sum.cu, sq_dist3, det3 and
// cross3 of csrc/fp32_products.cu, dot_fma, and the Jacobi SVD's
// elementwise torch ops) and one host read (is any row still running?).
// This kernel replaces all of them for an event.
//
// What bounds it on the H100: latency.  An event of K rows (the ICP
// seeds, or 1) has K independent loops of up to max_iter iterations, each
// iteration a chain of dependent steps: ~Nd*M*9 operations of the nearest-
// neighbour search, the trimmed modes' stable ranks (~Nd^2), 16 fixed-
// order sums over the points and a serial 3x3 Kabsch (a Jacobi SVD of 18
// Givens rotations, each a chain of a division, square roots and
// reciprocals).  The design (bench/icp_stops.py times it stage by stage):
// a thread-block cluster of C = ceil(Nd / 32) <= 8 blocks per row, which
// loops the row's iterations until it stops (converged or max_iter),
// exactly as each row of the plain loop does (stopped rows keep their
// state); so an event is one launch and no host read.  Every block holds
// the model, |q|^2 and the data in its shared memory and takes a
// contiguous share of the data points for the nearest-neighbour scan: G
// threads a point (G the largest power of two <= 32 with G points' worth
// of threads in the block), thread g scanning the model points j = g (mod
// G); one thread a point (G = 1, large shares) takes two points at once.
// Each block sends its points' (d2, NN index) pairs, 8 bytes each, to
// every block of the cluster through distributed shared memory; while
// they travel (between the cluster barrier's arrival and its wait) each
// block rotates all the points for its own sums.  In the trimmed modes the
// same G threads a point then count the share's stable ranks, and the
// mask goes to every block before a second barrier (ranking all the
// points in every block instead took 5 us an iteration more on trm00).
// Then every block holds the whole arrays and forms the 16 sums and the
// Kabsch alike, so the row's state is the same in every block with no
// further exchange.  The pairs are kept in two copies used in turn, so a
// block that runs ahead into the next iteration writes the other copy.
// Clouds too large for a cluster's shared memory take one block per row
// (C = 1); too large for that (10 Nd + 4 M words above 227 KB), a per-row
// workspace in device memory from the wrapper; the code is the same.
//
// The refine and initial routes run the same loop, instances of icp_event
// apart from icp_run_kernel's (one kernel carrying every route would hold
// the registers of all).  The refine route (icp_refine_kernel): cluster q
// of its grid is seed k = q % K of refine row q / K, each row reading its
// own pair through its row of pointers; before the loop every block ranks
// the row's lanes from shared memory and takes the start of rank k
// (csrc/score.cu's icp_seeds_kernel did this in a launch of its own).  The
// initial route (icp_init_kernel): cluster k < K is seed k from the
// initial seeds' R0[k], t0[k], and one more cluster's block 0 computes the
// initial error (score_body.cuh's score_row, route kInitial) while the
// loops run.  After the loop every block of a seed's cluster holds the
// whole row (R, t and the last NN indices), and the epilogue rescores it
// with score_body.cuh's score_row_cluster: each block scores the points of
// its share of the loop, the values and integer partials go to block 0
// through distributed shared memory, the trimmed ranks are counted G
// threads a point over the blocks as the loop's mask is, each value
// placed at its rank in block 0, and block 0 forms the sums and terms in
// the block form's orders (C = 1: score_row on the row's one block).  The
// refine route's seed-0 cluster counts the BnB candidate's
// incompatibilities beside its shares.  The last of a row's K + 1
// arrivals at its ticket (the K rescorings and the extra row: the count
// or the initial error) picks with pick_write: into the refine record
// (route kPick; score.cu's pick_kernel did this), or the initial
// incumbent into the state's tensors (route kInit; score.cu's pick route
// kInit after icp_run's launch did this).  The bodies are score.cu's and
// their sums keep its orders, so the bits are the replaced launches'.
//
// Every value equals the plain loop's bit for bit, on the card and on the
// CPU, because each step takes the plain loop's own order:
//   1. pts = rotate(R, data) + t, each coordinate a dot3_warp;
//   2. the NN search by sq_dist3's algebra (|p|^2 - 2 p.q) + |q|^2, the
//      first index of the minimum, then clamp(min=0); 1e12 on padded rows:
//      each of the G threads keeps the first minimum of its model points
//      (ascending j), and the G partial results combine by (d, j), the
//      lower index winning ties, which is the serial scan's first minimum
//      for finite points;
//   3. the mask in one of four modes (kMode*), the trimmed ones by the
//      stable rank #{j: d2_j < d2_i} + #{j < i: d2_j == d2_i}, which is the
//      position in argsort(stable=True) (integer counts, exact in any
//      order of the G partial counts);
//   4. err_new, mu_d (3), mu_m (3), then the 9 entries of H: each sum by
//      one warp of a block in ordered_sum's lanes-32 order (lane t adds
//      terms t, t+32, ... from +0.0; then common.cuh's xor butterfly),
//      over the whole gathered arrays, never split across blocks;
//   5. the convergence test (err > 0) & (err - err_new < err_diff cnt);
//   6. kabsch_from_H (below) on one thread, H in registers, then t_,
//      R_next and t_next by matvec3's and matmul3's dot3_warp.
// Every product and sum is an explicit round-to-nearest intrinsic (no FMA
// contraction) except R = V (dU)^T's chain, fp32_order.cuh's dot_fma_step
// (__fmaf_rn, one rounding a step, as fp32.py's dot_fma); Python scalars
// of the plain loop (1e-30, 1e-5, 1e12, err_diff) act in float32, as
// torch rounds them; torch.clamp, sign, amax and argmin keep torch's NaN
// and signed-zero rules.  The NN search assumes finite points (its
// argmin does not look for NaN).
#include <algorithm>
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"
#include "fp32_order.cuh"
#include "score_body.cuh"

namespace cg = cooperative_groups;

// The probe's stop points (bench/icp_stops.py): a build with
// -DGOICP_ICP_STOP=n ends every iteration after stage n (1 the rotation
// and the nearest neighbours, 2 the mask, 3 the 7 masked sums, 4 H's 9
// sums; 5, the convergence test, the Kabsch and the update, is the full
// kernel), and a row then runs max_iter iterations.  The normal build
// defines no stop: every stage runs.
#ifndef GOICP_ICP_STOP
#define GOICP_ICP_STOP 99
#endif
// The refine and initial routes' (bench/refine_stops.py):
// -DGOICP_REFINE_STOP=1 ends each cluster after its ICP loop (no
// rescoring, no initial error, no pick); 2 after the split rescoring's
// values and counts are in block 0 (its first barrier), 3 after the
// ranks' barrier, 4 after the rescorings, the candidate's count and the
// initial error (no ticket, no pick); the record or the state is then not
// written.  A stop is taken on a condition the compiler cannot fold
// (max_iter >= 0), so that the code after it, and the registers, stay.
#ifndef GOICP_REFINE_STOP
#define GOICP_REFINE_STOP 99
#endif
// a stopped iteration's end: count it and go on to the next
#define ICP_STOP_AFTER(n)                  \
  if (GOICP_ICP_STOP == (n)) {             \
    if (tid == 0) {                        \
      s_it += 1;                           \
      s_run = s_it < p.max_iter;           \
    }                                      \
    __syncthreads();                       \
    continue;                              \
  }

namespace goicp {

constexpr int kIcpThreads = 512;
constexpr int kIcpWarps = kIcpThreads / 32;
// the blocks of a row: ceil(Nd / kIcpPointsPerBlock), at most
// kIcpClusterMax (the portable cluster size)
constexpr int kIcpClusterMax = 8;
constexpr int kIcpPointsPerBlock = 32;
constexpr int kKabschThreads = 128;
// a row's workspace in shared memory, at most: the opt-in limit less the
// kernel's static shared memory (icp/icp.py::ICP_SMEM_BYTES mirrors it)
constexpr size_t kIcpSmemMax = kMaxDynamicSmem - 1024;

// the mask of step 3
constexpr int kModeAll = 0;       // untrimmed: every row kept
constexpr int kModeTrim = 1;      // static trim: stable rank < inlier_num
constexpr int kModeCount = 2;     // dynamic counts: data_mask itself
constexpr int kModeDynTrim = 3;   // dynamic trim: stable rank < *count

// the kernels' routes, one kernel each (icp_event's instances)
constexpr int kRouteRun = 0;      // icp_run_kernel: the event alone
constexpr int kRouteRefine = 1;   // icp_refine_kernel: a transition's rows
constexpr int kRouteInit = 2;     // icp_init_kernel: the initial incumbent

// torch.clamp(x, min=lo): x where x >= lo or NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.sign: +0 for either zero (and NaN)
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.argmin of three values: the first minimum, a NaN counting as one
__device__ __forceinline__ int argmin3(const float* v) {
  int k = 0;
  float best = v[0];
#pragma unroll
  for (int j = 1; j < 3; ++j)
    if (!is_nan(best) && (v[j] < best || is_nan(v[j]))) {
      best = v[j];
      k = j;
    }
  return k;
}

// One Givens rotation of the one-sided Jacobi (icp.py::_jacobi_svd3's
// rot), zeroing the inner product of columns P and Q of A; applied to A
// and V.  Row-major 3x3 arrays.  The serial chain of the Kabsch: each
// rotation's tau, root, t and c wait on one another, so the rotation
// takes the shortest exact form of each (the same bits as the plain
// version's):
//   - not safe: t = 0 and c = 1 / sqrt(1 + 0 * 0) = 1, nothing to compute;
//   - root = sqrt(RN(1 + tau^2)) is |tau| where 1 + tau^2 rounds to
//     RN(tau^2) and that is finite (sqrt(RN(x^2)) = |x| in binary floating
//     point), as in the late sweeps, where tau is large;
//   - c = 1 / sqrt(RN(1 + t^2)) is 1 where 1 + t^2 rounds to 1 (|t| <
//     2^-12, the late sweeps again).
// (A quotient 1 / x stays a division: __frcp_rn's chain is the longer on
// the H100, bench/icp_stops.py's variants show.)
template <int P, int Q>
__device__ __forceinline__ void givens(float* A, float* V) {
  const float ap[3] = {A[P], A[3 + P], A[6 + P]};
  const float aq[3] = {A[Q], A[3 + Q], A[6 + Q]};
  const float app = dot3_seq(ap, ap), aqq = dot3_seq(aq, aq),
              apq = dot3_seq(ap, aq);
  float t = 0.0f, c = 1.0f;
  if (fabsf(apq) > 1e-30f) {
    const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.0f, apq));
    const float tau2 = __fmul_rn(tau, tau);
    const float y = __fadd_rn(1.0f, tau2);
    float root;
    if (y == tau2 && tau2 < __int_as_float(0x7f800000))
      root = fabsf(tau);
    else
      root = __fsqrt_rn(y);
    t = __fdiv_rn(sign_of(tau), __fadd_rn(fabsf(tau), root));
    const float z = __fadd_rn(1.0f, __fmul_rn(t, t));
    if (z != 1.0f) c = __fdiv_rn(1.0f, __fsqrt_rn(z));
  }
  const float s = __fmul_rn(t, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a_p = A[3 * i + P], a_q = A[3 * i + Q];
    A[3 * i + P] = __fsub_rn(__fmul_rn(c, a_p), __fmul_rn(s, a_q));
    A[3 * i + Q] = __fadd_rn(__fmul_rn(s, a_p), __fmul_rn(c, a_q));
    const float v_p = V[3 * i + P], v_q = V[3 * i + Q];
    V[3 * i + P] = __fsub_rn(__fmul_rn(c, v_p), __fmul_rn(s, v_q));
    V[3 * i + Q] = __fadd_rn(__fmul_rn(s, v_p), __fmul_rn(c, v_q));
  }
}

// the sort network's compare-swap: columns P and Q of A and V and their
// sigmas trade places where sigma[P] < sigma[Q]
template <int P, int Q>
__device__ __forceinline__ void sort_swap(float* A, float* V, float* sigma) {
  const bool swap = sigma[P] < sigma[Q];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a_p = A[3 * i + P], a_q = A[3 * i + Q];
    A[3 * i + P] = swap ? a_q : a_p;
    A[3 * i + Q] = swap ? a_p : a_q;
    const float v_p = V[3 * i + P], v_q = V[3 * i + Q];
    V[3 * i + P] = swap ? v_q : v_p;
    V[3 * i + Q] = swap ? v_p : v_q;
  }
  const float s_p = sigma[P], s_q = sigma[Q];
  sigma[P] = swap ? s_q : s_p;
  sigma[Q] = swap ? s_p : s_q;
}

// icp.py::kabsch_from_H: R = V D U^T from the Jacobi SVD of H / max|H|,
// D = diag(1, 1, det(V) det(U)) on the smallest singular value; identity
// where max|H| is not > 0.  H and R row-major arrays of the caller's
// registers: inlined, so that no array goes through a stack frame.
__device__ __forceinline__ void kabsch_from_H(const float (&H)[9],
                                              float (&R)[9]) {
  float hmax = fabsf(H[0]);           // torch.amax: a NaN wins
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float a = fabsf(H[k]);
    if (is_nan(a) || a > hmax) hmax = a;
  }
  const float scale = clamp_min(hmax, 1e-30f);
  float A[9], V[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
  for (int k = 0; k < 9; ++k) A[k] = __fdiv_rn(H[k], scale);
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
    givens<0, 1>(A, V);
    givens<0, 2>(A, V);
    givens<1, 2>(A, V);
  }
  float sigma[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float col[3] = {A[j], A[3 + j], A[6 + j]};
    sigma[j] = __fsqrt_rn(dot3_seq(col, col));
  }
  sort_swap<0, 1>(A, V, sigma);
  sort_swap<0, 2>(A, V, sigma);
  sort_swap<1, 2>(A, V, sigma);
  float s1 = sigma[0];                // torch.amax
#pragma unroll
  for (int k = 1; k < 3; ++k)
    if (is_nan(sigma[k]) || sigma[k] > s1) s1 = sigma[k];
  const float tol = __fmul_rn(1e-5f, clamp_min(s1, 1e-30f));
  float u0[3], u1[3], u2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u0[i] = __fdiv_rn(A[3 * i], clamp_min(sigma[0], 1e-30f));
    u1[i] = __fdiv_rn(A[3 * i + 1], clamp_min(sigma[1], 1e-30f));
    u2[i] = __fdiv_rn(A[3 * i + 2], clamp_min(sigma[2], 1e-30f));
  }
  // the branch-free completion of degenerate columns
  const float abs_u0[3] = {fabsf(u0[0]), fabsf(u0[1]), fabsf(u0[2])};
  const int ei = argmin3(abs_u0);
  const float e[3] = {ei == 0 ? 1.0f : 0.0f, ei == 1 ? 1.0f : 0.0f,
                      ei == 2 ? 1.0f : 0.0f};
  float alt1[3];
  cross3(u0, e, alt1);
  const float norm = clamp_min(__fsqrt_rn(dot3_seq(alt1, alt1)), 1e-30f);
#pragma unroll
  for (int i = 0; i < 3; ++i) alt1[i] = __fdiv_rn(alt1[i], norm);
  if (!(sigma[1] > tol)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = alt1[i];
  }
  if (!(sigma[2] > tol)) cross3(u0, u1, u2);
  float U[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[3 * i] = u0[i];
    U[3 * i + 1] = u1[i];
    U[3 * i + 2] = u2[i];
  }
  const float det = __fmul_rn(det3_rows(V), det3_rows(U));
  const int small = argmin3(sigma);
  float dU[9];                        // (d[None, :] * U)[j][k] = d[k] U[j][k]
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dU[3 * j + k] = __fmul_rn(k == small ? det : 1.0f, U[3 * j + k]);
  const bool nonzero = hmax > 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = __fmul_rn(V[3 * i], dU[3 * j]);
      acc = dot_fma_step(V[3 * i + 1], dU[3 * j + 1], acc);
      acc = dot_fma_step(V[3 * i + 2], dU[3 * j + 2], acc);
      R[3 * i + j] = nonzero ? acc : (i == j ? 1.0f : 0.0f);
    }
}

__global__ void kabsch3_kernel(const float* __restrict__ H,
                               float* __restrict__ R, long long batch) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kKabschThreads + threadIdx.x;
  if (b >= batch) return;
  float h[9], r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = __ldg(H + 9 * b + k);
  kabsch_from_H(h, r);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[9 * b + k] = r[k];
}

// A block's share of a row's points (C blocks a row) and a row's
// workspace in words, the same in every block: model (3 M) and |q|^2 (M);
// data_mask and the mask (Nd each); the data and the rotated points (3 Nd
// each); then, in one copy for C = 1 and two used in turn for C > 1, each
// point's (d2, NN index) pair (2 Nd, on 8 bytes: every offset before it
// is even).  C = 1 is 10 Nd + 4 M words, the size the wrapper checks
// against ICP_SMEM_BYTES.
__host__ __device__ __forceinline__ int icp_share(int nd, int c) {
  return (nd + c - 1) / c;
}

__host__ __device__ __forceinline__ long long icp_workspace_words(int nd,
                                                                  int m,
                                                                  int c) {
  return 4LL * m + 8LL * nd + (c > 1 ? 2LL : 1LL) * 2LL * nd;
}

// The refine route (goicp_icp_refine): the rows of a transition that
// refine, each an ICP event of K seeds, in one launch.  A row's inputs are
// pointers of its own (the rows of a window or a batch share the bucket's
// padded shapes, not their tensors): the 15 pointers of ScoreArgs in its
// order, then the model, R_lanes (L, 3, 3), best_nodes (L, 4), ubs (L,),
// cand_R (3, 3) and cand_t (3,).
constexpr int kRefineMaxRows = 16;  // rows a launch carries in its parameters
constexpr int kRefineSlots = 21;
enum RefineSlot { kRsModel = 15, kRsLanes, kRsNodes, kRsUbs, kRsCandR,
                  kRsCandT };

struct RefineRow {
  unsigned long long p[kRefineSlots];
  int j;                         // the record's row
  int gap_lo;                    // record rows [gap_lo, j) take the dummy
};

struct RefineParams {
  ScoreArgs a;                   // the shared ints and floats (no pointers)
  RefineRow rows[kRefineMaxRows];
  PickOut rec;                   // the refine record
  float* rows_ws;                // per row: kRowWords (K + 1) + 12 K words
  unsigned* tickets;             // per row, 0 between launches
  const unsigned char* enabled;  // one flag for every row, or null
  int K, L, n_rows;
  int lane_off;                  // the staged lanes' words in shared memory
  int tail_lo, tail_hi;          // record rows the launch's last row resets
  int icp_padded;                // the ICP reads data_mask
  int icp_count;                 // the ICP reads counts[1]
};

// a refine row's words in rows_ws: the K rescored rows and the candidate's
// count (kRowWords each), then the K results' R (9 each) and t (3 each)
__host__ __device__ __forceinline__ int refine_row_words(int K) {
  return kRowWords * (K + 1) + 12 * K;
}

// a refine row's lanes staged in shared memory: ubs (L), R_lanes (9 L),
// best_nodes (4 L)
__host__ __device__ __forceinline__ int refine_lane_words(int L) {
  return 14 * L;
}

// The initial route (goicp_icp_init): the pair's rescoring block with its
// pointers, the state's tensors the pick writes (route kInit), the row's
// words (refine_row_words(K)) and ticket in device memory, the seeds K.
struct InitParams {
  ScoreArgs a;
  PickOut out;
  float* words;
  unsigned* ticket;              // 0 between launches
  int K;
};

struct IcpParams {
  const float* data;             // (Nd, 3)
  const float* model;            // (M, 3)
  const float* R0;               // (K, 3, 3)
  const float* t0;               // (K, 3)
  const float* data_mask;        // (Nd,) or null
  const float* count;            // a scalar or null
  const unsigned char* enabled;  // (K,) or null
  float* workspace;              // K rows' workspaces (C = 1) or null
  float* R_out;
  float* t_out;
  long long* nn_out;
  float* err_out;
  int* iters_out;
  int nd, m, inlier_num, max_iter, mode;
  int cluster;                   // C, the blocks of a row
  float err_diff;
};

// one fixed-order sum over the points by the calling warp: lane t adds
// term(t), term(t + 32), ... from +0.0, then the xor butterfly
template <typename Term>
__device__ __forceinline__ float warp_ordered_sum(int nd, Term term) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll 4
  for (int i = lane; i < nd; i += 32) acc = __fadd_rn(acc, term(i));
  return warp_sum(acc);
}

// where block r of the row keeps the word that lies at x in this block's
// workspace (x itself for C = 1, whose workspace may be in device memory)
template <typename T>
__device__ __forceinline__ T* at_rank(cg::cluster_group& cluster, T* x,
                                      int r, int c) {
  return c > 1 ? cluster.map_shared_rank(x, r) : x;
}

// the cluster's barrier in two halves: the arrival releases this thread's
// writes (to any block's shared memory), the wait acquires the others'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// R p + t of one data point, each coordinate a dot3_warp
__device__ __forceinline__ void rotate_point(const float* R, const float* t,
                                             const float* x, float* q) {
#pragma unroll
  for (int r = 0; r < 3; ++r) q[r] = __fadd_rn(dot3_warp(R + 3 * r, x), t[r]);
}

// A refine row's prologue (every block of each of its clusters alike, in
// place of icp_seeds_kernel), in two halves around the block's first
// barrier.  refine_stage, beside the workspace's loads: the row's L ubs,
// R_lanes and best nodes staged into shared memory (s_lanes), once; and
// block 0 of the row's cluster 0 sets the record's rows below j that do
// not refine (in the launch's last row also those above it) to the
// dummy.  refine_seed, after the barrier: each thread ranks a lane by
// counting the lanes that sort before it, reading the ubs from shared
// memory; the lane of rank k gives cluster k its start, R0 its R_lanes
// row and t0 = c + w / 2 of its best node.
__device__ __forceinline__ void refine_stage(const RefineParams& rp, int rr,
                                             bool first, float* s_lanes) {
  const RefineRow& q = rp.rows[rr];
  const float* ubs = reinterpret_cast<const float*>(q.p[kRsUbs]);
  const float* R_lanes = reinterpret_cast<const float*>(q.p[kRsLanes]);
  const float* nodes = reinterpret_cast<const float*>(q.p[kRsNodes]);
  const int tid = threadIdx.x, L = rp.L;
  for (int i = tid; i < L; i += kIcpThreads) s_lanes[i] = __ldg(ubs + i);
  for (int i = tid; i < 9 * L; i += kIcpThreads)
    s_lanes[L + i] = __ldg(R_lanes + i);
  for (int i = tid; i < 4 * L; i += kIcpThreads)
    s_lanes[10 * L + i] = __ldg(nodes + i);
  if (first) {
    for (int r = q.gap_lo + tid; r < q.j; r += kIcpThreads)
      dummy_row(rp.rec, r);
    if (rr == rp.n_rows - 1)
      for (int r = rp.tail_lo + tid; r < rp.tail_hi; r += kIcpThreads)
        dummy_row(rp.rec, r);
  }
}

__device__ __forceinline__ void refine_seed(int L, int k,
                                            const float* s_lanes, float* sR,
                                            float* st) {
  for (int i = threadIdx.x; i < L; i += kIcpThreads) {
    const float u = s_lanes[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) rank += sorts_before(s_lanes[j], j, u, i);
    if (rank == k) {
      const float* Ri = s_lanes + L + 9 * i;
      const float* ni = s_lanes + 10 * L + 4 * i;
#pragma unroll
      for (int e = 0; e < 9; ++e) sR[e] = Ri[e];
      const float half = __fdiv_rn(ni[3], 2.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) st[c] = __fadd_rn(ni[c], half);
    }
  }
}

// The refine row's ScoreArgs: the shared ints and floats, the row's
// pointers
__device__ __forceinline__ ScoreArgs refine_score_args(const RefineParams& rp,
                                                       int rr) {
  ScoreArgs a = rp.a;
  const unsigned long long* p = rp.rows[rr].p;
  a.data = reinterpret_cast<const float*>(p[0]);
  a.weights = reinterpret_cast<const float*>(p[1]);
  a.mask = reinterpret_cast<const float*>(p[2]);
  a.dist = reinterpret_cast<const float*>(p[3]);
  a.nearest = reinterpret_cast<const int*>(p[4]);
  a.consts = reinterpret_cast<const float*>(p[5]);
  a.data_props = reinterpret_cast<const int*>(p[6]);
  a.model_props = reinterpret_cast<const int*>(p[7]);
  a.compat = reinterpret_cast<const unsigned char*>(p[8]);
  a.data_nbrs = reinterpret_cast<const int*>(p[9]);
  a.model_nbrs = reinterpret_cast<const int*>(p[10]);
  a.data_fpfh = reinterpret_cast<const float*>(p[11]);
  a.model_fpfh = reinterpret_cast<const float*>(p[12]);
  a.table = reinterpret_cast<const unsigned char*>(p[13]);
  a.counts = reinterpret_cast<const float*>(p[14]);
  return a;
}

// A row's arrival (the refine and initial routes): after the block's
// barrier, one thread fences the block's words in the row's words (a
// release of what the barrier ordered before it) and takes n of the row's
// K + 1 tickets (the K rescorings and the extra row: the candidate's count
// or the initial error); the block with the last stages the words into
// shared memory (read past L1: other blocks wrote them), picks the first
// best seed with pick_write (pk: where, and the route), and sets the
// ticket back to 0 for the next launch.
__device__ __forceinline__ void row_arrive(unsigned* ticket, unsigned n,
                                           int K, const float* words,
                                           float* scratch, PickArgs pk) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, n) + n == static_cast<unsigned>(K + 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int e = tid; e < refine_row_words(K); e += kIcpThreads)
    scratch[e] = __ldcg(words + e);
  __syncthreads();
  if (tid == 0) {
    pk.R = scratch + kRowWords * (K + 1);
    pk.t = pk.R + 9 * K;
    pk.K = K;
    pick_write(pk, scratch, false);
    *ticket = 0u;
  }
}

// The ICP event of a row (icp_run_kernel: every row of the launch an ICP
// row; icp_refine_kernel: cluster q of the launch seed k = q % K of refine
// row q / K, with its prologue and epilogue; icp_init_kernel: cluster k <
// K seed k of the initial incumbent, with the epilogue, and cluster K the
// initial error).  The loop is the same code in every route.  ep: the
// route's parameters (RefineParams, InitParams; unused by kRouteRun).
template <int kRoute, typename Ep>
__device__ __forceinline__ void icp_event(const IcpParams& p, const Ep* ep) {
  constexpr bool kRefine = kRoute == kRouteRefine;
  extern __shared__ float dyn_smem[];
  __shared__ float sR[9], st[3], sums[16];
  __shared__ float s_err;
  __shared__ int s_it, s_run;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.cluster, nd = p.nd, m = p.m, mode = p.mode;
  const int rank = c > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int row = blockIdx.x / c, tid = threadIdx.x, warp = tid >> 5;
  const size_t rw = region_words(static_cast<size_t>(nd));
  float* ws = p.workspace == nullptr
                  ? dyn_smem
                  : p.workspace + row * icp_workspace_words(nd, m, c);
  if constexpr (kRoute == kRouteInit) {
    // the extra cluster: block 0 computes the initial error (the block
    // form; the ICP clusters run meanwhile), writes it as the row's extra
    // row and arrives
    if (row == ep->K) {
      if ((GOICP_REFINE_STOP == 1 && p.max_iter >= 0) || rank != 0) return;
      __shared__ RowShared ish;
      __shared__ float ires[kRowWords];
      score_row<kIcpThreads>(ep->a, kInitial, nullptr, nullptr, nullptr, 0,
                             ws, ws + rw, ish, ires);
      if (tid < kRowWords) ep->words[kRowWords * ep->K + tid] = ires[tid];
      if (GOICP_REFINE_STOP != 99 && p.max_iter >= 0) return;
      PickArgs pk = {};
      pk.out = ep->out;
      pk.route = kInit;
      row_arrive(ep->ticket, 1, ep->K, ep->words, dyn_smem, pk);
      return;
    }
  }
  // the row's inputs
  const float* data = p.data;
  const float* model = p.model;
  const float* data_mask = p.data_mask;
  const float* count = p.count;
  const unsigned char* enabled =
      p.enabled == nullptr ? nullptr : p.enabled + row;
  int rr = 0, k = row;
  if constexpr (kRefine) {
    rr = row / ep->K;
    k = row - rr * ep->K;
    const unsigned long long* q = ep->rows[rr].p;
    data = reinterpret_cast<const float*>(q[0]);
    model = reinterpret_cast<const float*>(q[kRsModel]);
    data_mask = ep->icp_padded ? reinterpret_cast<const float*>(q[2]) : nullptr;
    count = ep->icp_count ? reinterpret_cast<const float*>(q[14]) + 1 : nullptr;
    enabled = ep->enabled;
    refine_stage(*ep, rr, k == 0 && rank == 0, dyn_smem + ep->lane_off);
  }
  float* s_model = ws;
  float* s_qq = s_model + 3 * m;
  float* s_dmask = s_qq + m;
  float* s_mask = s_dmask + nd;
  float* s_data = s_mask + nd;
  float* s_pts = s_data + 3 * nd;
  float2* s_pair0 = reinterpret_cast<float2*>(s_pts + 3 * nd);
  // the block's share of the points: [lo, lo + nb)
  const int per = icp_share(nd, c), lo = rank * per;
  const int nb = max(0, min(nd - lo, per));
  // G threads a point: the largest power of two <= 32 that fits
  int g_log = 5;
  while (g_log > 0 && (nb << g_log) > kIcpThreads) --g_log;
  const int G = 1 << g_log, slots = kIcpThreads >> g_log;
  const int slot = tid >> g_log, g = tid & (G - 1);
  const bool trimmed = mode == kModeTrim || mode == kModeDynTrim;

  for (int i = tid; i < 3 * m; i += kIcpThreads)
    s_model[i] = __ldg(model + i);
  for (int i = tid; i < 3 * nd; i += kIcpThreads)
    s_data[i] = __ldg(data + i);
  for (int i = tid; i < nd; i += kIcpThreads) {
    const float dm = data_mask == nullptr ? 1.0f : __ldg(data_mask + i);
    s_dmask[i] = dm;
    if (!trimmed) s_mask[i] = mode == kModeCount ? dm : 1.0f;
  }
  if constexpr (!kRefine) {
    if (tid < 9) sR[tid] = __ldg(p.R0 + 9 * row + tid);
    if (tid < 3) st[tid] = __ldg(p.t0 + 3 * row + tid);
  }
  if (tid == 0) {
    s_err = -1.0f;
    s_it = 0;
    s_run = (enabled == nullptr || *enabled != 0) && p.max_iter > 0;
  }
  __syncthreads();
  if constexpr (kRefine) refine_seed(ep->L, k, dyn_smem + ep->lane_off, sR, st);
  for (int j = tid; j < m; j += kIcpThreads)
    s_qq[j] = dot3_warp(s_model + 3 * j, s_model + 3 * j);
  // the kept-set size: the count read on the device, or inlier_num
  const float cnt =
      count == nullptr ? static_cast<float>(p.inlier_num) : __ldg(count);
  const bool padded = data_mask != nullptr;
  // every block of the row has started before any writes to another
  if (c > 1)
    cluster.sync();
  else
    __syncthreads();

  while (s_run) {
    float2* s_pair = s_pair0 + (c > 1 ? (s_it & 1) * nd : 0);
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = sR[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = st[k];
    // a share point's (d2, NN index), clamped, 1e12 where padded, sent to
    // every block of the row by the lanes g, g + G, ... < C
    auto send = [&](int li, float best, int arg) {
      const int i = lo + li;
      best = clamp_min(best, 0.0f);
      if (padded && !(s_dmask[i] > 0.0f)) best = 1.0e12f;
      const float2 v = make_float2(best, __int_as_float(arg));
      for (int r = g; r < c; r += G) at_rank(cluster, s_pair, r, c)[i] = v;
    };
    // 1-2. the nearest model point of each point of the share
    if (G == 1) {
      // one thread a point: two points at once, each model point's loads
      // shared between them
      for (int la = slot; la < nb; la += 2 * slots) {
        const int lb = la + slots < nb ? la + slots : la;
        float qa[3], qb[3];
        rotate_point(R, t, s_data + 3 * (lo + la), qa);
        rotate_point(R, t, s_data + 3 * (lo + lb), qb);
        const float ppa = dot3_warp(qa, qa), ppb = dot3_warp(qb, qb);
        float ba = sq_dist_from(ppa, dot3_warp(qa, s_model), s_qq[0]);
        float bb = sq_dist_from(ppb, dot3_warp(qb, s_model), s_qq[0]);
        int aa = 0, ab = 0;
#pragma unroll 4
        for (int j = 1; j < m; ++j) {
          const float mj[3] = {s_model[3 * j], s_model[3 * j + 1],
                               s_model[3 * j + 2]};
          const float qqj = s_qq[j];
          const float da = sq_dist_from(ppa, dot3_warp(qa, mj), qqj);
          const float db = sq_dist_from(ppb, dot3_warp(qb, mj), qqj);
          if (da < ba) {
            ba = da;
            aa = j;
          }
          if (db < bb) {
            bb = db;
            ab = j;
          }
        }
        send(la, ba, aa);
        if (lb != la) send(lb, bb, ab);
      }
    } else {
      // G threads a point, thread g scanning j = g (mod G)
      for (int base = 0; base < nb; base += slots) {
        const int li = base + slot;
        const bool live = li < nb;
        float best = __int_as_float(0x7f800000);  // +inf
        int arg = INT_MAX;
        if (live) {
          float q[3];
          rotate_point(R, t, s_data + 3 * (lo + li), q);
          const float pp = dot3_warp(q, q);
          if (g < m) {
            best = sq_dist_from(pp, dot3_warp(q, s_model + 3 * g), s_qq[g]);
            arg = g;
          }
#pragma unroll 4
          for (int j = g + G; j < m; j += G) {
            const float d =
                sq_dist_from(pp, dot3_warp(q, s_model + 3 * j), s_qq[j]);
            if (d < best) {
              best = d;
              arg = j;
            }
          }
        }
        // the G partial first minima, combined by (d, j)
        for (int off = G >> 1; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
          if (ob < best || (ob == best && oa < arg)) {
            best = ob;
            arg = oa;
          }
        }
        if (live) send(li, best, arg);
      }
    }
    // while the pairs travel: every point's rotation, kept by each block
    // for its sums (the same expression as the share's, the same bits)
    if (c > 1) cluster_arrive();
    for (int i = tid; i < nd; i += kIcpThreads)
      rotate_point(R, t, s_data + 3 * i, s_pts + 3 * i);
    __syncthreads();
    if (c > 1) cluster_wait();
    ICP_STOP_AFTER(1)
    // 3. the trimmed modes' mask: the share's stable ranks, G threads a
    // point counting over j = g (mod G), each sent to every block, then
    // the row's second barrier
    if (trimmed) {
      for (int base = 0; base < nb; base += slots) {
        const int li = base + slot;
        const int i = lo + li;
        int rank_i = 0;
        if (li < nb) {
          const float di = s_pair[i].x;
          for (int j = g; j < nd; j += G) {
            const float dj = s_pair[j].x;
            rank_i += (dj < di) || (dj == di && j < i);
          }
        }
        for (int off = G >> 1; off > 0; off >>= 1)
          rank_i += __shfl_xor_sync(0xffffffffu, rank_i, off);
        if (li < nb) {
          const float keep = (mode == kModeTrim
                                  ? rank_i < p.inlier_num
                                  : __int2float_rn(rank_i) < cnt)
                                 ? 1.0f
                                 : 0.0f;
          for (int r = g; r < c; r += G)
            at_rank(cluster, s_mask, r, c)[i] = keep;
        }
      }
      if (c > 1)
        cluster.sync();
      else
        __syncthreads();
    }
    ICP_STOP_AFTER(2)
    // 4. err_new, the masked sums of the points and of their matches
    auto nn = [&](int i) { return __float_as_int(s_pair[i].y); };
    if (warp < 7) {
      float s;
      if (warp == 0) {
        s = warp_ordered_sum(
            nd, [&](int i) { return __fmul_rn(s_pair[i].x, s_mask[i]); });
      } else if (warp < 4) {
        const int a = warp - 1;
        s = warp_ordered_sum(nd, [&](int i) {
          return __fmul_rn(s_pts[3 * i + a], s_mask[i]);
        });
      } else {
        const int a = warp - 4;
        s = warp_ordered_sum(nd, [&](int i) {
          return __fmul_rn(s_model[3 * nn(i) + a], s_mask[i]);
        });
      }
      if ((tid & 31) == 0) sums[warp] = s;
    }
    __syncthreads();
    ICP_STOP_AFTER(3)
    float mu_d[3], mu_m[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mu_d[a] = __fdiv_rn(sums[1 + a], cnt);
      mu_m[a] = __fdiv_rn(sums[4 + a], cnt);
    }
    // H[a][b] = sum_i ((pts_i - mu_d) m_i)[a] ((model[nn_i] - mu_m) m_i)[b]
    // (the warp's means picked into registers: an array indexed by a
    // runtime index would lie in a stack frame)
    for (int e = warp; e < 9; e += kIcpWarps) {
      const int a = e / 3, b = e % 3;
      const float md = a == 0 ? mu_d[0] : (a == 1 ? mu_d[1] : mu_d[2]);
      const float mm = b == 0 ? mu_m[0] : (b == 1 ? mu_m[1] : mu_m[2]);
      const float s = warp_ordered_sum(nd, [&](int i) {
        const float qd =
            __fmul_rn(__fsub_rn(s_pts[3 * i + a], md), s_mask[i]);
        const float qm = __fmul_rn(
            __fsub_rn(s_model[3 * nn(i) + b], mm), s_mask[i]);
        return __fmul_rn(qd, qm);
      });
      if ((tid & 31) == 0) sums[7 + e] = s;
    }
    __syncthreads();
    ICP_STOP_AFTER(4)
    // 5-6. the convergence test, the Kabsch and the update (one thread of
    // every block, alike)
    if (tid == 0) {
      const float err_new = sums[0];
      const bool conv = s_err > 0.0f && __fsub_rn(s_err, err_new) <
                                            __fmul_rn(p.err_diff, cnt);
      if (!conv) {
        float H[9], Rk[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) H[k] = sums[7 + k];
        kabsch_from_H(H, Rk);
        float t_[3], Rn[9], tn[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          t_[r] = __fsub_rn(mu_m[r], dot3_warp(Rk + 3 * r, mu_d));
          tn[r] = __fadd_rn(dot3_warp(Rk + 3 * r, t), t_[r]);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float col[3] = {R[j], R[3 + j], R[6 + j]};
            Rn[3 * r + j] = dot3_warp(Rk + 3 * r, col);
          }
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) sR[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) st[k] = tn[k];
      }
      s_err = err_new;
      s_it += 1;
      s_run = !conv && s_it < p.max_iter;
    }
    __syncthreads();
  }

  // the NN index from the last iteration (0 where none ran)
  const float2* s_last =
      s_pair0 + (c > 1 && s_it > 0 ? ((s_it - 1) & 1) * nd : 0);
  if constexpr (kRoute == kRouteRun) {
    if (rank == 0) {
      if (tid < 9) p.R_out[9 * row + tid] = sR[tid];
      if (tid < 3) p.t_out[3 * row + tid] = st[tid];
      if (tid == 0) {
        p.err_out[row] = s_err;
        p.iters_out[row] = s_it;
      }
    }
    for (int li = tid; li < nb; li += kIcpThreads)
      p.nn_out[static_cast<long long>(row) * nd + lo + li] =
          s_it > 0 ? __float_as_int(s_last[lo + li].y) : 0;
  } else {
    // the epilogue, in place of the pick's launch: the seed's result
    // rescored (kFull at the ICP's R, t and NN indices) and, in the refine
    // route's seed-0 cluster, the BnB candidate's count; the row's words
    // (the rescored rows, each seed's R and t) written and the row's
    // ticket taken, the last arrival picking.  C > 1: the cluster form,
    // every block its share of the points; C = 1: the block form, the
    // workspace (shared or device memory) free after the loop.
    if (GOICP_REFINE_STOP == 1 && p.max_iter >= 0) return;
    __shared__ RowShared sh;
    __shared__ float res[kRowWords], cres[kRowWords];
    const int K = ep->K;
    const bool full = GOICP_REFINE_STOP == 99 || p.max_iter < 0;
    ScoreArgs a;
    float* words;
    unsigned* ticket;
    PickArgs pk = {};
    const float* cand_R = nullptr;
    const float* cand_t = nullptr;
    if constexpr (kRefine) {
      a = refine_score_args(*ep, rr);
      words = ep->rows_ws + static_cast<size_t>(rr) * refine_row_words(K);
      ticket = ep->tickets + rr;
      pk.out = ep->rec;
      pk.j = ep->rows[rr].j;
      pk.route = kPick;
      if (k == 0) {
        cand_R = reinterpret_cast<const float*>(ep->rows[rr].p[kRsCandR]);
        cand_t = reinterpret_cast<const float*>(ep->rows[rr].p[kRsCandT]);
      }
    } else {
      a = ep->a;
      words = ep->words;
      ticket = ep->ticket;
      pk.out = ep->out;
      pk.route = kInit;
    }
    if (rank == 0) {
      if (tid < 9) words[kRowWords * (K + 1) + 9 * k + tid] = sR[tid];
      if (tid < 3) words[kRowWords * (K + 1) + 9 * K + 3 * k + tid] = st[tid];
    }
    if (c > 1) {
      // the split rescoring's words: the values over the data mask, the
      // ranked values and the c-FPFH values over the pair copy the loop's
      // last iteration did not use.  No block reads either after its
      // arrival at that iteration's first barrier, which every block
      // passed before its loop ended; so the rescoring needs no barrier
      // of its own before it writes into another block
      float* other = reinterpret_cast<float*>(s_pair0 + (s_it & 1) * nd);
      const bool holds = score_row_cluster<kIcpThreads, GOICP_REFINE_STOP>(
          a, sR, st, s_it > 0 ? s_last : nullptr, s_data, cand_R, cand_t, c,
          rank, lo, nb, s_dmask, other, other + nd, sh, res, cres);
      if (holds) {
        if (tid < kRowWords) {
          words[kRowWords * k + tid] = res[tid];
          if (cand_R != nullptr) words[kRowWords * K + tid] = cres[tid];
        }
        if (full)
          row_arrive(ticket, cand_R != nullptr ? 2 : 1, K, words, dyn_smem,
                     pk);
      }
      return;
    }
    int* nn = reinterpret_cast<int*>(ws + 2 * rw);   // clear of s_pair
    for (int i = tid; i < nd; i += kIcpThreads)
      nn[i] = s_it > 0 ? __float_as_int(s_last[i].y) : 0;
    __syncthreads();
    score_row<kIcpThreads>(a, kFull, sR, st, nn, 0, ws, ws + rw, sh, res);
    if (tid < kRowWords) words[kRowWords * k + tid] = res[tid];
    if (cand_R != nullptr) {
      score_row<kIcpThreads>(a, kCount, cand_R, cand_t, nullptr, 0, ws,
                             ws + rw, sh, res);
      if (tid < kRowWords) words[kRowWords * K + tid] = res[tid];
    }
    if (full) row_arrive(ticket, cand_R != nullptr ? 2 : 1, K, words,
                         dyn_smem, pk);
  }
}

__global__ void __launch_bounds__(kIcpThreads)
    icp_run_kernel(const __grid_constant__ IcpParams p) {
  icp_event<kRouteRun, int>(p, nullptr);
}

__global__ void __launch_bounds__(kIcpThreads)
    icp_refine_kernel(const __grid_constant__ IcpParams p,
                      const __grid_constant__ RefineParams rp) {
  icp_event<kRouteRefine>(p, &rp);
}

__global__ void __launch_bounds__(kIcpThreads)
    icp_init_kernel(const __grid_constant__ IcpParams p,
                    const __grid_constant__ InitParams ip) {
  icp_event<kRouteInit>(p, &ip);
}

}  // namespace goicp

// The ICP event of K rows (see the file's head).  data (nd, 3), model
// (m, 3), R0 (K, 3, 3), t0 (K, 3) float32; data_mask (nd,) or null;
// count a float32 scalar or null (then inlier_num is the kept-set size);
// enabled (K,) bytes or null; workspace K * (10 nd + 4 m) floats in
// device memory (then one block a row), or null for shared memory (that
// size at most kIcpSmemMax; a cluster of blocks a row where its larger
// workspace fits too); mode 0 untrimmed, 1 static trim, 2 data_mask, 3
// dynamic trim.  Writes R (K, 3, 3), t (K, 3), nn_idx (K, nd) int64, err
// (K,), iters (K,) int32.
extern "C" int goicp_icp_run(const float* data, const float* model,
                             const float* R0, const float* t0,
                             const float* data_mask, const float* count,
                             const unsigned char* enabled, float* workspace,
                             float* R, float* t, long long* nn_idx,
                             float* err, int* iters, int K, int nd, int m,
                             int inlier_num, int max_iter, int mode,
                             float err_diff, void* stream) {
  using namespace goicp;
  if (K <= 0) return 0;
  if (nd <= 0 || m <= 0 || mode < kModeAll || mode > kModeDynTrim)
    return static_cast<int>(cudaErrorInvalidValue);
  int c = 1;
  size_t smem = 0;
  if (workspace == nullptr) {
    c = (nd + kIcpPointsPerBlock - 1) / kIcpPointsPerBlock;
    if (c > kIcpClusterMax) c = kIcpClusterMax;
    smem = 4 * static_cast<size_t>(icp_workspace_words(nd, m, c));
    if (smem > kIcpSmemMax) {
      c = 1;
      smem = 4 * static_cast<size_t>(icp_workspace_words(nd, m, 1));
    }
    if (smem > kIcpSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    static size_t granted = 0;
    const cudaError_t e = allow_smem(icp_run_kernel, smem, &granted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  IcpParams p;
  p.data = data;
  p.model = model;
  p.R0 = R0;
  p.t0 = t0;
  p.data_mask = data_mask;
  p.count = count;
  p.enabled = enabled;
  p.workspace = workspace;
  p.R_out = R;
  p.t_out = t;
  p.nn_out = nn_idx;
  p.err_out = err;
  p.iters_out = iters;
  p.nd = nd;
  p.m = m;
  p.inlier_num = inlier_num;
  p.max_iter = max_iter;
  p.mode = mode;
  p.cluster = c;
  p.err_diff = err_diff;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(K * c);
  cfg.blockDim = dim3(kIcpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, icp_run_kernel, p);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

// kabsch_from_H of `batch` row-major 3x3 H, one thread each
extern "C" int goicp_kabsch3(const float* H, float* R, long long batch,
                             void* stream) {
  using namespace goicp;
  if (batch <= 0) return 0;
  const long long blocks = (batch + kKabschThreads - 1) / kKabschThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kabsch3_kernel<<<static_cast<unsigned>(blocks), kKabschThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(H, R, batch);
  return static_cast<int>(cudaGetLastError());
}

// The refine route: n rows of a transition that refine, each an ICP event
// from its K lowest-ub lanes, rescored and picked into its record row, in
// launches of at most kRefineMaxRows rows (grid: a row's K clusters of C
// blocks, as goicp_icp_run sizes them).  slots: n * 21 pointers (a row's
// RefineRow::p); j: the n record rows, ascending; ints: ScoreArgs' 13
// ints, then K, L, M, max_iter, mode, icp_padded, icp_count; floats:
// ScoreArgs' 4 floats, then err_diff; rec: the record's 7 pointers
// (PickOut's order) and its rows n_rec (those not in j take the dummy);
// rows_ws kRefineMaxRows * refine_row_words(K) floats and tickets
// kRefineMaxRows words (0) in device memory; enabled: one byte for every
// row, or null; workspace: K * kRefineMaxRows * (10 Nd + 4 M) floats in
// device memory (one block a row), or null for shared memory.
extern "C" int goicp_icp_refine(const unsigned long long* slots,
                                const int* j, int n, const int* ints,
                                const float* floats,
                                const unsigned long long* rec, int n_rec,
                                float* rows_ws, void* tickets,
                                const unsigned char* enabled,
                                float* workspace, void* stream) {
  using namespace goicp;
  if (n <= 0) return 0;
  const ScoreArgs a = score_args(slots, ints, floats);
  const int K = ints[13], L = ints[14], m = ints[15], nd = a.nd;
  const int mode = ints[17];
  bool ok = nd > 0 && m > 0 && K > 0 && K <= L && mode >= kModeAll &&
            mode <= kModeDynTrim && rec != nullptr && rows_ws != nullptr &&
            tickets != nullptr && n <= n_rec;
  for (int r = 0; r < n && ok; ++r)
    ok = j[r] >= (r == 0 ? 0 : j[r - 1] + 1) && j[r] < n_rec;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // the blocks of an ICP row, as goicp_icp_run sizes them; shared memory
  // holds the workspace, the prologue's lanes past it, and after the loop
  // the pick's staged words
  const size_t lanes = refine_lane_words(L), staged = refine_row_words(K);
  int c = 1;
  size_t words = std::max(lanes, staged), lane_off = 0;
  if (workspace == nullptr) {
    c = (nd + kIcpPointsPerBlock - 1) / kIcpPointsPerBlock;
    if (c > kIcpClusterMax) c = kIcpClusterMax;
    if (4 * (icp_workspace_words(nd, m, c) + lanes) > kIcpSmemMax) c = 1;
    lane_off = static_cast<size_t>(icp_workspace_words(nd, m, c));
    words = std::max(lane_off + lanes, staged);
  }
  const size_t smem = 4 * words;
  if (smem > kIcpSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;
  cudaError_t err = allow_smem(icp_refine_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  IcpParams p = {};
  p.workspace = workspace;
  p.nd = nd;
  p.m = m;
  p.inlier_num = a.inlier_num;
  p.max_iter = ints[16];
  p.mode = mode;
  p.cluster = c;
  p.err_diff = floats[4];
  RefineParams rp;
  rp.a = a;
  rp.rec = pick_out(rec);
  rp.rows_ws = rows_ws;
  rp.tickets = static_cast<unsigned*>(tickets);
  rp.enabled = enabled;
  rp.K = K;
  rp.L = L;
  rp.lane_off = static_cast<int>(lane_off);
  rp.icp_padded = ints[18];
  rp.icp_count = ints[19];
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kIcpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int r0 = 0; r0 < n; r0 += kRefineMaxRows) {
    const int rows = std::min(n - r0, kRefineMaxRows);
    for (int r = 0; r < rows; ++r) {
      RefineRow& q = rp.rows[r];
      for (int e = 0; e < kRefineSlots; ++e)
        q.p[e] = slots[static_cast<size_t>(r0 + r) * kRefineSlots + e];
      q.j = j[r0 + r];
      q.gap_lo = r0 + r == 0 ? 0 : j[r0 + r - 1] + 1;
    }
    rp.n_rows = rows;
    const bool last = r0 + rows == n;
    rp.tail_lo = last ? j[n - 1] + 1 : 0;
    rp.tail_hi = last ? n_rec : 0;
    cfg.gridDim = dim3(static_cast<unsigned>(rows * K * c));
    err = cudaLaunchKernelEx(&cfg, icp_refine_kernel, p, rp);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The initial route: a pair's initial incumbent in one launch (grid: K
// clusters of C blocks, as goicp_icp_run sizes them, each seed k's ICP
// event from R0[k], t0[k] and its rescoring; one more cluster whose block
// 0 computes the initial error; the last of the K + 1 arrivals picks with
// route kInit).  slots, floats: the pair's rescoring block as goicp_score
// takes it (15 pointers; 4 floats, then err_diff); ints: its 13 ints,
// then K, L (unused), M, max_iter, mode, icp_padded, icp_count, as
// goicp_icp_refine takes them; model (M, 3), R0 (K, 3, 3), t0 (K, 3);
// out: PickOut's 7 pointers (opt_R, opt_t, opt_err, terms, comp, unused,
// last_icp); words refine_row_words(K) floats and ticket (one word, 0)
// in device memory; workspace (K + 1) * (10 Nd + 4 M) floats in device
// memory (one block a row), or null for shared memory.
extern "C" int goicp_icp_init(const unsigned long long* slots,
                              const int* ints, const float* floats,
                              const float* model, const float* R0,
                              const float* t0,
                              const unsigned long long* out, float* words,
                              void* ticket, float* workspace, void* stream) {
  using namespace goicp;
  const ScoreArgs a = score_args(slots, ints, floats);
  const int K = ints[13], m = ints[15], nd = a.nd, mode = ints[17];
  if (nd <= 0 || m <= 0 || K <= 0 || mode < kModeAll || mode > kModeDynTrim ||
      out == nullptr || words == nullptr || ticket == nullptr ||
      model == nullptr || R0 == nullptr || t0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t staged = refine_row_words(K);
  int c = 1;
  size_t ws_words = 0;
  if (workspace == nullptr) {
    c = (nd + kIcpPointsPerBlock - 1) / kIcpPointsPerBlock;
    if (c > kIcpClusterMax) c = kIcpClusterMax;
    if (4 * icp_workspace_words(nd, m, c) > kIcpSmemMax) c = 1;
    ws_words = static_cast<size_t>(icp_workspace_words(nd, m, c));
  }
  const size_t smem = 4 * std::max(ws_words, staged);
  if (smem > kIcpSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;
  cudaError_t err = allow_smem(icp_init_kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  IcpParams p = {};
  p.data = a.data;
  p.model = model;
  p.R0 = R0;
  p.t0 = t0;
  p.data_mask = ints[18] ? a.mask : nullptr;
  p.count = ints[19] ? a.counts + 1 : nullptr;
  p.workspace = workspace;
  p.nd = nd;
  p.m = m;
  p.inlier_num = a.inlier_num;
  p.max_iter = ints[16];
  p.mode = mode;
  p.cluster = c;
  p.err_diff = floats[4];
  InitParams ip;
  ip.a = a;
  ip.out = pick_out(out);
  ip.words = words;
  ip.ticket = static_cast<unsigned*>(ticket);
  ip.K = K;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>((K + 1) * c));
  cfg.blockDim = dim3(kIcpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, icp_init_kernel, p, ip);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
