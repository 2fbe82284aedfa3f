// K1 and K3: geometric translation-node bounds (all modes of the TPU
// kernel), with one table set for all lanes (K1) or one per lane (K3).
//
// K1 replaces goicp_tpu/bounds/pallas_eval.py::geometric_bounds_kernel
// (:517), K3 ::geometric_bounds_kernel_lanes (:632); both share the body
// _geom_kernel (:310) there and geom_bounds_body here.  For each (lane,
// node, point):
//   voxel = trunc((p + c - lo) * scale + 0.5), clamped to the grid;
//   d     = sqrt(|voxel - cells[nearest_cell[voxel]]|^2) / scale, plus the
//           out-of-bounds extension sqrt(sum excess^2) / scale;
//   dis   = w * d.
// Per node, with f(x) = x (norm 1) or x^2 (norm 2):
//   plain:  ub = sum f(dis'), lb = sum f(max(dis' - sqrt(3)/2 w, 0)), where
//           dis' = max(dis - rot_unc, 0) (or max(dis, 0) without rot_unc);
//   fused:  ub = sum f(dis), ubu = sum f(disu), lbu = sum f(max(disu -
//           sqrt(3)/2 w, 0)), with disu = max(dis - rot_unc, 0).
// Trimmed modes sum only the K smallest real points of each row (dis and
// disu each ordered on its own; zero-weight padding counts as +inf): K
// static (trim_k) or read on the device from trim_count, so the inlier
// count never goes through the host.
//
// The TPU kernel recomputes the exact-EDT value as a minimum over all
// occupied cells on the MXU, because a gather is what a TPU does badly.  On
// the H100 the gather is the cheap operation and the scan the expensive one
// (an int32 min over ~256 cells per point), so this kernel reads the
// nearest-cell table the pair was prepared with (the EDT's own argmin):
// per (node, point) one voxelization, one table read, one int32 squared
// distance to that one cell, and the same IEEE sqrt and division as
// before, so every per-point distance keeps its bits.  That is ~0.26 M
// lookups at the streams' shape (16 lanes x 64 nodes x 256 points), far
// below a microsecond of arithmetic.  What bounds the kernel on this card
// is latency, not throughput: a launch takes ~7.5 us there against ~0.9 us
// for an empty kernel (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, from a
// CUDA graph): first the block's point data arriving from L2, then one
// warp's dependent chain through its node, eight points a thread through
// voxelization, table, cell, and an IEEE sqrt and division each (every
// further node a warp takes adds ~4 us).  The design answers with few,
// fat blocks: a block serves ONE lane and a run of its nodes, one warp
// per node at a time, so the tables are staged once per block (one to
// three blocks per SM) and not once per node; the staging is asynchronous
// (cp.async) and the first node's voxelization runs under the table's
// copy; a node's center is read one node ahead; the per-point code holds
// no branch on a run-time flag (selects instead), so that the loads and
// the sqrt/division chains of a chunk's eight points overlap; sqrt and
// division never see a 0, which would send them through their
// special-case paths.  Sums are taken inside a warp, per thread in point
// order and then by shuffles in a fixed order: no atomics and no block
// barrier after the staging, so results repeat bit for bit and do not
// depend on how nodes were split over blocks.  Trimmed rows are not
// sorted: the warp keeps the row in its registers (up to 256 points,
// eight a thread; longer rows go to a shared-memory scratch of the warp's
// own), finds the K-th smallest value by a 31-step bisection on the float
// bits (non-negative floats order as their bit patterns; counts by warp
// reduction), and sums what lies below it plus the ties still needed
// (+3 us at the streams' shape).  Tables that do not fit a block's 227 KB
// (S >= ~38) stay in device memory and are read from there (through L1);
// the launcher decides from S, C and Nd, and the kernel is the same: it
// follows one pointer or the other.
//
// K3 serves the cross-pair streams, where every lane may belong to another
// registration pair.  The TPU kernel takes gathered per-lane copies of the
// tables because a block spec can only slice; here the tables stay per pair
// ((W, Nd) weights, (W, C, 3) cells, (W, S^3) nearest cells, (W, 5) consts,
// (W,) trim counts) and a block follows lane_pair[lane] to its pair's rows,
// so no table is copied.
#include "common.cuh"

namespace goicp {

constexpr float kHalfSqrt3 = 0.8660254037844386f;   // f32(sqrt(3) / 2)

struct GeomParams {
  const float* pts;         // (L, Nd, 3)
  const float* centers;     // (L, B, 3)
  const float* widths;      // (L, B)
  const float* rot_unc;     // (L, Nd) or null
  const float* weights;     // (Nd,), or (W, Nd) with lane_pair
  const int* cells;         // (C, 3), or (W, C, 3)
  const int* nearest_cell;  // (S^3,), or (W, S^3): row of `cells` per voxel
  const float* consts;      // (5,) [x_min, y_min, z_min, scale, size],
                            // or (W, 5)
  const float* trim_count;  // device scalar K (dynamic trim), (W,), or null
  const int* lane_pair;     // (L,) pair of each lane (K3) or null (K1)
  float* out0;              // (L, B) ub
  float* out1;              // (L, B) lb (plain) / ubu (fused)
  float* out2;              // (L, B) lbu (fused) or null
  int L, B, Nd, C;
  int norm, fused, trim_k;
  int n_vox;                // S^3
  int per_block, blocks_per_lane;
  int stage_tables, stage_points;
};

__device__ __forceinline__ float fnorm(float v, int norm) {
  return norm == 2 ? __fmul_rn(v, v) : v;
}

// words of one warp's scratch row: Nd rounded up to whole chunks of every
// thread, so that the loops over a row are unrolled without a bounds test;
// the slots past Nd hold +inf
__host__ __device__ __forceinline__ size_t row_words_of(int nd) {
  const size_t step = 32 * kChunk;
  return (nd + step - 1) / step * step;
}

// The trimmed sums of one node.  A row is seen through get(r, c, u): the
// value of row r at point tid + 32 (c kChunk + u), held in this thread's
// registers (rows of one chunk) or in the warp's shared-memory scratch
// (longer rows); slots past the row's end and padding points read +inf.
//
// K-th smallest (1 <= K <= number of slots) of each of R rows of n_chunks
// chunks, as bit patterns: the largest t with count(v < t) < K, built
// from the top bit down.  Non-negative floats (+inf included) order as
// their bits.  Called by a whole warp.
template <int R, typename Get>
__device__ __forceinline__ void kth_smallest(Get get, int n_chunks, int K,
                                             int (&t)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = 0;
  for (int bit = 30; bit >= 0; --bit) {
    int below[R];
#pragma unroll
    for (int r = 0; r < R; ++r) below[r] = 0;
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          below[r] += __float_as_int(get(r, c, u)) < (t[r] | (1 << bit));
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (__reduce_add_sync(0xffffffffu, below[r]) < K) t[r] |= 1 << bit;
  }
}

// Sum of f(v) and of f(max(v - s3w, 0)) over the K smallest values of a
// row (get(c, u)) whose K-th smallest has the bits `kth`: everything below
// it, plus as many copies of it as are still missing.  Called by a whole
// warp.
template <typename Get>
__device__ __forceinline__ void sum_k_smallest(Get get, int n_chunks, int K,
                                               int kth, float s3w, int norm,
                                               float& sum, float& sum_lb) {
  float a = 0.0f, b = 0.0f;
  int below = 0;
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float v = get(c, u);
      const bool keep = __float_as_int(v) < kth;
      const float fv = fnorm(v, norm);
      const float fl = fnorm(fmaxf(__fsub_rn(v, s3w), 0.0f), norm);
      a = __fadd_rn(a, keep ? fv : 0.0f);
      b = __fadd_rn(b, keep ? fl : 0.0f);
      below += keep;
    }
  }
  const float ties = static_cast<float>(K - warp_sum(below));
  const float tv = __int_as_float(kth);
  sum = __fadd_rn(warp_sum(a), __fmul_rn(ties, fnorm(tv, norm)));
  sum_lb = __fadd_rn(
      warp_sum(b),
      __fmul_rn(ties, fnorm(fmaxf(__fsub_rn(tv, s3w), 0.0f), norm)));
}

// Both selections and the three (two) sums of a trimmed node: fused takes
// dis (row 0) for ub and disu (row 1) for ubu and lbu, plain takes its one
// row for ub and lb.
template <typename Get>
__device__ __forceinline__ void trimmed_sums(Get get, int n_chunks, int K,
                                             bool fused, float s3w, int norm,
                                             float& a0, float& a1,
                                             float& a2) {
  auto row0 = [&](int c, int u) { return get(0, c, u); };
  if (fused) {
    auto row1 = [&](int c, int u) { return get(1, c, u); };
    int kth[2];
    float unused;
    kth_smallest<2>(get, n_chunks, K, kth);
    sum_k_smallest(row0, n_chunks, K, kth[0], s3w, norm, a0, unused);
    sum_k_smallest(row1, n_chunks, K, kth[1], s3w, norm, a1, a2);
  } else {
    int kth[1];
    kth_smallest<1>(get, n_chunks, K, kth);
    sum_k_smallest(row0, n_chunks, K, kth[0], s3w, norm, a0, a1);
  }
}

// One block = one lane and nodes [n0, n0 + per_block) of it, one warp per
// node at a time.  `pair` selects the table rows (always 0 for K1).
__device__ __forceinline__ void geom_bounds_body(const GeomParams& p,
                                                 int lane, int pair) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const bool trim = p.trim_k > 0 || p.trim_count != nullptr;
  const bool pts_staged = p.stage_points, tab_staged = p.stage_tables;
  const bool with_unc = p.rot_unc != nullptr;
  const size_t nd_words = region_words(p.Nd);
  const size_t row_words = row_words_of(p.Nd);
  const int per_thread = (p.Nd + 31) >> 5;
  // trimmed rows longer than one chunk a thread live in shared memory
  const int n_rows = trim && per_thread > kChunk ? (p.fused ? 2 : 1) : 0;

  float* s_rows = reinterpret_cast<float*>(smem);   // warps x n_rows rows
  float* s_pts = s_rows + warps * n_rows * row_words;
  float* s_w = s_pts + (pts_staged ? region_words(3 * p.Nd) : 0);
  float* s_ru = s_w + (pts_staged ? nd_words : 0);
  int* s_table = reinterpret_cast<int*>(
      s_ru + (pts_staged && with_unc ? nd_words : 0));
  int* s_cells = s_table + region_words(p.n_vox);

  const size_t pr = static_cast<size_t>(pair);
  const float* g_pts = p.pts + static_cast<size_t>(lane) * p.Nd * 3;
  const float* g_w = p.weights + pr * p.Nd;
  const float* g_ru = with_unc ? p.rot_unc + static_cast<size_t>(lane) * p.Nd
                               : nullptr;
  const int* g_table = p.nearest_cell + pr * p.n_vox;
  const int* g_cells = p.cells + pr * p.C * 3;

  // the point data first, the tables behind it: the first node's
  // voxelization needs only the former
  if (pts_staged) {
    async_copy_words(s_pts, g_pts, 3 * p.Nd);
    async_copy_words(s_w, g_w, p.Nd);
    if (with_unc) async_copy_words(s_ru, g_ru, p.Nd);
  }
  async_commit();
  if (tab_staged) {
    async_copy_words(s_table, g_table, p.n_vox);
    async_copy_words(s_cells, g_cells, 3 * p.C);
  }
  async_commit();
  // shared or device memory, chosen once: the loads below go through
  // generic pointers and carry no branch
  const float* pts = pts_staged ? s_pts : g_pts;
  const float* weights = pts_staged ? s_w : g_w;
  const float* ru = pts_staged ? s_ru : g_ru;
  const int* table = tab_staged ? s_table : g_table;
  const int* cells = tab_staged ? s_cells : g_cells;

  const GridConsts g = load_consts(p.consts + pr * 5);
  const int n0 = (blockIdx.x % p.blocks_per_lane) * p.per_block;
  const int n_end = min(n0 + p.per_block, p.B);
  const int n_first = n0 + warp;
  const float inf = __int_as_float(0x7f800000);
  float* row_dis = s_rows + warp * n_rows * row_words;
  float* row_disu = row_dis + row_words;
  for (int i = p.Nd + tid; i < n_rows * row_words; i += 32)
    if (i % row_words >= p.Nd) row_dis[i] = inf;   // the rows' tails

  // points tid + 32 (j0 + u) of a node: clamped voxel packed 10 bits per
  // axis (S <= 1024) and the squared out-of-bounds excess (0 inside the
  // grid).  Past the row's end the last point stands in (no branch; what
  // it yields is dropped below).
  auto voxelize = [&](const float (&c)[3], int j0, int (&vox)[kChunk],
                      float (&excess)[kChunk]) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float* pt = pts + 3 * min(tid + 32 * (j0 + u), p.Nd - 1);
      int v[3];
      float ex[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float raw = voxel_raw(pt[a], c[a], g.lo[a], g.scale);
        v[a] = clamp_voxel(raw, g.size);
        const int r = static_cast<int>(raw);
        ex[a] = r < 0 ? static_cast<float>(r)
                      : (r >= g.size ? static_cast<float>(r - g.size + 1)
                                     : 0.0f);
      }
      vox[u] = v[0] | (v[1] << 10) | (v[2] << 20);
      excess[u] = __fadd_rn(
          __fadd_rn(__fmul_rn(ex[0], ex[0]), __fmul_rn(ex[1], ex[1])),
          __fmul_rn(ex[2], ex[2]));
    }
  };

  // a node's center and sqrt(3)/2 of its width, read one node ahead of
  // their use so that the loads' latency hides under the node before
  float c[3] = {0.0f, 0.0f, 0.0f}, c_next[3] = {0.0f, 0.0f, 0.0f};
  float s3w = 0.0f, s3w_next = 0.0f;
  auto read_node = [&](int node, float (&cen)[3], float& half_diag) {
    if (node < n_end) {
      const size_t o = static_cast<size_t>(lane) * p.B + node;
#pragma unroll
      for (int a = 0; a < 3; ++a) cen[a] = __ldg(p.centers + 3 * o + a);
      half_diag = __fmul_rn(kHalfSqrt3, __ldg(p.widths + o));
    }
  };
  read_node(n_first, c_next, s3w_next);

  async_wait<1>();
  __syncthreads();
  int vox[kChunk];
  float excess[kChunk];
  if (n_first < n_end) voxelize(c_next, 0, vox, excess);
  async_wait<0>();
  __syncthreads();

  const float* trim_count =
      p.trim_count != nullptr ? p.trim_count + pair : nullptr;
  const int n_chunks = (per_thread + kChunk - 1) / kChunk;

  for (int node = n_first; node < n_end; node += warps) {
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = c_next[a];
    s3w = s3w_next;
    read_node(node + warps, c_next, s3w_next);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    float ds[kChunk], du[kChunk];   // dis and disu of the chunk's points
    for (int j0 = 0; j0 < per_thread; j0 += kChunk) {
      if (node != n_first || j0 != 0) voxelize(c, j0, vox, excess);
      // the out-of-bounds extension sqrt(excess) / scale: +0 inside the
      // grid, where the sqrt and the division are skipped for the chunk.
      // (excess is 0 or a sum of integer squares >= 1: the max keeps the
      // IEEE routines off their special-case paths for 0.)
      bool outside = false;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) outside = outside || excess[u] > 0.0f;
      if (outside) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float e = __fdiv_rn(__fsqrt_rn(fmaxf(excess[u], 1.0f)),
                                    g.scale);
          excess[u] = excess[u] > 0.0f ? e : 0.0f;
        }
      }
      // per-point distances: no branch in here, so that the loads and the
      // IEEE sqrt and division of the chunk's points overlap
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int ic = min(tid + 32 * (j0 + u), p.Nd - 1);
        const int vx = vox[u] & 1023, vy = (vox[u] >> 10) & 1023,
                  vz = vox[u] >> 20;
        const int* cell = cells + 3 * static_cast<size_t>(
            table[flat_voxel(vx, vy, vz, g.size)]);
        const int dx = vx - cell[0], dy = vy - cell[1], dz = vz - cell[2];
        const int d2 = dx * dx + dy * dy + dz * dz;
        // sqrt(0) / scale = +0 without the special-case paths of the IEEE
        // routines
        const float dist = __fdiv_rn(
            __fsqrt_rn(static_cast<float>(max(d2, 1))), g.scale);
        const float d = __fadd_rn(d2 == 0 ? 0.0f : dist, excess[u]);
        const float w = weights[ic];
        const float dw = __fmul_rn(w, d);
        const float dwu = fmaxf(__fsub_rn(dw, with_unc ? ru[ic] : 0.0f), 0.0f);
        ds[u] = p.fused ? dw : dwu;
        du[u] = dwu;
        if (trim && !(w > 0.0f)) ds[u] = du[u] = inf;
      }
      if (!trim) {
        // a stand-in past the row's end adds +0, which changes nothing
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const bool in_row = tid + 32 * (j0 + u) < p.Nd;
          const float lb =
              fnorm(fmaxf(__fsub_rn(du[u], s3w), 0.0f), p.norm);
          a0 = __fadd_rn(a0, in_row ? fnorm(ds[u], p.norm) : 0.0f);
          if (p.fused) {
            a1 = __fadd_rn(a1, in_row ? fnorm(du[u], p.norm) : 0.0f);
            a2 = __fadd_rn(a2, in_row ? lb : 0.0f);
          } else {
            a1 = __fadd_rn(a1, in_row ? lb : 0.0f);
          }
        }
      } else if (n_chunks == 1) {
        // the whole row stays in this warp's registers
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (tid + 32 * u >= p.Nd) ds[u] = du[u] = inf;
      } else {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int i = tid + 32 * (j0 + u);
          if (i < p.Nd) {
            row_dis[i] = ds[u];
            if (p.fused) row_disu[i] = du[u];
          }
        }
      }
    }
    if (trim) {
      // ranks 0 .. K-1 are kept, K the count of ranks below the float K
      const float kf = trim_count != nullptr ? __ldg(trim_count)
                                             : static_cast<float>(p.trim_k);
      const int K = !(kf > 0.0f) ? 0
          : (kf >= static_cast<float>(p.Nd) ? p.Nd
                                            : static_cast<int>(ceilf(kf)));
      if (K > 0 && n_chunks == 1) {
        trimmed_sums([&](int r, int, int u) { return r == 0 ? ds[u] : du[u]; },
                     1, K, p.fused, s3w, p.norm, a0, a1, a2);
      } else if (K > 0) {
        __syncwarp();
        trimmed_sums(
            [&](int r, int c, int u) {
              return (r == 0 ? row_dis : row_disu)[tid + 32 * (c * kChunk + u)];
            },
            n_chunks, K, p.fused, s3w, p.norm, a0, a1, a2);
        __syncwarp();   // the rows are rewritten by the warp's next node
      }
    } else {
      a0 = warp_sum(a0);
      a1 = warp_sum(a1);
      if (p.fused) a2 = warp_sum(a2);
    }
    if (tid == 0) {
      const size_t o = static_cast<size_t>(lane) * p.B + node;
      p.out0[o] = a0;
      p.out1[o] = a1;
      if (p.fused) p.out2[o] = a2;
    }
  }
}

__global__ void geom_bounds_kernel(GeomParams p) {
  geom_bounds_body(p, blockIdx.x / p.blocks_per_lane, 0);
}

__global__ void geom_bounds_lanes_kernel(GeomParams p) {
  const int lane = blockIdx.x / p.blocks_per_lane;
  geom_bounds_body(p, lane, p.lane_pair[lane]);
}

// Shared memory: one or two scratch rows per warp when trimming rows of
// more than 256 points (fewer warps for rows so long that those of eight
// warps do not fit), then the lane's point data when it fits, then the pair's tables when they fit
// beside it.
template <typename Kernel>
int launch_geom(Kernel kernel, size_t* granted, GeomParams p, int size,
                void* stream) {
  p.n_vox = size * size * size;
  const bool trim = p.trim_k > 0 || p.trim_count != nullptr;
  const size_t row = region_words(p.Nd);
  const size_t rows = trim && p.Nd > 32 * kChunk
                          ? (p.fused ? 2 : 1) * row_words_of(p.Nd) : 0;
  const size_t points = region_words(3 * p.Nd) + row +
                        (p.rot_unc != nullptr ? row : 0);
  const size_t tables = region_words(p.n_vox) + region_words(3 * p.C);
  int max_warps = 8;
  while (max_warps > 1 && 4 * max_warps * rows > kMaxDynamicSmem)
    max_warps >>= 1;
  const BlockPlan plan = plan_blocks(p.L, p.B, max_warps);
  size_t words = plan.warps * rows;
  if (4 * words > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  p.stage_points = 4 * (words + points) <= kMaxDynamicSmem;
  if (p.stage_points) words += points;
  p.stage_tables = 4 * (words + tables) <= kMaxDynamicSmem;
  if (p.stage_tables) words += tables;
  const cudaError_t err = allow_smem(kernel, 4 * words, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.per_block = plan.per_block;
  p.blocks_per_lane = plan.blocks_per_lane;
  kernel<<<p.L * plan.blocks_per_lane, 32 * plan.warps, 4 * words,
            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace goicp

extern "C" int goicp_geom_bounds(const float* pts, const float* centers,
                                 const float* widths, const float* rot_unc,
                                 const float* weights, const int* cells,
                                 const int* nearest_cell, const float* consts,
                                 const float* trim_count, float* out0,
                                 float* out1, float* out2, int L, int B,
                                 int Nd, int C, int size, int norm, int fused,
                                 int trim_k, void* stream) {
  using namespace goicp;
  GeomParams p{pts, centers, widths, rot_unc, weights, cells, nearest_cell,
               consts, trim_count, nullptr, out0, out1, out2, L, B, Nd, C,
               norm, fused, trim_k};
  static size_t granted = 0;
  return launch_geom(geom_bounds_kernel, &granted, p, size, stream);
}

// K3: fused mode with rotation uncertainty; tables per pair, followed
// through lane_pair; trim_count (W,) per pair or null (no trimming).
extern "C" int goicp_geom_bounds_lanes(
    const float* pts, const float* centers, const float* widths,
    const float* rot_unc, const float* weights, const int* cells,
    const int* nearest_cell, const float* consts, const float* trim_count,
    const int* lane_pair, float* out0, float* out1, float* out2, int L,
    int B, int Nd, int C, int size, int norm, void* stream) {
  using namespace goicp;
  GeomParams p{pts, centers, widths, rot_unc, weights, cells, nearest_cell,
               consts, trim_count, lane_pair, out0, out1, out2, L, B, Nd, C,
               norm, 1, 0};
  static size_t granted = 0;
  return launch_geom(geom_bounds_lanes_kernel, &granted, p, size, stream);
}
