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
// The body (geom_bounds_body) lives in geom_body.cuh, which the inner step
// (inner.cu) includes too.
#include "geom_body.cuh"

namespace goicp {

// One block = one lane and nodes [n0, n0 + per_block) of it.
__device__ __forceinline__ void geom_bounds_block(const GeomParams& p,
                                                  int lane, int pair) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = (blockIdx.x % p.blocks_per_lane) * p.per_block;
  geom_bounds_body<false>(p, lane, pair, geom_stage(p, lane, pair, smem, true),
                          n0, min(n0 + p.per_block, p.B), p.centers,
                          p.widths, p.out0, p.out1, p.out2);
}

__global__ void geom_bounds_kernel(GeomParams p) {
  geom_bounds_block(p, blockIdx.x / p.blocks_per_lane, 0);
}

__global__ void geom_bounds_lanes_kernel(GeomParams p) {
  const int lane = blockIdx.x / p.blocks_per_lane;
  geom_bounds_block(p, lane, p.lane_pair[lane]);
}

// Shared memory: one or two scratch rows per warp when trimming rows of
// more than 256 points (fewer warps for rows so long that those of eight
// warps do not fit), then the lane's point data when it fits, then the pair's tables when they fit
// beside it.
template <typename Kernel>
int launch_geom(Kernel kernel, size_t* granted, GeomParams p, int size,
                void* stream) {
  p.n_vox = size * size * size;
  const size_t rows = geom_rows_words(p, 1);
  const size_t points = geom_points_words(p);
  const size_t tables = geom_tables_words(p);
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
