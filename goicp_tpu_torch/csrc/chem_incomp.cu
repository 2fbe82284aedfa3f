// K2 and K4: per-corner chemical incompatibility counts, with one table
// set for all lanes (K2) or one per lane (K4).
//
// K2 replaces goicp_tpu/bounds/pallas_eval.py::chem_incomp_kernel (:702),
// K4 ::chem_incomp_kernel_lanes (:778); both share the body _chem_kernel
// (:410) there and chem_incomp_body here.  For each (lane, corner): the
// number of real data points whose property is incompatible with the
// nearest occupied cell of their CLAMPED voxel,
// voxel = trunc((p + corner - lo) * scale + 0.5):
//   cell(i) = nearest_cell[voxel_i], the pair's EDT argmin over the occupied
//             cells (ties went to the smallest cell index when the table was
//             built);
//   inc(i)  = [mask_i > 0] - sum_k onehot[i, k] * cell_compat[cell(i), k];
//   out     = sum_i inc(i), an integer, stored as f32.
//
// The TPU kernel recomputes cell(i) as a minimum over all cells on the MXU
// because a gather is what a TPU does badly.  On the H100 the gather is
// the cheap operation and the scan the expensive one, so this kernel reads
// the table the pair was prepared with: per (corner, point) one
// voxelization, one table read and a 9-wide dot.  That is ~0.6 M lookups
// at the streams' shape (16 lanes x 152 corners x 256 points), far below a
// microsecond of arithmetic.  What bounds the kernel on this card is
// latency, not throughput: a launch takes ~7.5 us there against ~0.9 us
// for an empty kernel (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, from a
// CUDA graph): the block's tables arriving from L2 (a 32 KB nearest-cell
// table at S = 20, 9 KB of cell_compat rows, 13 KB of point data), then
// ~1 us of one warp's dependent chain for each of its corners.  The
// design answers with few, fat blocks: a block serves ONE lane and a run
// of its corners, one warp per corner at a time, so the tables are staged
// once per block (one to three blocks per SM) and not once per corner;
// the staging is asynchronous (cp.async) and the first corner's
// voxelization runs under the table's copy; a corner is read one corner
// ahead; the per-point code holds no branch, so that the loads of a
// chunk's eight points overlap.  Counts are integers summed by warp
// shuffles: exact and order-free.  Tables that do not fit a block's
// 227 KB (S >= ~38) stay in device memory and are read from there
// (through L1); the launcher decides from S, C and Nd, and the kernel is
// the same: it follows one pointer or the other.
//
// K4 serves the cross-pair streams: the tables stay per pair ((W, S^3),
// (W, C, 9), (W, Nd, 9), (W, Nd), (W, 5)) and a block follows
// lane_pair[lane] to its pair's rows instead of reading gathered copies.
// The body (chem_incomp_body) lives in chem_body.cuh, which the inner step
// (inner.cu) includes too.
#include "chem_body.cuh"

namespace goicp {

// One block = one lane and corners [q0, q0 + per_block) of it.
__device__ __forceinline__ void chem_incomp_block(const ChemParams& p,
                                                  int lane, int pair) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = (blockIdx.x % p.blocks_per_lane) * p.per_block;
  chem_incomp_body<false>(p, lane, pair, chem_stage(p, lane, pair, smem, true),
                          q0, min(q0 + p.per_block, p.Q), p.corners, p.out);
}

__global__ void chem_incomp_kernel(ChemParams p) {
  chem_incomp_block(p, blockIdx.x / p.blocks_per_lane, 0);
}

__global__ void chem_incomp_lanes_kernel(ChemParams p) {
  const int lane = blockIdx.x / p.blocks_per_lane;
  chem_incomp_block(p, lane, p.lane_pair[lane]);
}

// Shared memory: the lane's point data (13 words a point) when it fits,
// then the pair's tables when they fit beside it.
template <typename Kernel>
int launch_chem(Kernel kernel, size_t* granted, ChemParams p, int size,
                void* stream) {
  p.n_vox = size * size * size;
  const size_t points = chem_points_words(p);
  const size_t tables = chem_tables_words(p);
  size_t words = 0;
  p.stage_points = 4 * points <= kMaxDynamicSmem;
  if (p.stage_points) words += points;
  p.stage_tables = 4 * (words + tables) <= kMaxDynamicSmem;
  if (p.stage_tables) words += tables;
  const cudaError_t err = allow_smem(kernel, 4 * words, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BlockPlan plan = plan_blocks(p.L, p.Q, 8);
  p.per_block = plan.per_block;
  p.blocks_per_lane = plan.blocks_per_lane;
  kernel<<<p.L * plan.blocks_per_lane, 32 * plan.warps, 4 * words,
            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace goicp

extern "C" int goicp_chem_incomp(const float* pts, const float* corners,
                                 const float* cell_compat,
                                 const float* prop_onehot,
                                 const float* data_mask,
                                 const int* nearest_cell, const float* consts,
                                 float* out, int L, int Q, int Nd, int C,
                                 int size, void* stream) {
  using namespace goicp;
  ChemParams p{pts, corners, cell_compat, prop_onehot, data_mask,
               nearest_cell, consts, nullptr, out, L, Q, Nd, C};
  static size_t granted = 0;
  return launch_chem(chem_incomp_kernel, &granted, p, size, stream);
}

// K4: tables per pair, followed through lane_pair.
extern "C" int goicp_chem_incomp_lanes(
    const float* pts, const float* corners, const float* cell_compat,
    const float* prop_onehot, const float* data_mask,
    const int* nearest_cell, const float* consts, const int* lane_pair,
    float* out, int L, int Q, int Nd, int C, int size, void* stream) {
  using namespace goicp;
  ChemParams p{pts, corners, cell_compat, prop_onehot, data_mask,
               nearest_cell, consts, lane_pair, out, L, Q, Nd, C};
  static size_t granted = 0;
  return launch_chem(chem_incomp_lanes_kernel, &granted, p, size, stream);
}
