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
#include "common.cuh"

namespace goicp {

struct ChemParams {
  const float* pts;          // (L, Nd, 3)
  const float* corners;      // (L, Q, 3)
  const float* cell_compat;  // (C, 9), or (W, C, 9) with lane_pair
  const float* prop_onehot;  // (Nd, 9), or (W, Nd, 9)
  const float* data_mask;    // (Nd,), or (W, Nd)
  const int* nearest_cell;   // (S^3,), or (W, S^3)
  const float* consts;       // (5,), or (W, 5)
  const int* lane_pair;      // (L,) pair of each lane (K4) or null (K2)
  float* out;                // (L, Q)
  int L, Q, Nd, C, n_vox;    // n_vox = S^3
  int per_block, blocks_per_lane;
  int stage_tables, stage_points;
};

// One block = one lane and corners [q0, q0 + per_block) of it, one warp
// per corner at a time.  `pair` selects the table rows (always 0 for K2).
__device__ __forceinline__ void chem_incomp_body(const ChemParams& p,
                                                 int lane, int pair) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pts = reinterpret_cast<float*>(smem);
  float* s_onehot = s_pts + (p.stage_points ? region_words(3 * p.Nd) : 0);
  float* s_mask = s_onehot + (p.stage_points ? region_words(9 * p.Nd) : 0);
  int* s_table = reinterpret_cast<int*>(
      s_mask + (p.stage_points ? region_words(p.Nd) : 0));
  float* s_compat = reinterpret_cast<float*>(s_table + region_words(p.n_vox));

  const size_t pr = static_cast<size_t>(pair);
  const bool pts_staged = p.stage_points, tab_staged = p.stage_tables;
  const float* g_pts = p.pts + static_cast<size_t>(lane) * p.Nd * 3;
  const float* g_onehot = p.prop_onehot + pr * p.Nd * 9;
  const float* g_mask = p.data_mask + pr * p.Nd;
  const int* g_table = p.nearest_cell + pr * p.n_vox;
  const float* g_compat = p.cell_compat + pr * p.C * 9;

  // the point data first, the tables behind it: the first corner's
  // voxelization needs only the former
  if (pts_staged) {
    async_copy_words(s_pts, g_pts, 3 * p.Nd);
    async_copy_words(s_onehot, g_onehot, 9 * p.Nd);
    async_copy_words(s_mask, g_mask, p.Nd);
  }
  async_commit();
  if (tab_staged) {
    async_copy_words(s_table, g_table, p.n_vox);
    async_copy_words(s_compat, g_compat, 9 * p.C);
  }
  async_commit();
  // shared or device memory, chosen once: the loads below go through
  // generic pointers and carry no branch
  const float* pts = pts_staged ? s_pts : g_pts;
  const float* onehot = pts_staged ? s_onehot : g_onehot;
  const float* mask = pts_staged ? s_mask : g_mask;
  const int* table = tab_staged ? s_table : g_table;
  const float* compat = tab_staged ? s_compat : g_compat;

  const GridConsts g = load_consts(p.consts + pr * 5);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int q0 = (blockIdx.x % p.blocks_per_lane) * p.per_block;
  const int q_end = min(q0 + p.per_block, p.Q);
  const int q_first = q0 + warp;

  // flat clamped voxels of points tid + 32 (j0 + u).  Past the row's end
  // the last point stands in (no branch; its count is dropped below).
  auto voxelize = [&](const float (&c)[3], int j0, int (&flat)[kChunk]) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float* pt = pts + 3 * min(tid + 32 * (j0 + u), p.Nd - 1);
      const int vx = clamp_voxel(voxel_raw(pt[0], c[0], g.lo[0], g.scale), g.size);
      const int vy = clamp_voxel(voxel_raw(pt[1], c[1], g.lo[1], g.scale), g.size);
      const int vz = clamp_voxel(voxel_raw(pt[2], c[2], g.lo[2], g.scale), g.size);
      flat[u] = flat_voxel(vx, vy, vz, g.size);
    }
  };

  // a corner is read one corner ahead of its use, so that the load's
  // latency hides under the corner before
  float c[3] = {0.0f, 0.0f, 0.0f}, c_next[3] = {0.0f, 0.0f, 0.0f};
  auto read_corner = [&](int q, float (&cor)[3]) {
    if (q < q_end) {
      const size_t o = 3 * (static_cast<size_t>(lane) * p.Q + q);
#pragma unroll
      for (int a = 0; a < 3; ++a) cor[a] = __ldg(p.corners + o + a);
    }
  };
  read_corner(q_first, c_next);

  async_wait<1>();
  __syncthreads();
  int flat[kChunk];
  if (q_first < q_end) voxelize(c_next, 0, flat);
  async_wait<0>();
  __syncthreads();

  const int per_thread = (p.Nd + 31) >> 5;
  for (int q = q_first; q < q_end; q += warps) {
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = c_next[a];
    read_corner(q + warps, c_next);
    int count = 0;
    for (int j0 = 0; j0 < per_thread; j0 += kChunk) {
      if (q != q_first || j0 != 0) voxelize(c, j0, flat);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = tid + 32 * (j0 + u);
        const float* oh = onehot + 9 * min(i, p.Nd - 1);
        const float* h = compat + 9 * static_cast<size_t>(table[flat[u]]);
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          s = __fadd_rn(s, __fmul_rn(oh[k], h[k]));
        const float m = mask[min(i, p.Nd - 1)];
        const int inc = __float2int_rn(__fsub_rn(m > 0.0f ? 1.0f : 0.0f, s));
        count += i < p.Nd ? inc : 0;
      }
    }
    count = warp_sum(count);
    if (tid == 0)
      p.out[static_cast<size_t>(lane) * p.Q + q] = static_cast<float>(count);
  }
}

__global__ void chem_incomp_kernel(ChemParams p) {
  chem_incomp_body(p, blockIdx.x / p.blocks_per_lane, 0);
}

__global__ void chem_incomp_lanes_kernel(ChemParams p) {
  const int lane = blockIdx.x / p.blocks_per_lane;
  chem_incomp_body(p, lane, p.lane_pair[lane]);
}

// Shared memory: the lane's point data (13 words a point) when it fits,
// then the pair's tables when they fit beside it.
template <typename Kernel>
int launch_chem(Kernel kernel, size_t* granted, ChemParams p, int size,
                void* stream) {
  p.n_vox = size * size * size;
  const size_t points = region_words(3 * p.Nd) + region_words(9 * p.Nd) +
                        region_words(p.Nd);
  const size_t tables = region_words(p.n_vox) + region_words(9 * p.C);
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
