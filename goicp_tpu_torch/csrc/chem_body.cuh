// The incompatibility-count body of K2 and K4 (chem_incomp.cu), shared
// with the inner step (inner.cu), which runs it on the lattice corners it
// builds in shared memory: one source, so that the standalone kernels and
// the step compile the same per-point code (point_incomp, which the
// transition's root corners in transition.cu run too).  What it computes and why it
// is laid out so is written in chem_incomp.cu.
#pragma once

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

// One point's incompatibility: round((mask > 0) - onehot . compat[cell]),
// the dot product summed in order from 0, one rounding a step.
__device__ __forceinline__ int point_incomp(const float* oh, const float* h,
                                            float m) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) s = __fadd_rn(s, __fmul_rn(oh[k], h[k]));
  return __float2int_rn(__fsub_rn(m > 0.0f ? 1.0f : 0.0f, s));
}

// Words of shared memory the body lays out from `smem`: the point data and
// the tables where the stage flags say so.
__host__ __device__ __forceinline__ size_t chem_points_words(
    const ChemParams& p) {
  return region_words(3 * p.Nd) + region_words(9 * p.Nd) +
         region_words(p.Nd);
}

__host__ __device__ __forceinline__ size_t chem_tables_words(
    const ChemParams& p) {
  return region_words(p.n_vox) + region_words(9 * p.C);
}

// The corners [q0, q_end) of one lane, one warp per corner at a time,
// called by the whole block.  `pair` selects the table rows (always 0 for
// K2).  kLocal = false: the corners and the counts are the lane's rows of
// (L, Q) arrays in device memory (K2, K4); kLocal = true: arrays of this
// block indexed by the corner alone, which may lie in shared memory (the
// inner step).
template <bool kLocal>
__device__ __forceinline__ void chem_incomp_body(
    const ChemParams& p, int lane, int pair, unsigned char* smem, int q0,
    int q_end, const float* corners, float* out) {
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
  auto corner_at = [&](int q) -> size_t {
    return kLocal ? static_cast<size_t>(q)
                  : static_cast<size_t>(lane) * p.Q + q;
  };
  auto read_corner = [&](int q, float (&cor)[3]) {
    if (q < q_end) {
      const size_t o = 3 * corner_at(q);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        cor[a] = kLocal ? corners[o + a] : __ldg(corners + o + a);
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
        const int inc = point_incomp(
            onehot + 9 * min(i, p.Nd - 1),
            compat + 9 * static_cast<size_t>(table[flat[u]]),
            mask[min(i, p.Nd - 1)]);
        count += i < p.Nd ? inc : 0;
      }
    }
    count = warp_sum(count);
    if (tid == 0) out[corner_at(q)] = static_cast<float>(count);
  }
}

}  // namespace goicp
