// K2: per-corner chemical incompatibility counts.
//
// Replaces goicp_tpu/bounds/pallas_eval.py::chem_incomp_kernel (:702, body
// _chem_kernel :410).  For each (lane, corner): the number of real data
// points whose property is incompatible with the nearest occupied cell of
// their CLAMPED voxel, voxel = trunc((p + corner - lo) * scale + 0.5):
//   cell(i) = argmin over occupied cells of (|voxel_i - cell|^2, cell index)
//             (ties go to the smallest index, as in the EDT's argmin);
//   inc(i)  = [mask_i > 0] - sum_k onehot[i, k] * cell_compat[cell(i), k];
//   out     = sum_i inc(i), an integer, stored as f32.
//
// What bounds it on the H100: as K1, the (points x cells) integer argmin
// (8 lanes x 152 corners x 320 points x ~320 cells = ~125 M squared
// distances per main-path launch); inputs are a few hundred KB and the
// output a few KB, so it is compute- and latency-bound.  One block per
// (lane, corner), cells staged through shared memory in tiles and read as
// broadcasts, the running (d2, index) minimum of every point in shared
// memory, and an integer block sum (exact and order-free).  The TPU
// kernel's parity-bit key encoding is an MXU device and is not carried
// over: the argmin is a lexicographic int32 comparison.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace goicp {

struct ChemParams {
  const float* pts;          // (L, Nd, 3)
  const float* corners;      // (L, Q, 3)
  const float* cell_compat;  // (C, 9)
  const float* prop_onehot;  // (Nd, 9)
  const float* data_mask;    // (Nd,)
  const int* cells;          // (C, 3)
  const float* consts;       // (5,)
  float* out;                // (L, Q)
  int L, Q, Nd, C;
};

__global__ void chem_incomp_kernel(ChemParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tile = reinterpret_cast<int4*>(smem);               // kCellTile
  int* best_d = reinterpret_cast<int*>(tile + kCellTile);   // Nd
  int* best_i = best_d + p.Nd;                              // Nd
  int* voxs = best_i + p.Nd;                                // Nd
  __shared__ int red[32];

  const int lane = blockIdx.x / p.Q;
  const int q = blockIdx.x % p.Q;
  const GridConsts g = load_consts(p.consts);
  const float* pts = p.pts + static_cast<size_t>(lane) * p.Nd * 3;
  const float* cor = p.corners + (static_cast<size_t>(lane) * p.Q + q) * 3;
  const float c0 = cor[0], c1 = cor[1], c2 = cor[2];

  for (int i = threadIdx.x; i < p.Nd; i += blockDim.x) {
    const int vx = clamp_voxel(voxel_raw(pts[3 * i], c0, g.lo[0], g.scale), g.size);
    const int vy = clamp_voxel(voxel_raw(pts[3 * i + 1], c1, g.lo[1], g.scale), g.size);
    const int vz = clamp_voxel(voxel_raw(pts[3 * i + 2], c2, g.lo[2], g.scale), g.size);
    voxs[i] = vx | (vy << 10) | (vz << 20);
    best_d[i] = INT_MAX;
    best_i[i] = 0;
  }

  for (int start = 0; start < p.C; start += kCellTile) {
    const int n = min(kCellTile, p.C - start);
    __syncthreads();
    load_cell_tile(p.cells, start, n, g.size, tile);
    __syncthreads();
    for (int i = threadIdx.x; i < p.Nd; i += blockDim.x) {
      const int v = voxs[i];
      const int vx = v & 1023, vy = (v >> 10) & 1023, vz = v >> 20;
      int bd = best_d[i], bi = best_i[i];
      // cells in increasing index order + strict '<': the first minimum wins
      for (int c = 0; c < n; ++c) {
        const int d = cell_d2(tile[c], vx, vy, vz);
        if (d < bd) { bd = d; bi = start + c; }
      }
      best_d[i] = bd;
      best_i[i] = bi;
    }
  }
  __syncthreads();

  int count = 0;
  for (int i = threadIdx.x; i < p.Nd; i += blockDim.x) {
    const float* oh = p.prop_onehot + static_cast<size_t>(i) * 9;
    const float* h = p.cell_compat + static_cast<size_t>(best_i[i]) * 9;
    float s = 0.0f;
    for (int k = 0; k < 9; ++k) s = __fadd_rn(s, __fmul_rn(oh[k], h[k]));
    const float inc = __fsub_rn(p.data_mask[i] > 0.0f ? 1.0f : 0.0f, s);
    count += __float2int_rn(inc);
  }
  count = block_sum(count, red);
  if (threadIdx.x == 0)
    p.out[static_cast<size_t>(lane) * p.Q + q] = static_cast<float>(count);
}

}  // namespace goicp

extern "C" int goicp_chem_incomp(const float* pts, const float* corners,
                                 const float* cell_compat,
                                 const float* prop_onehot,
                                 const float* data_mask, const int* cells,
                                 const float* consts, float* out, int L,
                                 int Q, int Nd, int C, void* stream) {
  using namespace goicp;
  ChemParams p{pts, corners, cell_compat, prop_onehot, data_mask, cells,
               consts, out, L, Q, Nd, C};
  const size_t smem = kCellTile * sizeof(int4) + 3 * sizeof(int) * Nd;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chem_incomp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = std::min(256, std::max(32, (Nd + 31) / 32 * 32));
  chem_incomp_kernel<<<L * Q, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
