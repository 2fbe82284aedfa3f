// K2 and K4: per-corner chemical incompatibility counts, with one table
// set for all lanes (K2) or one per lane (K4).
//
// K2 replaces goicp_tpu/bounds/pallas_eval.py::chem_incomp_kernel (:702),
// K4 ::chem_incomp_kernel_lanes (:778); both share the body _chem_kernel
// (:410) there and chem_incomp_body here.  For each (lane, corner): the
// number of real data points whose property is incompatible with the
// nearest occupied cell of their CLAMPED voxel,
// voxel = trunc((p + corner - lo) * scale + 0.5):
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
//
// K4 serves the cross-pair streams: the tables stay per pair ((W, C, 9),
// (W, Nd, 9), (W, Nd), (W, C, 3), (W, 5)) and a block follows
// lane_pair[lane] to its pair's rows instead of reading gathered copies.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace goicp {

struct ChemParams {
  const float* pts;          // (L, Nd, 3)
  const float* corners;      // (L, Q, 3)
  const float* cell_compat;  // (C, 9), or (W, C, 9) with lane_pair
  const float* prop_onehot;  // (Nd, 9), or (W, Nd, 9)
  const float* data_mask;    // (Nd,), or (W, Nd)
  const int* cells;          // (C, 3), or (W, C, 3)
  const float* consts;       // (5,), or (W, 5)
  const int* lane_pair;      // (L,) pair of each lane (K4) or null (K2)
  float* out;                // (L, Q)
  int L, Q, Nd, C;
};

// The whole computation of one block = one (lane, corner).  `pair` selects
// the table rows (always 0 for K2).
__device__ __forceinline__ void chem_incomp_body(const ChemParams& p,
                                                 int pair) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tile = reinterpret_cast<int4*>(smem);               // kCellTile
  int* best_d = reinterpret_cast<int*>(tile + kCellTile);   // Nd
  int* best_i = best_d + p.Nd;                              // Nd
  int* voxs = best_i + p.Nd;                                // Nd
  __shared__ int red[32];

  const int lane = blockIdx.x / p.Q;
  const int q = blockIdx.x % p.Q;
  const size_t pr = static_cast<size_t>(pair);
  const float* cell_compat = p.cell_compat + pr * p.C * 9;
  const float* prop_onehot = p.prop_onehot + pr * p.Nd * 9;
  const float* data_mask = p.data_mask + pr * p.Nd;
  const int* cells = p.cells + pr * p.C * 3;
  const GridConsts g = load_consts(p.consts + pr * 5);
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
    load_cell_tile(cells, start, n, g.size, tile);
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
    const float* oh = prop_onehot + static_cast<size_t>(i) * 9;
    const float* h = cell_compat + static_cast<size_t>(best_i[i]) * 9;
    float s = 0.0f;
    for (int k = 0; k < 9; ++k) s = __fadd_rn(s, __fmul_rn(oh[k], h[k]));
    const float inc = __fsub_rn(data_mask[i] > 0.0f ? 1.0f : 0.0f, s);
    count += __float2int_rn(inc);
  }
  count = block_sum(count, red);
  if (threadIdx.x == 0)
    p.out[static_cast<size_t>(lane) * p.Q + q] = static_cast<float>(count);
}

__global__ void chem_incomp_kernel(ChemParams p) { chem_incomp_body(p, 0); }

__global__ void chem_incomp_lanes_kernel(ChemParams p) {
  chem_incomp_body(p, p.lane_pair[blockIdx.x / p.Q]);
}

template <typename Kernel>
int launch_chem(Kernel kernel, const ChemParams& p, void* stream) {
  const size_t smem = kCellTile * sizeof(int4) + 3 * sizeof(int) * p.Nd;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = std::min(256, std::max(32, (p.Nd + 31) / 32 * 32));
  kernel<<<p.L * p.Q, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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
               consts, nullptr, out, L, Q, Nd, C};
  return launch_chem(chem_incomp_kernel, p, stream);
}

// K4: tables per pair, followed through lane_pair.
extern "C" int goicp_chem_incomp_lanes(
    const float* pts, const float* corners, const float* cell_compat,
    const float* prop_onehot, const float* data_mask, const int* cells,
    const float* consts, const int* lane_pair, float* out, int L, int Q,
    int Nd, int C, void* stream) {
  using namespace goicp;
  ChemParams p{pts, corners, cell_compat, prop_onehot, data_mask, cells,
               consts, lane_pair, out, L, Q, Nd, C};
  return launch_chem(chem_incomp_lanes_kernel, p, stream);
}
