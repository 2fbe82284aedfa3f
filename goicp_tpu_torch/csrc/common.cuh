// Shared device helpers of the bound kernels (geom_bounds.cu,
// chem_incomp.cu).
//
// Voxelization must round exactly as the torch gather path and the JAX
// package do: pos = pts + center, then trunc((pos - lo) * scale + 0.5).
// nvcc contracts a*b+c into one FMA by default, which rounds once instead
// of twice and moves voxel boundaries, so every step below is an explicit
// round-to-nearest intrinsic that the compiler may not fuse.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace goicp {

// cells staged through shared memory per tile
constexpr int kCellTile = 512;
// coordinate of a cell that must never win a minimum (padding cells lie
// outside [0, S)); 3 * kFarCell^2 still fits int32
constexpr int kFarCell = 16384;

struct GridConsts {
  float lo[3];
  float scale;
  int size;
};

__device__ __forceinline__ GridConsts load_consts(const float* consts) {
  GridConsts g;
  g.lo[0] = consts[0];
  g.lo[1] = consts[1];
  g.lo[2] = consts[2];
  g.scale = consts[3];
  g.size = static_cast<int>(consts[4]);
  return g;
}

// ROUND((p + c - lo) * scale) = trunc(x + 0.5), as a float
__device__ __forceinline__ float voxel_raw(float p, float c, float lo,
                                           float scale) {
  const float pos = __fadd_rn(p, c);
  return truncf(__fadd_rn(__fmul_rn(__fsub_rn(pos, lo), scale), 0.5f));
}

__device__ __forceinline__ int clamp_voxel(float raw, int size) {
  const float hi = static_cast<float>(size - 1);
  return static_cast<int>(fminf(fmaxf(raw, 0.0f), hi));
}

// Stage cells [start, start + n) of the (C, 3) int32 table into shared
// memory; cells outside [0, size) become far sentinels.
__device__ __forceinline__ void load_cell_tile(const int* cells, int start,
                                               int n, int size,
                                               int4* tile) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int* c = cells + 3 * (start + i);
    int4 v = make_int4(c[0], c[1], c[2], 0);
    const bool ok = v.x >= 0 && v.x < size && v.y >= 0 && v.y < size &&
                    v.z >= 0 && v.z < size;
    if (!ok) v = make_int4(kFarCell, kFarCell, kFarCell, 0);
    tile[i] = v;
  }
}

__device__ __forceinline__ int cell_d2(int4 c, int vx, int vy, int vz) {
  const int dx = vx - c.x, dy = vy - c.y, dz = vz - c.z;
  return dx * dx + dy * dy + dz * dz;
}

// Fixed-order block sum (deterministic for a given blockDim, which is a
// multiple of 32).  `scratch` holds one value per warp.  Ends synchronized.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < n_warps; ++w) total += scratch[w];
  __syncthreads();
  return total;   // valid in thread 0
}

}  // namespace goicp
