// Shared device helpers of the bound kernels (geom_bounds.cu,
// chem_incomp.cu).
//
// Voxelization must round exactly as the torch gather path and the JAX
// package do: pos = pts + center, then trunc((pos - lo) * scale + 0.5).
// nvcc contracts a*b+c into one FMA by default, which rounds once instead
// of twice and moves voxel boundaries, so every step below is an explicit
// round-to-nearest intrinsic that the compiler may not fuse.
//
// Both kernels look the nearest occupied cell of a voxel up in the pair's
// nearest-cell table (Grid.nearest_cell, the EDT's own first-minimum
// argmin over the cells).  A block serves one lane and stages that lane's
// tables in shared memory once, with asynchronous copies (cp.async), for
// all the nodes or corners it evaluates: one warp per node.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace goicp {

// points of one row handled per thread between two table reads (the
// voxel indices of a chunk are held in registers)
constexpr int kChunk = 8;
// dynamic shared memory a block of sm_90 may opt in to
constexpr size_t kMaxDynamicSmem = 227 * 1024;

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

// index of voxel (vx, vy, vz) in the (S^3,) tables
__device__ __forceinline__ int flat_voxel(int vx, int vy, int vz, int size) {
  return (vz * size + vy) * size + vx;
}

// words (4 bytes) of a shared-memory region, rounded up to 16 bytes so
// that every region starts where a 16-byte cp.async may land
__host__ __device__ __forceinline__ size_t region_words(size_t n) {
  return (n + 3) & ~static_cast<size_t>(3);
}

// Start an asynchronous copy of n 32-bit words from device to shared
// memory, spread over the block's threads: 16-byte cp.async where both
// addresses allow, word by word otherwise (a table row of an odd-sized
// grid).  Complete after async_commit() ... async_wait<>() + __syncthreads().
__device__ __forceinline__ void async_copy_words(void* dst, const void* src,
                                                 int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const char* s = static_cast<const char*>(src);
  int done = 0;
  if (((d | reinterpret_cast<uintptr_t>(s)) & 15) == 0) {
    const int n16 = n >> 2;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + 16u * i),
                   "l"(s + 16 * static_cast<size_t>(i)));
    done = n16 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     d + 4u * i),
                 "l"(s + 4 * static_cast<size_t>(i)));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's committed groups are open
template <int kPending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Fixed-order sum over the 32 lanes of a warp; every lane gets the total.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// launch plan shared by both kernels (host)
// ---------------------------------------------------------------------------

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

struct BlockPlan {
  int warps;        // warps per block, one node at a time each
  int per_block;    // nodes of one lane served by a block
  int blocks_per_lane;
};

// Split `nodes` nodes per lane over blocks of `warps` warps.  Few lanes:
// halve the block until about every SM holds one; many nodes: give each
// warp several, so that a table is staged once for all of them and the
// grid stays within three blocks per SM (measured on the H100: a warp's
// second node costs more than a third block's staging; sixteen warps a
// block were never faster than eight).  At most max_warps (<= 8) warps.
inline BlockPlan plan_blocks(int lanes, int nodes, int max_warps) {
  const int sms = sm_count();
  int warps = max_warps;
  while (warps > 2 && lanes * ((nodes + warps - 1) / warps) < sms)
    warps >>= 1;
  int per_block = warps;
  while (lanes * ((nodes + per_block - 1) / per_block) > 3 * sms)
    per_block += warps;
  return BlockPlan{warps, per_block, (nodes + per_block - 1) / per_block};
}

// Opt a kernel in to `smem` bytes of dynamic shared memory (needed above
// 48 KB).  *granted is the caller's record, one per kernel, of the largest
// size already granted (0 at first), so that the attribute is set once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024 || smem <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *granted = smem;
  return err;
}

}  // namespace goicp
