// K1 and K3: geometric translation-node bounds (all modes of the TPU
// kernel), with one table set for all lanes (K1) or one per lane (K3).
//
// K1 replaces goicp_tpu/bounds/pallas_eval.py::geometric_bounds_kernel
// (:517), K3 ::geometric_bounds_kernel_lanes (:632); both share the body
// _geom_kernel (:310) there and geom_bounds_body here.  For each (lane,
// node, point):
//   voxel = trunc((p + c - lo) * scale + 0.5), clamped to the grid;
//   d     = sqrt(min over occupied cells of |voxel - cell|^2) / scale, plus
//           the out-of-bounds extension sqrt(sum excess^2) / scale;
//   dis   = w * d.
// Per node, with f(x) = x (norm 1) or x^2 (norm 2):
//   plain:  ub = sum f(dis'), lb = sum f(max(dis' - sqrt(3)/2 w, 0)), where
//           dis' = max(dis - rot_unc, 0) (or max(dis, 0) without rot_unc);
//   fused:  ub = sum f(dis), ubu = sum f(disu), lbu = sum f(max(disu -
//           sqrt(3)/2 w, 0)), with disu = max(dis - rot_unc, 0).
// Trimmed modes keep the K smallest real points of each row (sorted, with
// zero-weight padding at +inf): K static (trim_k) or read on the device
// from trim_count, so the inlier count never goes through the host.
//
// What bounds it on the H100: the (points x cells) integer min.  At the
// main-path shapes (8 lanes x 64 nodes x 320 points x ~320 cells) that is
// ~52 M squared distances per launch, a few hundred KB of input and 2-3 KB
// of output: compute- and latency-bound, never bandwidth-bound.  The design
// keeps every intermediate on chip: one block per (lane, node), the
// occupied cells staged through shared memory in tiles and read by every
// thread as a broadcast, per-point minima and distances held in shared
// memory, and fixed-order block reductions (no atomics, so results repeat
// bit for bit).  The TPU kernel's bf16 digit-column key encoding exists
// only for the MXU and is not carried over: squared distances are int32.
//
// K3 serves the cross-pair streams, where every lane may belong to another
// registration pair.  The TPU kernel takes gathered per-lane copies of the
// tables because a block spec can only slice; here the tables stay per pair
// ((W, Nd) weights, (W, C, 3) cells, (W, 5) consts, (W,) trim counts) and a
// block follows lane_pair[lane] to its pair's rows, so no table is copied.
#include <algorithm>
#include <climits>

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
  const float* consts;      // (5,) [x_min, y_min, z_min, scale, size],
                            // or (W, 5)
  const float* trim_count;  // device scalar K (dynamic trim), (W,), or null
  const int* lane_pair;     // (L,) pair of each lane (K3) or null (K1)
  float* out0;              // (L, B) ub
  float* out1;              // (L, B) lb (plain) / ubu (fused)
  float* out2;              // (L, B) lbu (fused) or null
  int L, B, Nd, C, n_sort;  // n_sort: row length held for the sort
  int norm, fused, trim_k;
};

__device__ __forceinline__ float fnorm(float v, int norm) {
  return norm == 2 ? __fmul_rn(v, v) : v;
}

// Ascending bitonic sort of a[0:n] (and b[0:n] when given), n a power of
// two.  Only values are summed afterwards, so tie order is irrelevant.
__device__ void bitonic_sort(float* a, float* b, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          float x = a[i], y = a[ixj];
          if ((x > y) == up) { a[i] = y; a[ixj] = x; }
          if (b != nullptr) {
            x = b[i]; y = b[ixj];
            if ((x > y) == up) { b[i] = y; b[ixj] = x; }
          }
        }
      }
      __syncthreads();
    }
  }
}

// The whole computation of one block = one (lane, node).  `pair` selects
// the table rows (always 0 for K1).
__device__ __forceinline__ void geom_bounds_body(const GeomParams& p,
                                                 int pair) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tile = reinterpret_cast<int4*>(smem);               // kCellTile
  int* d2s = reinterpret_cast<int*>(tile + kCellTile);      // Nd
  int* voxs = d2s + p.Nd;                                   // Nd
  float* dis = reinterpret_cast<float*>(voxs + p.Nd);       // n_sort
  float* disu = dis + p.n_sort;                             // n_sort
  __shared__ float red[32];

  const int lane = blockIdx.x / p.B;
  const int node = blockIdx.x % p.B;
  const float* weights = p.weights + static_cast<size_t>(pair) * p.Nd;
  const int* cells = p.cells + static_cast<size_t>(pair) * p.C * 3;
  const float* trim_count =
      p.trim_count != nullptr ? p.trim_count + pair : nullptr;
  const GridConsts g = load_consts(p.consts + static_cast<size_t>(pair) * 5);
  const float* pts = p.pts + static_cast<size_t>(lane) * p.Nd * 3;
  const float* cen = p.centers + (static_cast<size_t>(lane) * p.B + node) * 3;
  const float c0 = cen[0], c1 = cen[1], c2 = cen[2];

  // 1. clamped voxel of every point, packed 10 bits per axis (S <= 1024)
  for (int i = threadIdx.x; i < p.Nd; i += blockDim.x) {
    const int vx = clamp_voxel(voxel_raw(pts[3 * i], c0, g.lo[0], g.scale), g.size);
    const int vy = clamp_voxel(voxel_raw(pts[3 * i + 1], c1, g.lo[1], g.scale), g.size);
    const int vz = clamp_voxel(voxel_raw(pts[3 * i + 2], c2, g.lo[2], g.scale), g.size);
    voxs[i] = vx | (vy << 10) | (vz << 20);
    d2s[i] = INT_MAX;
  }

  // 2. min over occupied cells, one shared-memory tile at a time
  for (int start = 0; start < p.C; start += kCellTile) {
    const int n = min(kCellTile, p.C - start);
    __syncthreads();
    load_cell_tile(cells, start, n, g.size, tile);
    __syncthreads();
    for (int i = threadIdx.x; i < p.Nd; i += blockDim.x) {
      const int v = voxs[i];
      const int vx = v & 1023, vy = (v >> 10) & 1023, vz = v >> 20;
      int best = d2s[i];
      for (int c = 0; c < n; ++c) best = min(best, cell_d2(tile[c], vx, vy, vz));
      d2s[i] = best;
    }
  }
  __syncthreads();

  // 3. per-point distances (+inf for rows' padding slots when trimming)
  const bool trim = p.trim_k > 0 || trim_count != nullptr;
  const float inf = __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < p.n_sort; i += blockDim.x) {
    if (i >= p.Nd) { dis[i] = inf; disu[i] = inf; continue; }
    float d = __fdiv_rn(__fsqrt_rn(static_cast<float>(d2s[i])), g.scale);
    float ex[3];
    bool oob = false;
    for (int a = 0; a < 3; ++a) {
      const int r = static_cast<int>(voxel_raw(pts[3 * i + a], cen[a], g.lo[a], g.scale));
      ex[a] = r < 0 ? static_cast<float>(r)
                    : (r >= g.size ? static_cast<float>(r - g.size + 1) : 0.0f);
      oob = oob || r < 0 || r >= g.size;
    }
    if (oob) {
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(ex[0], ex[0]), __fmul_rn(ex[1], ex[1])),
                                __fmul_rn(ex[2], ex[2]));
      d = __fadd_rn(d, __fdiv_rn(__fsqrt_rn(s), g.scale));
    }
    const float w = weights[i];
    float ds = __fmul_rn(w, d);
    const float ru = p.rot_unc != nullptr
        ? p.rot_unc[static_cast<size_t>(lane) * p.Nd + i] : 0.0f;
    float du = 0.0f;
    if (p.fused) {
      du = fmaxf(__fsub_rn(ds, ru), 0.0f);
    } else {
      ds = fmaxf(__fsub_rn(ds, ru), 0.0f);
    }
    if (trim && !(w > 0.0f)) { ds = inf; du = inf; }
    dis[i] = ds;
    disu[i] = du;
  }
  __syncthreads();

  // 4. trimmed rows: sort, then only the first K ranks are summed
  int n_sum = p.Nd;
  float kf = 0.0f;
  if (trim) {
    bitonic_sort(dis, p.fused ? disu : nullptr, p.n_sort);
    n_sum = p.n_sort;
    kf = trim_count != nullptr ? *trim_count : static_cast<float>(p.trim_k);
  }
  const float s3w = __fmul_rn(kHalfSqrt3, p.widths[static_cast<size_t>(lane) * p.B + node]);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int i = threadIdx.x; i < n_sum; i += blockDim.x) {
    if (trim && !(static_cast<float>(i) < kf)) continue;
    const float v = dis[i];
    a0 = __fadd_rn(a0, fnorm(v, p.norm));
    if (p.fused) {
      const float u = disu[i];
      a1 = __fadd_rn(a1, fnorm(u, p.norm));
      a2 = __fadd_rn(a2, fnorm(fmaxf(__fsub_rn(u, s3w), 0.0f), p.norm));
    } else {
      a1 = __fadd_rn(a1, fnorm(fmaxf(__fsub_rn(v, s3w), 0.0f), p.norm));
    }
  }
  a0 = block_sum(a0, red);
  a1 = block_sum(a1, red);
  if (p.fused) a2 = block_sum(a2, red);
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(lane) * p.B + node;
    p.out0[o] = a0;
    p.out1[o] = a1;
    if (p.fused) p.out2[o] = a2;
  }
}

__global__ void geom_bounds_kernel(GeomParams p) { geom_bounds_body(p, 0); }

__global__ void geom_bounds_lanes_kernel(GeomParams p) {
  geom_bounds_body(p, p.lane_pair[blockIdx.x / p.B]);
}

// One block per (lane, node); the row is padded to a power of two only
// when it is sorted.
template <typename Kernel>
int launch_geom(Kernel kernel, GeomParams p, void* stream) {
  const bool trim = p.trim_k > 0 || p.trim_count != nullptr;
  p.n_sort = p.Nd;
  if (trim) {
    p.n_sort = 1;
    while (p.n_sort < p.Nd) p.n_sort <<= 1;
  }
  const size_t smem = kCellTile * sizeof(int4) + 2 * sizeof(int) * p.Nd +
                      2 * sizeof(float) * p.n_sort;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = std::min(256, std::max(32, (p.Nd + 31) / 32 * 32));
  kernel<<<p.L * p.B, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace goicp

extern "C" int goicp_geom_bounds(const float* pts, const float* centers,
                                 const float* widths, const float* rot_unc,
                                 const float* weights, const int* cells,
                                 const float* consts, const float* trim_count,
                                 float* out0, float* out1, float* out2,
                                 int L, int B, int Nd, int C, int norm,
                                 int fused, int trim_k, void* stream) {
  using namespace goicp;
  GeomParams p{pts, centers, widths, rot_unc, weights, cells, consts,
               trim_count, nullptr, out0, out1, out2, L, B, Nd, C, 0, norm,
               fused, trim_k};
  return launch_geom(geom_bounds_kernel, p, stream);
}

// K3: fused mode with rotation uncertainty; tables per pair, followed
// through lane_pair; trim_count (W,) per pair or null (no trimming).
extern "C" int goicp_geom_bounds_lanes(
    const float* pts, const float* centers, const float* widths,
    const float* rot_unc, const float* weights, const int* cells,
    const float* consts, const float* trim_count, const int* lane_pair,
    float* out0, float* out1, float* out2, int L, int B, int Nd, int C,
    int norm, void* stream) {
  using namespace goicp;
  GeomParams p{pts, centers, widths, rot_unc, weights, cells, consts,
               trim_count, lane_pair, out0, out1, out2, L, B, Nd, C, 0, norm,
               1, 0};
  return launch_geom(geom_bounds_lanes_kernel, p, stream);
}
