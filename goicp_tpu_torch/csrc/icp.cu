// icp: the whole ICP event of goicp_tpu_torch/icp/icp.py::icp_run in one
// launch, and the Kabsch step alone (kabsch_from_H) for a batch of 3x3 H.
//
// Not a port of a TPU kernel: the JAX package's ICP
// (goicp_tpu/icp/icp.py:174, icp_run, a lax.while_loop that XLA compiles)
// has no Pallas kernel.  The port's plain loop (icp.py::icp_run_plain)
// steps every row from the host: one ICP iteration is ~1,000 small
// launches (the ordered sums of csrc/ordered_sum.cu, sq_dist3, det3 and
// cross3 of csrc/fp32_products.cu, dot_fma, and the Jacobi SVD's
// elementwise torch ops) and one host read (is any row still running?).
// This kernel replaces all of them for an event.
//
// What bounds it on the H100: latency.  An event of K rows (the ICP
// seeds, or 1) has K independent loops of up to max_iter iterations, each
// iteration a chain of dependent steps: ~Nd*M*8 operations of the nearest-
// neighbour search, 16 fixed-order sums over the points and a serial 3x3
// Kabsch (a Jacobi SVD of 18 Givens rotations).  The design: one block
// per row, which loads the two clouds into shared memory once and loops
// its own iterations until the row stops (converged or max_iter), exactly
// as each row of the plain loop does (stopped rows keep their state); so
// an event is one launch and no host read.  Clouds too large for shared
// memory (10 Nd + 4 M words above 227 KB) take a per-block workspace in
// device memory from the wrapper instead; the code is the same.
//
// Every value equals the plain loop's bit for bit, on the card and on the
// CPU, because each step takes the plain loop's own order:
//   1. pts = rotate(R, data) + t, each coordinate a dot3_warp;
//   2. the NN search by sq_dist3's algebra (|p|^2 - 2 p.q) + |q|^2, the
//      first index of the minimum, then clamp(min=0); 1e12 on padded rows;
//   3. the mask in one of four modes (kMode*), the trimmed ones by the
//      stable rank #{j: d2_j < d2_i} + #{j < i: d2_j == d2_i}, which is the
//      position in argsort(stable=True);
//   4. err_new, mu_d (3), mu_m (3), then the 9 entries of H: each sum by
//      one warp in ordered_sum's lanes-32 order (lane t adds terms t,
//      t+32, ... from +0.0; then common.cuh's xor butterfly);
//   5. the convergence test (err > 0) & (err - err_new < err_diff cnt);
//   6. kabsch_from_H (below) on one thread, then t_, R_next and t_next by
//      matvec3's and matmul3's dot3_warp.
// Every product and sum is an explicit round-to-nearest intrinsic (no FMA
// contraction) except R = V (dU)^T's chain, fp32_order.cuh's dot_fma_step
// (__fmaf_rn, one rounding a step, as fp32.py's dot_fma); Python scalars
// of the plain loop (1e-30, 1e-5, 1e12, err_diff) act in float32, as
// torch rounds them; torch.clamp, sign, amax and argmin keep torch's NaN
// and signed-zero rules.  The NN search assumes finite points (its
// argmin does not look for NaN).
#include "common.cuh"
#include "fp32_order.cuh"

namespace goicp {

constexpr int kIcpThreads = 512;
constexpr int kIcpWarps = kIcpThreads / 32;
constexpr int kKabschThreads = 128;
// a row's workspace in shared memory, at most: the opt-in limit less the
// kernel's static shared memory (icp/icp.py::ICP_SMEM_BYTES mirrors it)
constexpr size_t kIcpSmemMax = kMaxDynamicSmem - 1024;

// the mask of step 3
constexpr int kModeAll = 0;       // untrimmed: every row kept
constexpr int kModeTrim = 1;      // static trim: stable rank < inlier_num
constexpr int kModeCount = 2;     // dynamic counts: data_mask itself
constexpr int kModeDynTrim = 3;   // dynamic trim: stable rank < *count

// torch.clamp(x, min=lo): x where x >= lo or NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.sign: +0 for either zero (and NaN)
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.argmin of three values: the first minimum, a NaN counting as one
__device__ __forceinline__ int argmin3(const float* v) {
  int k = 0;
  float best = v[0];
#pragma unroll
  for (int j = 1; j < 3; ++j)
    if (!is_nan(best) && (v[j] < best || is_nan(v[j]))) {
      best = v[j];
      k = j;
    }
  return k;
}

// One Givens rotation of the one-sided Jacobi (icp.py::_jacobi_svd3's
// rot), zeroing the inner product of columns P and Q of A; applied to A
// and V.  Row-major 3x3 arrays.
template <int P, int Q>
__device__ __forceinline__ void givens(float* A, float* V) {
  const float ap[3] = {A[P], A[3 + P], A[6 + P]};
  const float aq[3] = {A[Q], A[3 + Q], A[6 + Q]};
  const float app = dot3_seq(ap, ap), aqq = dot3_seq(aq, aq),
              apq = dot3_seq(ap, aq);
  const bool safe = fabsf(apq) > 1e-30f;
  const float tau =
      __fdiv_rn(__fsub_rn(aqq, app), safe ? __fmul_rn(2.0f, apq) : 1.0f);
  const float root = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)));
  const float t =
      safe ? __fdiv_rn(sign_of(tau), __fadd_rn(fabsf(tau), root)) : 0.0f;
  const float c =
      __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  const float s = __fmul_rn(t, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a_p = A[3 * i + P], a_q = A[3 * i + Q];
    A[3 * i + P] = __fsub_rn(__fmul_rn(c, a_p), __fmul_rn(s, a_q));
    A[3 * i + Q] = __fadd_rn(__fmul_rn(s, a_p), __fmul_rn(c, a_q));
    const float v_p = V[3 * i + P], v_q = V[3 * i + Q];
    V[3 * i + P] = __fsub_rn(__fmul_rn(c, v_p), __fmul_rn(s, v_q));
    V[3 * i + Q] = __fadd_rn(__fmul_rn(s, v_p), __fmul_rn(c, v_q));
  }
}

// the sort network's compare-swap: columns P and Q of A and V and their
// sigmas trade places where sigma[P] < sigma[Q]
template <int P, int Q>
__device__ __forceinline__ void sort_swap(float* A, float* V, float* sigma) {
  const bool swap = sigma[P] < sigma[Q];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a_p = A[3 * i + P], a_q = A[3 * i + Q];
    A[3 * i + P] = swap ? a_q : a_p;
    A[3 * i + Q] = swap ? a_p : a_q;
    const float v_p = V[3 * i + P], v_q = V[3 * i + Q];
    V[3 * i + P] = swap ? v_q : v_p;
    V[3 * i + Q] = swap ? v_p : v_q;
  }
  const float s_p = sigma[P], s_q = sigma[Q];
  sigma[P] = swap ? s_q : s_p;
  sigma[Q] = swap ? s_p : s_q;
}

// icp.py::kabsch_from_H: R = V D U^T from the Jacobi SVD of H / max|H|,
// D = diag(1, 1, det(V) det(U)) on the smallest singular value; identity
// where max|H| is not > 0.  H and R row-major; everything in registers.
__device__ void kabsch_from_H(const float* H, float* R) {
  float hmax = fabsf(H[0]);           // torch.amax: a NaN wins
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float a = fabsf(H[k]);
    if (is_nan(a) || a > hmax) hmax = a;
  }
  const float scale = clamp_min(hmax, 1e-30f);
  float A[9], V[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
  for (int k = 0; k < 9; ++k) A[k] = __fdiv_rn(H[k], scale);
  for (int sweep = 0; sweep < 6; ++sweep) {
    givens<0, 1>(A, V);
    givens<0, 2>(A, V);
    givens<1, 2>(A, V);
  }
  float sigma[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float col[3] = {A[j], A[3 + j], A[6 + j]};
    sigma[j] = __fsqrt_rn(dot3_seq(col, col));
  }
  sort_swap<0, 1>(A, V, sigma);
  sort_swap<0, 2>(A, V, sigma);
  sort_swap<1, 2>(A, V, sigma);
  float s1 = sigma[0];                // torch.amax
#pragma unroll
  for (int k = 1; k < 3; ++k)
    if (is_nan(sigma[k]) || sigma[k] > s1) s1 = sigma[k];
  const float tol = __fmul_rn(1e-5f, clamp_min(s1, 1e-30f));
  float u0[3], u1[3], u2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u0[i] = __fdiv_rn(A[3 * i], clamp_min(sigma[0], 1e-30f));
    u1[i] = __fdiv_rn(A[3 * i + 1], clamp_min(sigma[1], 1e-30f));
    u2[i] = __fdiv_rn(A[3 * i + 2], clamp_min(sigma[2], 1e-30f));
  }
  // the branch-free completion of degenerate columns
  const float abs_u0[3] = {fabsf(u0[0]), fabsf(u0[1]), fabsf(u0[2])};
  const int ei = argmin3(abs_u0);
  const float e[3] = {ei == 0 ? 1.0f : 0.0f, ei == 1 ? 1.0f : 0.0f,
                      ei == 2 ? 1.0f : 0.0f};
  float alt1[3];
  cross3(u0, e, alt1);
  const float norm = clamp_min(__fsqrt_rn(dot3_seq(alt1, alt1)), 1e-30f);
#pragma unroll
  for (int i = 0; i < 3; ++i) alt1[i] = __fdiv_rn(alt1[i], norm);
  if (!(sigma[1] > tol)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = alt1[i];
  }
  if (!(sigma[2] > tol)) cross3(u0, u1, u2);
  float U[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[3 * i] = u0[i];
    U[3 * i + 1] = u1[i];
    U[3 * i + 2] = u2[i];
  }
  const float det = __fmul_rn(det3_rows(V), det3_rows(U));
  const int small = argmin3(sigma);
  float dU[9];                        // (d[None, :] * U)[j][k] = d[k] U[j][k]
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dU[3 * j + k] = __fmul_rn(k == small ? det : 1.0f, U[3 * j + k]);
  const bool nonzero = hmax > 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = __fmul_rn(V[3 * i], dU[3 * j]);
      acc = dot_fma_step(V[3 * i + 1], dU[3 * j + 1], acc);
      acc = dot_fma_step(V[3 * i + 2], dU[3 * j + 2], acc);
      R[3 * i + j] = nonzero ? acc : (i == j ? 1.0f : 0.0f);
    }
}

__global__ void kabsch3_kernel(const float* __restrict__ H,
                               float* __restrict__ R, long long batch) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kKabschThreads + threadIdx.x;
  if (b >= batch) return;
  float h[9], r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = __ldg(H + 9 * b + k);
  kabsch_from_H(h, r);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[9 * b + k] = r[k];
}

// words of a row's workspace: data, rotated points (3 Nd each), d2, the
// NN index, the mask, data_mask (Nd each); model (3 M) and |q|^2 (M)
__host__ __device__ __forceinline__ long long icp_workspace_words(int nd,
                                                                  int m) {
  return 10LL * nd + 4LL * m;
}

// one fixed-order sum over the points by the calling warp: lane t adds
// term(t), term(t + 32), ... from +0.0, then the xor butterfly
template <typename Term>
__device__ __forceinline__ float warp_ordered_sum(int nd, Term term) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int i = lane; i < nd; i += 32) acc = __fadd_rn(acc, term(i));
  return warp_sum(acc);
}

__global__ void __launch_bounds__(kIcpThreads)
    icp_run_kernel(const float* __restrict__ data,
                   const float* __restrict__ model,
                   const float* __restrict__ R0, const float* __restrict__ t0,
                   const float* __restrict__ data_mask,
                   const float* __restrict__ count,
                   const unsigned char* __restrict__ enabled,
                   float* __restrict__ workspace, float* __restrict__ R_out,
                   float* __restrict__ t_out, long long* __restrict__ nn_out,
                   float* __restrict__ err_out, int* __restrict__ iters_out,
                   int nd, int m, int inlier_num, int max_iter, int mode,
                   float err_diff) {
  extern __shared__ float dyn_smem[];
  __shared__ float sR[9], st[3], sums[16];
  __shared__ float s_err;
  __shared__ int s_it, s_run;
  const int row = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  float* ws = workspace == nullptr
                  ? dyn_smem
                  : workspace + row * icp_workspace_words(nd, m);
  float* s_data = ws;
  float* s_pts = s_data + 3 * nd;
  float* s_d2 = s_pts + 3 * nd;
  int* s_idx = reinterpret_cast<int*>(s_d2 + nd);
  float* s_mask = reinterpret_cast<float*>(s_idx + nd);
  float* s_dmask = s_mask + nd;
  float* s_model = s_dmask + nd;
  float* s_qq = s_model + 3 * m;

  for (int i = tid; i < 3 * nd; i += kIcpThreads) s_data[i] = __ldg(data + i);
  for (int i = tid; i < 3 * m; i += kIcpThreads)
    s_model[i] = __ldg(model + i);
  for (int i = tid; i < nd; i += kIcpThreads) {
    s_dmask[i] = data_mask == nullptr ? 1.0f : __ldg(data_mask + i);
    s_idx[i] = 0;
  }
  if (tid < 9) sR[tid] = __ldg(R0 + 9 * row + tid);
  if (tid < 3) st[tid] = __ldg(t0 + 3 * row + tid);
  if (tid == 0) {
    s_err = -1.0f;
    s_it = 0;
    s_run = (enabled == nullptr || enabled[row] != 0) && max_iter > 0;
  }
  __syncthreads();
  for (int j = tid; j < m; j += kIcpThreads)
    s_qq[j] = dot3_warp(s_model + 3 * j, s_model + 3 * j);
  // the kept-set size: the count read on the device, or inlier_num
  const float cnt =
      count == nullptr ? static_cast<float>(inlier_num) : __ldg(count);
  const bool padded = data_mask != nullptr;
  __syncthreads();

  while (s_run) {
    // 1-2. rotate, then the nearest model point of every data point
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = sR[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = st[k];
    for (int i = tid; i < nd; i += kIcpThreads) {
      float p[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        p[r] = __fadd_rn(dot3_warp(R + 3 * r, s_data + 3 * i), t[r]);
#pragma unroll
      for (int r = 0; r < 3; ++r) s_pts[3 * i + r] = p[r];
      const float pp = dot3_warp(p, p);
      float best = sq_dist_from(pp, dot3_warp(p, s_model), s_qq[0]);
      int arg = 0;
      for (int j = 1; j < m; ++j) {
        const float d =
            sq_dist_from(pp, dot3_warp(p, s_model + 3 * j), s_qq[j]);
        if (d < best) {
          best = d;
          arg = j;
        }
      }
      best = clamp_min(best, 0.0f);
      if (padded && !(s_dmask[i] > 0.0f)) best = 1.0e12f;
      s_d2[i] = best;
      s_idx[i] = arg;
    }
    __syncthreads();
    // 3. the mask
    for (int i = tid; i < nd; i += kIcpThreads) {
      float keep = 1.0f;
      if (mode == kModeCount) {
        keep = s_dmask[i];
      } else if (mode == kModeTrim || mode == kModeDynTrim) {
        const float di = s_d2[i];
        int rank = 0;
        for (int j = 0; j < nd; ++j) {
          const float dj = s_d2[j];
          rank += (dj < di) || (dj == di && j < i);
        }
        keep = (mode == kModeTrim ? rank < inlier_num
                                  : __int2float_rn(rank) < cnt)
                   ? 1.0f
                   : 0.0f;
      }
      s_mask[i] = keep;
    }
    __syncthreads();
    // 4. err_new, the masked sums of the points and of their matches
    if (warp < 7) {
      float s;
      if (warp == 0) {
        s = warp_ordered_sum(
            nd, [&](int i) { return __fmul_rn(s_d2[i], s_mask[i]); });
      } else if (warp < 4) {
        const int a = warp - 1;
        s = warp_ordered_sum(nd, [&](int i) {
          return __fmul_rn(s_pts[3 * i + a], s_mask[i]);
        });
      } else {
        const int a = warp - 4;
        s = warp_ordered_sum(nd, [&](int i) {
          return __fmul_rn(s_model[3 * s_idx[i] + a], s_mask[i]);
        });
      }
      if ((tid & 31) == 0) sums[warp] = s;
    }
    __syncthreads();
    float mu_d[3], mu_m[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mu_d[a] = __fdiv_rn(sums[1 + a], cnt);
      mu_m[a] = __fdiv_rn(sums[4 + a], cnt);
    }
    // H[a][b] = sum_i ((pts_i - mu_d) m_i)[a] ((model[nn_i] - mu_m) m_i)[b]
    for (int e = warp; e < 9; e += kIcpWarps) {
      const int a = e / 3, b = e % 3;
      const float s = warp_ordered_sum(nd, [&](int i) {
        const float qd =
            __fmul_rn(__fsub_rn(s_pts[3 * i + a], mu_d[a]), s_mask[i]);
        const float qm = __fmul_rn(
            __fsub_rn(s_model[3 * s_idx[i] + b], mu_m[b]), s_mask[i]);
        return __fmul_rn(qd, qm);
      });
      if ((tid & 31) == 0) sums[7 + e] = s;
    }
    __syncthreads();
    // 5-6. the convergence test, the Kabsch and the update (one thread)
    if (tid == 0) {
      const float err_new = sums[0];
      const bool conv = s_err > 0.0f &&
                        __fsub_rn(s_err, err_new) < __fmul_rn(err_diff, cnt);
      if (!conv) {
        float Rk[9];
        kabsch_from_H(sums + 7, Rk);
        float t_[3], Rn[9], tn[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          t_[r] = __fsub_rn(mu_m[r], dot3_warp(Rk + 3 * r, mu_d));
          tn[r] = __fadd_rn(dot3_warp(Rk + 3 * r, t), t_[r]);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float col[3] = {R[j], R[3 + j], R[6 + j]};
            Rn[3 * r + j] = dot3_warp(Rk + 3 * r, col);
          }
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) sR[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) st[k] = tn[k];
      }
      s_err = err_new;
      s_it += 1;
      s_run = !conv && s_it < max_iter;
    }
    __syncthreads();
  }

  if (tid < 9) R_out[9 * row + tid] = sR[tid];
  if (tid < 3) t_out[3 * row + tid] = st[tid];
  if (tid == 0) {
    err_out[row] = s_err;
    iters_out[row] = s_it;
  }
  for (int i = tid; i < nd; i += kIcpThreads)
    nn_out[static_cast<long long>(row) * nd + i] = s_idx[i];
}

}  // namespace goicp

// The ICP event of K rows (see the file's head).  data (nd, 3), model
// (m, 3), R0 (K, 3, 3), t0 (K, 3) float32; data_mask (nd,) or null;
// count a float32 scalar or null (then inlier_num is the kept-set size);
// enabled (K,) bytes or null; workspace K * (10 nd + 4 m) floats in
// device memory, or null for shared memory (then at most kIcpSmemMax);
// mode 0 untrimmed, 1 static trim, 2 data_mask, 3 dynamic trim.  Writes
// R (K, 3, 3), t (K, 3), nn_idx (K, nd) int64, err (K,), iters (K,) int32.
extern "C" int goicp_icp_run(const float* data, const float* model,
                             const float* R0, const float* t0,
                             const float* data_mask, const float* count,
                             const unsigned char* enabled, float* workspace,
                             float* R, float* t, long long* nn_idx,
                             float* err, int* iters, int K, int nd, int m,
                             int inlier_num, int max_iter, int mode,
                             float err_diff, void* stream) {
  using namespace goicp;
  if (K <= 0) return 0;
  if (nd <= 0 || m <= 0 || mode < kModeAll || mode > kModeDynTrim)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (workspace == nullptr) {
    smem = 4 * static_cast<size_t>(icp_workspace_words(nd, m));
    if (smem > kIcpSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    static size_t granted = 0;
    const cudaError_t e = allow_smem(icp_run_kernel, smem, &granted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  icp_run_kernel<<<K, kIcpThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      data, model, R0, t0, data_mask, count, enabled, workspace, R, t, nn_idx,
      err, iters, nd, m, inlier_num, max_iter, mode, err_diff);
  return static_cast<int>(cudaGetLastError());
}

// kabsch_from_H of `batch` row-major 3x3 H, one thread each
extern "C" int goicp_kabsch3(const float* H, float* R, long long batch,
                             void* stream) {
  using namespace goicp;
  if (batch <= 0) return 0;
  const long long blocks = (batch + kKabschThreads - 1) / kKabschThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kabsch3_kernel<<<static_cast<unsigned>(blocks), kKabschThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(H, R, batch);
  return static_cast<int>(cudaGetLastError());
}
