// The harvest of a finished inner search and the fused stream's event
// head, as block-wide device functions shared by transition.cu
// (goicp_harvest: the harvest of given rows, a block a row; or the event
// head alone, one block) and inner.cu (goicp_inner_run: the last cluster
// to finish a run harvests its rows, or runs the event head, after it
// forms the counters, so that no launch follows the run before the
// host's read).  search/transition.py::harvest_plain and
// event_head_plain are the same functions in torch ops.
//
// harvest_rows, for each row w it serves (output row j): each lane's lower
// bound lb_safe (the minimum of thr or the lb pass's opt_err and
// min_dropped, and of the lane's translation frontier where its search did
// not finish; or given), ubs = active ? opt_err : inf, the first argmin
// lane (NaN first, as torch.argmin), the candidate's ub, R, t = tn[:3] +
// tn[3] / 2 and terms, the incumbent min(opt_err, cand_ub) and improved =
// !(cand_ub >= opt_err) (NaN-infectious), beside a copy of the row's
// converged flag.  What bounds it is the chain of dependent loads (a few
// hundred bytes a row), so every step issues its loads at once: a warp a
// lane, the lane's scalars together, a done lane's frontier not scanned
// (its minimum is not used), so a complete row's harvest reads its lanes'
// scalars only; a warp a row for the argmin, then the candidate's 18
// values one a thread.
//
// event_head, the fused stream's transition event (fused_stream.py's
// fused_run_chunk, JAX's lax.cond on the window, goicp_tpu/search/
// fused_stream.py:355-362): each row's flags, finished = converged | it >=
// max_outer_steps, converged, and complete = every lane done | inner it
// >= inner_max_iters; the served rows, complete & !converged, the first K
// in index order (np.nonzero(...)[:K], JAX's top_k); their harvest; and
// the event's words, which the host reads in one copy:
//   [0, W) finished, [W, 2W) converged, [2W, 3W) complete,
//   [3W] n served, [3W + 1, 3W + 1 + K) the served rows (-1 past n),
//   [3W + 1 + K, 3W + 1 + 2K) their improved flags (0 past n),
//   [3W + 1 + 2K] the global iterations of the run before it.
//
// Every input is read through L2 (__ldcg): in the run the lanes were
// written by other clusters in the same launch.  Every float step is the
// torch code's, one rounding each (__fdiv_rn, __fadd_rn); the only
// cross-thread reductions are minima, so no order is at stake.
#pragma once

#include <cuda_runtime.h>

namespace goicp {

__device__ __forceinline__ bool hv_nan(float v) { return v != v; }

__device__ __forceinline__ float hv_inf() {
  return __int_as_float(0x7f800000);
}

// torch.minimum / amin: NaN wins
__device__ __forceinline__ float hv_min(float a, float b) {
  return hv_nan(a) || hv_nan(b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// argmin's order: NaN first, then the value, then the index
__device__ __forceinline__ bool hv_arg_before(float a, int ia, float b,
                                              int ib) {
  if (hv_nan(a) || hv_nan(b)) return hv_nan(a) && (!hv_nan(b) || ia < ib);
  return a < b || (a == b && ia < ib);
}

// What a harvest reads (W rows of L lanes) and writes (a row per served
// row).
struct HarvestIo {
  const float* lbs;             // (W, L, C) the lanes' frontier lbs
  const float* ref;             // (W, L) thr (fused), or opt_err
  const float* min_drop;        // (W, L)
  const unsigned char* done;    // (W, L)
  const float* lb_in;           // (W, L) lb_safe given (over a mesh), or null
  const float* ub_err;          // (W, L) the lanes' opt_err
  const float* best_node;       // (W, L, 4)
  const float* ub_terms;        // (W, L, 3)
  const unsigned char* active;  // (W, L)
  const float* R_lanes;         // (W, L, 3, 3)
  const float* opt_err;         // (W,) the incumbent
  const unsigned char* conv;    // (W,) copied into flags[:, 1], or null
  float* lb_safe;               // (n, L)
  float* ubs;                   // (n, L)
  float* cand_ub;               // (n,)
  float* incumbent;             // (n,)
  float* cand_R;                // (n, 3, 3)
  float* cand_t;                // (n, 3)
  float* cand_terms;            // (n, 3)
  unsigned char* flags;         // (n, 2) improved, converged
  int L, C;
};

// The harvest of rows row(0) .. row(n - 1) into output rows out0 ..
// out0 + n - 1, the whole block.  s_ubs: `cap` words of shared memory
// (at least L), the lanes' ubs of as many rows at a time as fit.
// improved: where given, improved[j] = row j's improved flag.
template <typename Row>
__device__ __forceinline__ void harvest_rows(const HarvestIo& h, Row row,
                                             int n, int out0, float* s_ubs,
                                             int cap, int* improved) {
  const int t = threadIdx.x, tid = t & 31, warp = t >> 5;
  const int nw = static_cast<int>(blockDim.x >> 5);
  const int L = h.L, C = h.C;
  const float inf = hv_inf();
  const int per = cap / L;
  for (int j0 = 0; j0 < n; j0 += per) {
    const int m = n - j0 < per ? n - j0 : per;
    for (int e = warp; e < m * L; e += nw) {
      const int jj = e / L, l = e - jj * L;
      const size_t wl = static_cast<size_t>(row(j0 + jj)) * L + l;
      // the lane's scalars, their loads in flight together
      const bool active = __ldcg(h.active + wl) != 0;
      const float ub = __ldcg(h.ub_err + wl);
      float lb;
      if (h.lb_in != nullptr) {
        lb = __ldcg(h.lb_in + wl);
      } else {
        const bool done = __ldcg(h.done + wl) != 0;
        lb = hv_min(__ldcg(h.ref + wl), __ldcg(h.min_drop + wl));
        if (!done) {
          // rem_min = amin(lbs): NaN-propagating, over the lane's C entries
          const float* fr = h.lbs + wl * C;
          float mn = inf;
          for (int c = tid; c < C; c += 32) mn = hv_min(mn, __ldcg(fr + c));
          for (int off = 16; off > 0; off >>= 1)
            mn = hv_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
          lb = hv_min(lb, mn);
        }
      }
      if (tid == 0) {
        const float u = active ? ub : inf;
        const size_t o = static_cast<size_t>(out0 + j0 + jj) * L + l;
        h.lb_safe[o] = lb;
        h.ubs[o] = u;
        s_ubs[e] = u;
      }
    }
    __syncthreads();
    for (int jj = warp; jj < m; jj += nw) {
      const float* su = s_ubs + jj * L;
      float bv = inf;
      int bi = 0x7fffffff;
      for (int l = tid; l < L; l += 32)
        if (hv_arg_before(su[l], l, bv, bi)) {
          bv = su[l];
          bi = l;
        }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (hv_arg_before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      // the candidate: one value a thread, every load in flight at once
      // (R 0-8, best_node 9-12, ub_terms 13-15, the incumbent 16, the
      // converged flag 17), then t = tn[:3] + tn[3] / 2 and the stores
      const int j = j0 + jj, w = row(j), i = out0 + j;
      const size_t lane = static_cast<size_t>(w) * L + bi;
      float v = 0.0f;
      if (tid < 9)
        v = __ldcg(h.R_lanes + 9 * lane + tid);
      else if (tid < 13)
        v = __ldcg(h.best_node + 4 * lane + tid - 9);
      else if (tid < 16)
        v = __ldcg(h.ub_terms + 3 * lane + tid - 13);
      else if (tid == 16)
        v = __ldcg(h.opt_err + w);
      else if (tid == 17 && h.conv != nullptr)
        v = __ldcg(h.conv + w) != 0 ? 1.0f : 0.0f;
      const float tn3 = __shfl_sync(0xffffffffu, v, 12);
      const float opt = __shfl_sync(0xffffffffu, v, 16);
      const float conv = __shfl_sync(0xffffffffu, v, 17);
      if (tid < 9) {
        h.cand_R[9 * i + tid] = v;
      } else if (tid < 12) {
        h.cand_t[3 * i + tid - 9] = __fadd_rn(v, __fdiv_rn(tn3, 2.0f));
      } else if (tid >= 13 && tid < 16) {
        h.cand_terms[3 * i + tid - 13] = v;
      } else if (tid == 16) {
        const bool imp = !(bv >= opt);   // NaN-infectious <
        h.cand_ub[i] = bv;
        h.incumbent[i] = hv_min(opt, bv);
        h.flags[2 * i] = imp;
        h.flags[2 * i + 1] = conv != 0.0f;
        if (improved != nullptr) improved[j] = imp;
      }
    }
    __syncthreads();
  }
}

// What the event head reads besides the harvest's inputs, and its words.
struct EventIo {
  const unsigned char* conv;    // (W,) the state's converged
  const int* it;                // (W,) the outer steps taken
  const unsigned char* done;    // (W, L) the lanes' done
  const int* inner_it;          // (W,) the inner search's iterations
  unsigned char* fin0;          // (W,) or null: finished written there
  int* words;                   // 3 W + 2 K + 2 (the header's layout)
  int W, K, max_outer, inner_max;
};

// Shared words event_head needs besides the harvest's: W + K + 1.
__host__ __device__ __forceinline__ int event_words(int W, int K) {
  return W + K + 1;
}

// The event head (the header), the whole block: n_iters the run's global
// iterations; s: `cap` words of shared memory, event_words(W, K) of them
// for the served rows, the rest (at least L) the harvest's.
__device__ __forceinline__ void event_head(const EventIo& e,
                                           const HarvestIo& h, int n_iters,
                                           int* s, int cap) {
  const int t = threadIdx.x, nt = blockDim.x, tid = t & 31, warp = t >> 5;
  const int nw = nt >> 5;
  const int W = e.W, K = e.K, L = h.L;
  int* s_cand = s;            // (W,) complete & !converged
  int* s_rows = s + W;        // (K,) the served rows
  int* s_n = s + W + K;
  for (int g = warp; g < W; g += nw) {
    bool all = true;
    for (int l = tid; l < L; l += 32)
      all = all && __ldcg(e.done + static_cast<size_t>(g) * L + l) != 0;
    all = __all_sync(0xffffffffu, all);
    if (tid == 0) {
      const bool conv = __ldcg(e.conv + g) != 0;
      const bool fin = conv || __ldcg(e.it + g) >= e.max_outer;
      const bool complete = all || __ldcg(e.inner_it + g) >= e.inner_max;
      e.words[g] = fin;
      e.words[W + g] = conv;
      e.words[2 * W + g] = complete;
      s_cand[g] = complete && !conv;
      if (e.fin0 != nullptr) e.fin0[g] = fin;
    }
  }
  __syncthreads();
  // the served rows: the first K candidates in index order
  for (int g = t; g < W; g += nt)
    if (s_cand[g]) {
      int r = 0;
      for (int m = 0; m < g; ++m) r += s_cand[m];
      if (r < K) s_rows[r] = g;
    }
  if (t == 0) {
    int c = 0;
    for (int g = 0; g < W; ++g) c += s_cand[g];
    *s_n = c < K ? c : K;
  }
  __syncthreads();
  const int n = *s_n;
  int* w_rows = e.words + 3 * W + 1;
  int* w_imp = w_rows + K;
  for (int j = t; j < K; j += nt) {
    w_rows[j] = j < n ? s_rows[j] : -1;
    if (j >= n) w_imp[j] = 0;
  }
  if (t == 0) {
    e.words[3 * W] = n;
    w_imp[K] = n_iters;
  }
  harvest_rows(h, [s_rows](int j) { return s_rows[j]; }, n, 0,
               reinterpret_cast<float*>(s + event_words(W, K)),
               cap - event_words(W, K), w_imp);
}

}  // namespace goicp
