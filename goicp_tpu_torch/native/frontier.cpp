// Host-side rotation-cube frontier: a batched min-heap.
//
// Port of goicp_tpu/native/frontier.cpp.  The host-streaming engine keeps
// the outer BnB frontier on the host (the device does the batched bound
// evaluation; see search/outer.py).  This is the native equivalent of the
// reference's priority_queue<ROTNODE> (jly_goicp.cpp:592) re-designed for
// batched access: pop_batch() extracts the K lowest-lb live nodes in one
// call (stale nodes, lb >= incumbent, are dropped on the way), and
// push_batch() inserts children in bulk.  Ties in lb pop in push order
// (FIFO by seq), which is heapq's (lb, counter) order: the outer
// trajectory depends on it.  All payloads are plain float arrays so the
// Python side binds via ctypes.  The sentinels are +infinity, as in the
// Python heap (search/outer.py::PyFrontier).
//
// Built by goicp_tpu_torch/_build.py::host_library at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct Node {
  float lb;
  float a, b, c, w;
  float ub;
  int32_t level;
  uint64_t seq;  // FIFO tie-break, matching heapq's (lb, counter) ordering
};

struct Cmp {
  bool operator()(const Node& x, const Node& y) const {
    if (x.lb != y.lb) return x.lb > y.lb;
    return x.seq > y.seq;
  }
};

struct Frontier {
  std::priority_queue<Node, std::vector<Node>, Cmp> heap;
  uint64_t seq = 0;
  uint64_t capacity = 0;
  // epsilon-accounting for capacity drops
  double min_dropped_lb = std::numeric_limits<double>::infinity();
};

}  // namespace

extern "C" {

void* gf_new(uint64_t capacity) {
  auto* f = new Frontier();
  f->capacity = capacity;
  return f;
}

void gf_free(void* h) { delete static_cast<Frontier*>(h); }

uint64_t gf_size(void* h) { return static_cast<Frontier*>(h)->heap.size(); }

float gf_min_lb(void* h) {
  auto* f = static_cast<Frontier*>(h);
  return f->heap.empty() ? std::numeric_limits<float>::infinity()
                         : f->heap.top().lb;
}

double gf_min_dropped_lb(void* h) {
  return static_cast<Frontier*>(h)->min_dropped_lb;
}

void gf_push_batch(void* h, int64_t n, const float* lb, const float* a,
                   const float* b, const float* c, const float* w,
                   const int32_t* level, const float* ub) {
  auto* f = static_cast<Frontier*>(h);
  for (int64_t i = 0; i < n; ++i) {
    f->heap.push(Node{lb[i], a[i], b[i], c[i], w[i], ub[i], level[i],
                      f->seq++});
  }
  if (f->capacity && f->heap.size() > f->capacity) {
    // keep the capacity lowest-lb nodes; remember the best dropped lb so the
    // caller can fold it into its reported optimality gap
    std::vector<Node> keep;
    keep.reserve(f->capacity);
    while (!f->heap.empty() && keep.size() < f->capacity) {
      keep.push_back(f->heap.top());
      f->heap.pop();
    }
    while (!f->heap.empty()) {
      f->min_dropped_lb = std::min(f->min_dropped_lb,
                                   static_cast<double>(f->heap.top().lb));
      f->heap.pop();
    }
    for (const Node& nd : keep) f->heap.push(nd);
  }
}

// Pop up to max_n nodes with lb < opt_err (stale nodes are discarded).
// Returns the number written to the output arrays.
int64_t gf_pop_batch(void* h, int64_t max_n, float opt_err, float* lb,
                     float* a, float* b, float* c, float* w, int32_t* level,
                     float* ub) {
  auto* f = static_cast<Frontier*>(h);
  int64_t k = 0;
  while (k < max_n && !f->heap.empty()) {
    Node nd = f->heap.top();
    f->heap.pop();
    if (nd.lb >= opt_err) continue;  // stale: pruned by a better incumbent
    lb[k] = nd.lb;
    a[k] = nd.a;
    b[k] = nd.b;
    c[k] = nd.c;
    w[k] = nd.w;
    level[k] = nd.level;
    ub[k] = nd.ub;
    ++k;
  }
  return k;
}

void gf_clear(void* h) {
  auto* f = static_cast<Frontier*>(h);
  while (!f->heap.empty()) f->heap.pop();
}

}  // extern "C"
