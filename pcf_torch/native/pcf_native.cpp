// pcf_native: host-side preprocessing kernels for pcf_torch's input pipeline
// (grid subsampling and KD-tree kNN), the same source as pcf_tpu's copy.
//
// C++ replacement for the reference's cpp_wrappers CPU extensions
// (cpp_subsampling/grid_subsampling.cpp, cpp_neighbors/neighbors.cpp),
// redesigned for the ctypes boundary: flat C arrays in/out, no Python C-API,
// no torch, caller-allocated buffers. Multi-threaded kNN queries.
//
// Built at first use by pcf_torch/native/__init__.py into pcf_torch/_build/:
//   g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread pcf_native.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Grid subsampling: voxel-hash barycenters (mean points, mean features,
// majority label). Semantics match grid_subsampling.cpp:57-107: voxel index
// from floored min-corner-shifted coordinates.
//
// Returns the number of voxels written. Output buffers must be sized for the
// worst case (n_points rows). Feature/label outputs are optional (nullptr).
int32_t grid_subsample(
    const float* points, int64_t n_points,
    const float* feats, int32_t feat_dim,     // optional
    const int32_t* labels, int32_t n_labels,  // optional; n_labels = label range hint (unused)
    float sample_dl,
    float* out_points, float* out_feats, int32_t* out_labels) {
  if (n_points == 0) return 0;

  float mn[3] = {points[0], points[1], points[2]};
  for (int64_t i = 1; i < n_points; ++i) {
    for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], points[i * 3 + d]);
  }
  double origin[3];
  for (int d = 0; d < 3; ++d)
    origin[d] = std::floor(mn[d] / sample_dl) * sample_dl;

  struct Acc {
    double pt[3] = {0, 0, 0};
    double* f = nullptr;
    std::unordered_map<int32_t, int32_t>* votes = nullptr;
    int64_t count = 0;
  };

  std::unordered_map<int64_t, int32_t> vox;  // key -> output row
  vox.reserve(static_cast<size_t>(n_points));
  std::vector<Acc> accs;
  accs.reserve(static_cast<size_t>(n_points) / 4 + 16);
  std::vector<std::vector<double>> feat_store;
  std::vector<std::unordered_map<int32_t, int32_t>> vote_store;

  for (int64_t i = 0; i < n_points; ++i) {
    const float* p = points + i * 3;
    int64_t kx = static_cast<int64_t>(std::floor((p[0] - origin[0]) / sample_dl));
    int64_t ky = static_cast<int64_t>(std::floor((p[1] - origin[1]) / sample_dl));
    int64_t kz = static_cast<int64_t>(std::floor((p[2] - origin[2]) / sample_dl));
    int64_t key = (kx * 8388608 + ky) * 8388608 + kz;  // 2^23 per axis

    auto it = vox.find(key);
    int32_t row;
    if (it == vox.end()) {
      row = static_cast<int32_t>(accs.size());
      vox.emplace(key, row);
      accs.emplace_back();
      if (feats) {
        feat_store.emplace_back(feat_dim, 0.0);
        accs[row].f = feat_store.back().data();
      }
      if (labels) {
        vote_store.emplace_back();
        accs[row].votes = &vote_store.back();
      }
    } else {
      row = it->second;
      if (feats) accs[row].f = feat_store[row].data();
      if (labels) accs[row].votes = &vote_store[row];
    }
    Acc& a = accs[row];
    for (int d = 0; d < 3; ++d) a.pt[d] += p[d];
    if (feats) {
      const float* fv = feats + i * feat_dim;
      for (int d = 0; d < feat_dim; ++d) a.f[d] += fv[d];
    }
    if (labels) (*a.votes)[labels[i]]++;
    a.count++;
  }

  const int32_t n_vox = static_cast<int32_t>(accs.size());
  for (int32_t r = 0; r < n_vox; ++r) {
    const Acc& a = accs[r];
    for (int d = 0; d < 3; ++d)
      out_points[r * 3 + d] = static_cast<float>(a.pt[d] / a.count);
    if (feats && out_feats) {
      const double* f = feat_store[r].data();
      for (int d = 0; d < feat_dim; ++d)
        out_feats[r * feat_dim + d] = static_cast<float>(f[d] / a.count);
    }
    if (labels && out_labels) {
      int32_t best = 0, best_cnt = -1;
      for (const auto& kv : vote_store[r]) {
        if (kv.second > best_cnt ||
            (kv.second == best_cnt && kv.first < best)) {
          best = kv.first;
          best_cnt = kv.second;
        }
      }
      out_labels[r] = best;
    }
  }
  return n_vox;
}

// ---------------------------------------------------------------------------
// KD-tree kNN (replacement for the nanoflann path, neighbors.cpp:339-443).
// Left-balanced median-split tree over 3-D points; bounded max-heap search.

namespace {

struct KDTree {
  const float* pts;
  std::vector<int32_t> idx;     // permutation: node i covers idx[range]
  std::vector<int32_t> split;   // split axis per node region (implicit layout)

  // Implicit in-place construction: nodes are ranges; we store the tree as a
  // nested-median ordering of `idx` so the median of [lo,hi) is the node.
  void build(const float* p, int64_t n) {
    pts = p;
    idx.resize(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = static_cast<int32_t>(i);
    build_range(0, n, 0);
  }

  void build_range(int64_t lo, int64_t hi, int axis) {
    if (hi - lo <= 1) return;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                     [&](int32_t a, int32_t b) {
                       return pts[a * 3 + axis] < pts[b * 3 + axis];
                     });
    int next = (axis + 1) % 3;
    build_range(lo, mid, next);
    build_range(mid + 1, hi, next);
  }

  struct Cand {
    float d;
    int32_t i;
    bool operator<(const Cand& o) const { return d < o.d; }
  };

  void query(const float* q, int k, std::priority_queue<Cand>& heap) const {
    search(q, 0, static_cast<int64_t>(idx.size()), 0, k, heap);
  }

  void search(const float* q, int64_t lo, int64_t hi, int axis, int k,
              std::priority_queue<Cand>& heap) const {
    if (hi <= lo) return;
    int64_t mid = (lo + hi) / 2;
    int32_t pi = idx[mid];
    const float* p = pts + pi * 3;
    float dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
    float d = dx * dx + dy * dy + dz * dz;
    if (static_cast<int>(heap.size()) < k) {
      heap.push({d, pi});
    } else if (d < heap.top().d) {
      heap.pop();
      heap.push({d, pi});
    }
    float diff = q[axis] - p[axis];
    int next = (axis + 1) % 3;
    int64_t first_lo = diff <= 0 ? lo : mid + 1;
    int64_t first_hi = diff <= 0 ? mid : hi;
    int64_t second_lo = diff <= 0 ? mid + 1 : lo;
    int64_t second_hi = diff <= 0 ? hi : mid;
    search(q, first_lo, first_hi, next, k, heap);
    if (static_cast<int>(heap.size()) < k || diff * diff < heap.top().d)
      search(q, second_lo, second_hi, next, k, heap);
  }
};

}  // namespace

// kNN of `queries` among `refs`; writes indices [n_queries, k] sorted by
// ascending distance. Multi-threaded over queries.
void knn_kdtree(const float* refs, int64_t n_refs, const float* queries,
                int64_t n_queries, int32_t k, int32_t* out_idx) {
  KDTree tree;
  tree.build(refs, n_refs);

  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  if (n_queries < 1024) n_threads = 1;
  std::vector<std::thread> threads;
  auto work = [&](int64_t start, int64_t end) {
    std::priority_queue<KDTree::Cand> heap;
    std::vector<KDTree::Cand> sorted;
    for (int64_t i = start; i < end; ++i) {
      while (!heap.empty()) heap.pop();
      tree.query(queries + i * 3, k, heap);
      sorted.clear();
      while (!heap.empty()) {
        sorted.push_back(heap.top());
        heap.pop();
      }
      // heap pops max-first: sorted[0]=farthest, sorted[m-1]=nearest.
      // Ascending output; if fewer refs than k, repeat the nearest.
      int32_t m = static_cast<int32_t>(sorted.size());
      for (int32_t j = 0; j < k; ++j)
        out_idx[i * k + j] = sorted[j < m ? m - 1 - j : m - 1].i;
    }
  };
  int64_t chunk = (n_queries + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s = t * chunk, e = std::min(n_queries, s + chunk);
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& t : threads) t.join();
}

// Batched variant over packed clouds (replacement for batch_kquery,
// cpp_neighbors/wrapper.cpp:35): q_lens/r_lens give per-cloud lengths;
// indices are offset into the packed ref array.
void knn_kdtree_batch(const float* refs, const int64_t* r_lens,
                      const float* queries, const int64_t* q_lens,
                      int32_t n_batches, int32_t k, int32_t* out_idx) {
  int64_t r_off = 0, q_off = 0;
  for (int32_t b = 0; b < n_batches; ++b) {
    knn_kdtree(refs + r_off * 3, r_lens[b], queries + q_off * 3, q_lens[b], k,
               out_idx + q_off * k);
    for (int64_t i = q_off * k; i < (q_off + q_lens[b]) * k; ++i)
      out_idx[i] += static_cast<int32_t>(r_off);
    r_off += r_lens[b];
    q_off += q_lens[b];
  }
}

}  // extern "C"
