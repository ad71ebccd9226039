// Superpoint mesh segmentation (offline CPU tool).
//
// Replaces the reference's external `segmentator` dependency
// (ISBNet/dataset/scannetv2/prepare_superpoint.py:13, docs/INSTALL.md:25-40):
// Felzenszwalb-Huttenlocher graph segmentation over the triangle mesh, with
// edge weights from normal dissimilarity (the ScanNet mesh-segmentation
// recipe: flat regions merge, creases split), followed by small-segment
// absorption.
//
// Build:  g++ -O3 -shared -fPIC -std=c++17 -o libsegmentator.so segmentator.cpp
//         (gapro_tpu_torch/native/segmentator.py does it at first use, into
//         gapro_tpu_torch/_build/)
// Python: gapro_tpu_torch/native/segmentator.py (ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct DSU {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  std::vector<float> internal;  // max internal edge weight ("Int" in FH)

  explicit DSU(int32_t n) : parent(n), size(n, 1), internal(n, 0.f) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void join(int32_t a, int32_t b, float w) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    internal[a] = w;  // edges processed in ascending order
  }
};

struct Edge {
  int32_t a, b;
  float w;
};

inline void vertex_normal_accumulate(const float* v, const int64_t* f,
                                     int64_t n_faces, std::vector<float>* nrm) {
  for (int64_t t = 0; t < n_faces; ++t) {
    const int64_t i = f[3 * t], j = f[3 * t + 1], k = f[3 * t + 2];
    const float* p0 = v + 3 * i;
    const float* p1 = v + 3 * j;
    const float* p2 = v + 3 * k;
    float u[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    float w[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    float n[3] = {u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                  u[0] * w[1] - u[1] * w[0]};
    for (int64_t vid : {i, j, k})
      for (int d = 0; d < 3; ++d) (*nrm)[3 * vid + d] += n[d];
  }
}

}  // namespace

extern "C" {

// vertices: [n_verts, 3] float32; faces: [n_faces, 3] int64 vertex ids.
// out_labels: [n_verts] int32 segment ids (compacted, 0-based).
// kthr: FH threshold constant (reference default 0.01);
// seg_min: minimum segment size (reference default 20).
// Returns the number of segments, or -1 on error.
int32_t segment_mesh(const float* vertices, int64_t n_verts,
                     const int64_t* faces, int64_t n_faces, float kthr,
                     int32_t seg_min, int32_t* out_labels) {
  if (n_verts <= 0) return -1;

  // 1. area-weighted vertex normals
  std::vector<float> nrm(3 * n_verts, 0.f);
  vertex_normal_accumulate(vertices, faces, n_faces, &nrm);
  for (int64_t i = 0; i < n_verts; ++i) {
    float* n = nrm.data() + 3 * i;
    float l = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (l > 1e-12f)
      for (int d = 0; d < 3; ++d) n[d] /= l;
  }

  // 2. unique undirected edges from faces, weight = normal dissimilarity.
  //    Concave creases (normals bending away across the edge) get their
  //    dissimilarity squared-down like the ScanNet segmentator, so convex
  //    object boundaries split more readily than concave room corners.
  std::vector<Edge> edges;
  edges.reserve(3 * n_faces);
  {
    std::unordered_map<uint64_t, bool> seen;
    seen.reserve(3 * n_faces);
    auto add_edge = [&](int64_t a, int64_t b) {
      if (a == b) return;
      if (a > b) std::swap(a, b);
      uint64_t key = (static_cast<uint64_t>(a) << 32) | static_cast<uint64_t>(b);
      if (!seen.emplace(key, true).second) return;
      const float* na = nrm.data() + 3 * a;
      const float* nb = nrm.data() + 3 * b;
      float dot = na[0] * nb[0] + na[1] * nb[1] + na[2] * nb[2];
      float diss = 1.0f - dot;
      // direction test: convex if the edge vector agrees with normal change
      const float* pa = vertices + 3 * a;
      const float* pb = vertices + 3 * b;
      float e[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
      float dn[3] = {nb[0] - na[0], nb[1] - na[1], nb[2] - na[2]};
      float conv = e[0] * dn[0] + e[1] * dn[1] + e[2] * dn[2];
      if (conv < 0.f) diss = diss * diss;  // concave: suppress splitting
      edges.push_back({static_cast<int32_t>(a), static_cast<int32_t>(b), diss});
    };
    for (int64_t t = 0; t < n_faces; ++t) {
      add_edge(faces[3 * t], faces[3 * t + 1]);
      add_edge(faces[3 * t + 1], faces[3 * t + 2]);
      add_edge(faces[3 * t + 2], faces[3 * t]);
    }
  }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& x, const Edge& y) { return x.w < y.w; });

  // 3. Felzenszwalb-Huttenlocher: join when w <= min(Int_a + k/|a|, Int_b + k/|b|)
  DSU dsu(static_cast<int32_t>(n_verts));
  for (const Edge& e : edges) {
    int32_t a = dsu.find(e.a), b = dsu.find(e.b);
    if (a == b) continue;
    float ta = dsu.internal[a] + kthr / dsu.size[a];
    float tb = dsu.internal[b] + kthr / dsu.size[b];
    if (e.w <= ta && e.w <= tb) dsu.join(a, b, e.w);
  }

  // 4. absorb small segments into any neighbor
  for (const Edge& e : edges) {
    int32_t a = dsu.find(e.a), b = dsu.find(e.b);
    if (a != b && (dsu.size[a] < seg_min || dsu.size[b] < seg_min))
      dsu.join(a, b, e.w);
  }

  // 5. compact ids
  std::unordered_map<int32_t, int32_t> remap;
  remap.reserve(1024);
  int32_t next = 0;
  for (int64_t i = 0; i < n_verts; ++i) {
    int32_t r = dsu.find(static_cast<int32_t>(i));
    auto it = remap.find(r);
    if (it == remap.end()) it = remap.emplace(r, next++).first;
    out_labels[i] = it->second;
  }
  return next;
}

}  // extern "C"
