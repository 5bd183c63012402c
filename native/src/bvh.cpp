// SAH BVH builder over sphere primitives — native equivalent of the
// reference's BvhNode construction (src/books/*/bvh.rs:16-156): binary BVH,
// 12-bucket surface-area heuristic over the longest axis of the centroid
// bounds, with sorted-median fallbacks for degenerate centroids or
// non-improving splits (bvh.rs:56-61,118-123,140-145).
//
// Two consumers:
//  * rtt_build_bvh: full flattened tree (bbox_min/max, children, leaf prim)
//    for host-side queries and future traversal kernels;
//  * rtt_cluster_spheres: a treelet cut of the same SAH tree into <= max_leaf
//    -sized clusters (a primitive reordering + per-cluster AABBs), the
//    layout a cluster-culled intersect loop consumes.
//
// Exposed via ctypes from rustraytrace_tpu/native.py; a NumPy fallback with
// identical semantics lives in rustraytrace_tpu/ops/bvh.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Aabb {
  float mn[3] = {1e30f, 1e30f, 1e30f};
  float mx[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const Aabb& o) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], o.mn[k]);
      mx[k] = std::max(mx[k], o.mx[k]);
    }
  }
  void grow_point(const float* p) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], p[k]);
      mx[k] = std::max(mx[k], p[k]);
    }
  }
  float area() const {  // aabb.rs:97-102 surface_area
    float dx = std::max(0.0f, mx[0] - mn[0]);
    float dy = std::max(0.0f, mx[1] - mn[1]);
    float dz = std::max(0.0f, mx[2] - mn[2]);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
  int longest_axis() const {  // aabb.rs:87-95
    float dx = mx[0] - mn[0], dy = mx[1] - mn[1], dz = mx[2] - mn[2];
    if (dx >= dy && dx >= dz) return 0;
    return dy >= dz ? 1 : 2;
  }
};

struct Builder {
  const float* centers;
  const float* radii;
  std::vector<Aabb> prim_box;
  std::vector<int> order;
  // flattened output
  float* bbox_min;
  float* bbox_max;
  int* left;
  int* right;
  int* leaf_prim;
  int n_nodes = 0;
  int max_leaf;

  int new_node() { return n_nodes++; }

  // Build over order[lo, hi); returns node index.
  int build(int lo, int hi) {
    int node = new_node();
    Aabb box;
    Aabb cbox;
    for (int i = lo; i < hi; ++i) {
      box.grow(prim_box[order[i]]);
      cbox.grow_point(&centers[order[i] * 3]);
    }
    for (int k = 0; k < 3; ++k) {
      bbox_min[node * 3 + k] = box.mn[k];
      bbox_max[node * 3 + k] = box.mx[k];
    }
    int n = hi - lo;
    if (n <= max_leaf) {
      left[node] = -1;
      right[node] = -1;
      leaf_prim[node] = lo;           // start index into `order`
      // encode count in `right` as -(count) so one array carries both
      right[node] = -n;
      return node;
    }

    int axis = cbox.longest_axis();
    float cmin = cbox.mn[axis], cmax = cbox.mx[axis];
    int mid = -1;

    if (cmax - cmin > 1e-12f) {
      // 12-bucket SAH (bvh.rs:63-117)
      constexpr int NB = 12;
      Aabb bbox[NB];
      int bcount[NB] = {0};
      float inv = NB / (cmax - cmin);
      for (int i = lo; i < hi; ++i) {
        int b = (int)((centers[order[i] * 3 + axis] - cmin) * inv);
        if (b >= NB) b = NB - 1;
        if (b < 0) b = 0;
        bcount[b]++;
        bbox[b].grow(prim_box[order[i]]);
      }
      float best_cost = 1e30f;
      int best_split = -1;
      for (int s = 1; s < NB; ++s) {
        Aabb lb, rb;
        int lc = 0, rc = 0;
        for (int b = 0; b < s; ++b) {
          if (bcount[b]) { lb.grow(bbox[b]); lc += bcount[b]; }
        }
        for (int b = s; b < NB; ++b) {
          if (bcount[b]) { rb.grow(bbox[b]); rc += bcount[b]; }
        }
        if (!lc || !rc) continue;
        float cost = lc * lb.area() + rc * rb.area();
        if (cost < best_cost) { best_cost = cost; best_split = s; }
      }
      if (best_split > 0 && best_cost < n * box.area()) {
        float pivot = cmin + best_split * (cmax - cmin) / NB;
        auto it = std::partition(
            order.begin() + lo, order.begin() + hi,
            [&](int p) { return centers[p * 3 + axis] < pivot; });
        mid = (int)(it - order.begin());
        if (mid == lo || mid == hi) mid = -1;  // failed split fallback
      }
    }

    if (mid < 0) {
      // sorted-median fallback (bvh.rs:118-123,140-145)
      mid = lo + n / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid,
                       order.begin() + hi, [&](int a, int b) {
                         return centers[a * 3 + axis] < centers[b * 3 + axis];
                       });
    }

    int l = build(lo, mid);
    int r = build(mid, hi);
    left[node] = l;
    right[node] = r;
    leaf_prim[node] = -1;
    return node;
  }
};

}  // namespace

namespace {

// Shared driver once prim_box/centroids are set up.
int run_build(Builder& b, const float* cents, int n, int max_leaf,
              float* bbox_min, float* bbox_max, int* left, int* right,
              int* leaf_prim, int* order_out) {
  b.centers = cents;
  b.max_leaf = max_leaf;
  b.bbox_min = bbox_min;
  b.bbox_max = bbox_max;
  b.left = left;
  b.right = right;
  b.leaf_prim = leaf_prim;
  b.order.resize(n);
  for (int i = 0; i < n; ++i) b.order[i] = i;
  b.build(0, n);
  for (int i = 0; i < n; ++i) order_out[i] = b.order[i];
  return b.n_nodes;
}

}  // namespace

extern "C" {

// Build a flattened SAH BVH. Caller allocates for up to 2n nodes.
// Outputs: bbox_min/max [2n,3], left [2n], right [2n] (leaf: right = -count),
// leaf_prim [2n] (leaf: start into order; internal: -1), order [n]
// (permutation of primitive ids). Returns node count (root = node 0),
// or -1 on bad input.
int rtt_build_bvh(const float* centers, const float* radii, int n,
                  int max_leaf, float* bbox_min, float* bbox_max, int* left,
                  int* right, int* leaf_prim, int* order_out) {
  if (n <= 0 || max_leaf < 1) return -1;
  Builder b;
  b.radii = radii;
  b.prim_box.resize(n);
  for (int i = 0; i < n; ++i) {
    float r = std::fabs(radii[i]);
    for (int k = 0; k < 3; ++k) {
      b.prim_box[i].mn[k] = centers[i * 3 + k] - r;
      b.prim_box[i].mx[k] = centers[i * 3 + k] + r;
    }
  }
  return run_build(b, centers, n, max_leaf, bbox_min, bbox_max, left, right,
                   leaf_prim, order_out);
}

// Same build over arbitrary primitive AABBs (pmin/pmax [n,3]); bucket keys
// are the AABB centroids.  Box primitives get tight cluster bounds this way
// (no bounding-sphere inflation).
int rtt_build_bvh_aabb(const float* pmin, const float* pmax, int n,
                       int max_leaf, float* bbox_min, float* bbox_max,
                       int* left, int* right, int* leaf_prim,
                       int* order_out) {
  if (n <= 0 || max_leaf < 1) return -1;
  Builder b;
  b.radii = nullptr;
  b.prim_box.resize(n);
  std::vector<float> cents(3 * n);
  for (int i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      b.prim_box[i].mn[k] = pmin[i * 3 + k];
      b.prim_box[i].mx[k] = pmax[i * 3 + k];
      cents[i * 3 + k] = 0.5f * (pmin[i * 3 + k] + pmax[i * 3 + k]);
    }
  }
  return run_build(b, cents.data(), n, max_leaf, bbox_min, bbox_max, left,
                   right, leaf_prim, order_out);
}

// Treelet-cut clustering: SAH leaves of size <= max_leaf become clusters.
// Outputs: order [n] (primitive permutation, cluster-contiguous),
// cluster_start [n+1] (offsets into order; cluster c = order[start[c] ..
// start[c+1]) ), cluster_min/max [n,3]. Returns the cluster count.
static int treelet_cut(int n_nodes, const float* bmin, const float* bmax,
                       const int* right, const int* leaf, int* cluster_start,
                       float* cluster_min, float* cluster_max);

int rtt_cluster_spheres(const float* centers, const float* radii, int n,
                        int max_leaf, int* order_out, int* cluster_start,
                        float* cluster_min, float* cluster_max) {
  std::vector<float> bmin(2 * n * 3), bmax(2 * n * 3);
  std::vector<int> left(2 * n), right(2 * n), leaf(2 * n);
  int n_nodes = rtt_build_bvh(centers, radii, n, max_leaf, bmin.data(),
                              bmax.data(), left.data(), right.data(),
                              leaf.data(), order_out);
  return treelet_cut(n_nodes, bmin.data(), bmax.data(), right.data(),
                     leaf.data(), cluster_start, cluster_min, cluster_max);
}

// AABB-primitive variant of the treelet-cut clustering (box primitives).
int rtt_cluster_aabbs(const float* pmin, const float* pmax, int n,
                      int max_leaf, int* order_out, int* cluster_start,
                      float* cluster_min, float* cluster_max) {
  std::vector<float> bmin(2 * n * 3), bmax(2 * n * 3);
  std::vector<int> left(2 * n), right(2 * n), leaf(2 * n);
  int n_nodes = rtt_build_bvh_aabb(pmin, pmax, n, max_leaf, bmin.data(),
                                   bmax.data(), left.data(), right.data(),
                                   leaf.data(), order_out);
  return treelet_cut(n_nodes, bmin.data(), bmax.data(), right.data(),
                     leaf.data(), cluster_start, cluster_min, cluster_max);
}

static int treelet_cut(int n_nodes, const float* bmin, const float* bmax,
                       const int* right, const int* leaf, int* cluster_start,
                       float* cluster_min, float* cluster_max) {
  if (n_nodes < 0) return -1;
  int nc = 0;
  int pos = 0;
  // node ids are assigned preorder, so in node order the leaves' `order`
  // ranges [leaf[node], leaf[node] - right[node]) are contiguous ascending
  for (int node = 0; node < n_nodes; ++node) {
    if (leaf[node] >= 0) {
      int count = -right[node];
      cluster_start[nc] = leaf[node];
      if (leaf[node] != pos) return -2;  // invariant check
      for (int k = 0; k < 3; ++k) {
        cluster_min[nc * 3 + k] = bmin[node * 3 + k];
        cluster_max[nc * 3 + k] = bmax[node * 3 + k];
      }
      pos += count;
      nc++;
    }
  }
  cluster_start[nc] = pos;
  return nc;
}

}  // extern "C"
