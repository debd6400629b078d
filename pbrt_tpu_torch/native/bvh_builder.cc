// Native SAH BVH builder (C ABI, loaded via ctypes).
//
// The TPU framework equivalent of the reference's C++ BVH construction
// (src/accelerators/bvh.cpp: binned SAH build :236+, flattening :640) —
// scene compilation is host-side native code here just as it is in the
// reference; only the *traversal* moved to TPU kernels.  Emits the same
// octant-threaded layout as accel/bvh.py (packed [N,8] nodes + 8 per-octant
// hit/miss link tables) so the Python builder is a drop-in fallback.
//
// Build: see pbrt_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBuckets = 12;
constexpr float kTraversalCost = 0.125f;

struct Node {
  float lo[3], hi[3];
  int left = -1, right = -1;  // indices into node pool
  int first = 0, count = 0;
  int axis = 0;
};

struct Builder {
  const double* plo;
  const double* phi;
  std::vector<double> cx, cy, cz;
  std::vector<int64_t> order;
  std::vector<int64_t> ordered;
  std::vector<Node> nodes;
  int max_leaf;
  int64_t out_pos = 0;

  const double* C(int dim) const {
    return dim == 0 ? cx.data() : (dim == 1 ? cy.data() : cz.data());
  }

  int NewNode() {
    nodes.emplace_back();
    return (int)nodes.size() - 1;
  }

  static double Area(const double lo[3], const double hi[3]) {
    double d0 = std::max(hi[0] - lo[0], 0.0);
    double d1 = std::max(hi[1] - lo[1], 0.0);
    double d2 = std::max(hi[2] - lo[2], 0.0);
    return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
  }

  int Build(int64_t lo_i, int64_t hi_i) {
    int ni = NewNode();
    int64_t count = hi_i - lo_i;
    {
      double blo[3] = {1e300, 1e300, 1e300}, bhi[3] = {-1e300, -1e300, -1e300};
      for (int64_t k = lo_i; k < hi_i; ++k) {
        int64_t p = order[k];
        for (int d = 0; d < 3; ++d) {
          blo[d] = std::min(blo[d], plo[p * 3 + d]);
          bhi[d] = std::max(bhi[d], phi[p * 3 + d]);
        }
      }
      for (int d = 0; d < 3; ++d) {
        nodes[ni].lo[d] = (float)blo[d];
        nodes[ni].hi[d] = (float)bhi[d];
      }
    }
    if (count <= max_leaf) return MakeLeaf(ni, lo_i, hi_i);

    // centroid bounds + widest axis
    double clo[3] = {1e300, 1e300, 1e300}, chi[3] = {-1e300, -1e300, -1e300};
    for (int64_t k = lo_i; k < hi_i; ++k) {
      int64_t p = order[k];
      double c[3] = {cx[p], cy[p], cz[p]};
      for (int d = 0; d < 3; ++d) {
        clo[d] = std::min(clo[d], c[d]);
        chi[d] = std::max(chi[d], c[d]);
      }
    }
    int dim = 0;
    double ext = chi[0] - clo[0];
    for (int d = 1; d < 3; ++d)
      if (chi[d] - clo[d] > ext) { ext = chi[d] - clo[d]; dim = d; }
    nodes[ni].axis = dim;
    if (ext < 1e-12) {
      if (count <= 4 * max_leaf) return MakeLeaf(ni, lo_i, hi_i);
      return Split(ni, lo_i, hi_i, dim, lo_i + count / 2);
    }

    // binned SAH (reference bvh.cpp:236+)
    int64_t bucket_count[kBuckets] = {0};
    double b_lo[kBuckets][3], b_hi[kBuckets][3];
    for (int b = 0; b < kBuckets; ++b)
      for (int d = 0; d < 3; ++d) { b_lo[b][d] = 1e300; b_hi[b][d] = -1e300; }
    const double* cc = C(dim);
    auto bucket_of = [&](int64_t p) {
      int b = (int)(kBuckets * (cc[p] - clo[dim]) / ext);
      return std::min(b, kBuckets - 1);
    };
    for (int64_t k = lo_i; k < hi_i; ++k) {
      int64_t p = order[k];
      int b = bucket_of(p);
      bucket_count[b]++;
      for (int d = 0; d < 3; ++d) {
        b_lo[b][d] = std::min(b_lo[b][d], plo[p * 3 + d]);
        b_hi[b][d] = std::max(b_hi[b][d], phi[p * 3 + d]);
      }
    }
    double node_lo[3], node_hi[3];
    for (int d = 0; d < 3; ++d) {
      node_lo[d] = nodes[ni].lo[d];
      node_hi[d] = nodes[ni].hi[d];
    }
    double total_area = std::max(Area(node_lo, node_hi), 1e-30);
    double best_cost = 1e300;
    int best_split = -1;
    for (int s = 0; s < kBuckets - 1; ++s) {
      int64_t n0 = 0, n1 = 0;
      double l0[3] = {1e300, 1e300, 1e300}, h0[3] = {-1e300, -1e300, -1e300};
      double l1[3] = {1e300, 1e300, 1e300}, h1[3] = {-1e300, -1e300, -1e300};
      for (int b = 0; b <= s; ++b) {
        n0 += bucket_count[b];
        for (int d = 0; d < 3; ++d) {
          l0[d] = std::min(l0[d], b_lo[b][d]);
          h0[d] = std::max(h0[d], b_hi[b][d]);
        }
      }
      for (int b = s + 1; b < kBuckets; ++b) {
        n1 += bucket_count[b];
        for (int d = 0; d < 3; ++d) {
          l1[d] = std::min(l1[d], b_lo[b][d]);
          h1[d] = std::max(h1[d], b_hi[b][d]);
        }
      }
      if (n0 == 0 || n1 == 0) continue;
      double cost = kTraversalCost +
                    (n0 * Area(l0, h0) + n1 * Area(l1, h1)) / total_area;
      if (cost < best_cost) { best_cost = cost; best_split = s; }
    }
    double leaf_cost = (double)count;
    if (best_split < 0 || (count <= max_leaf && best_cost >= leaf_cost))
      return MakeLeaf(ni, lo_i, hi_i);
    // partition via stable sort on centroid then cut at bucket boundary
    std::stable_sort(order.begin() + lo_i, order.begin() + hi_i,
                     [&](int64_t a, int64_t b) { return cc[a] < cc[b]; });
    int64_t mid = lo_i;
    for (int64_t k = lo_i; k < hi_i; ++k)
      if (bucket_of(order[k]) <= best_split) ++mid; else break;
    if (mid == lo_i || mid == hi_i) mid = lo_i + count / 2;
    return Split(ni, lo_i, hi_i, dim, mid);
  }

  int MakeLeaf(int ni, int64_t lo_i, int64_t hi_i) {
    nodes[ni].first = (int)out_pos;
    nodes[ni].count = (int)(hi_i - lo_i);
    for (int64_t k = lo_i; k < hi_i; ++k) ordered[out_pos++] = order[k];
    return ni;
  }

  int Split(int ni, int64_t lo_i, int64_t hi_i, int dim, int64_t mid) {
    const double* cc = C(dim);
    std::stable_sort(order.begin() + lo_i, order.begin() + hi_i,
                     [&](int64_t a, int64_t b) { return cc[a] < cc[b]; });
    int l = Build(lo_i, mid);
    int r = Build(mid, hi_i);
    nodes[ni].left = l;
    nodes[ni].right = r;
    return ni;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes; fills caller-provided buffers sized generously
// (2*P nodes max).  packed: [N*8] f32; hit/miss: [8*N] i32 each;
// prim_order: [P] i32.
int64_t build_bvh_native(const double* prim_lo, const double* prim_hi,
                         int64_t n_prims, int max_leaf,
                         float* packed, int32_t* hit_links,
                         int32_t* miss_links, int32_t* prim_order) {
  Builder b;
  b.plo = prim_lo;
  b.phi = prim_hi;
  b.max_leaf = max_leaf;
  b.cx.resize(n_prims);
  b.cy.resize(n_prims);
  b.cz.resize(n_prims);
  for (int64_t i = 0; i < n_prims; ++i) {
    b.cx[i] = 0.5 * (prim_lo[i * 3 + 0] + prim_hi[i * 3 + 0]);
    b.cy[i] = 0.5 * (prim_lo[i * 3 + 1] + prim_hi[i * 3 + 1]);
    b.cz[i] = 0.5 * (prim_lo[i * 3 + 2] + prim_hi[i * 3 + 2]);
  }
  b.order.resize(n_prims);
  for (int64_t i = 0; i < n_prims; ++i) b.order[i] = i;
  b.ordered.resize(n_prims);
  b.nodes.reserve((size_t)(2 * n_prims + 1));
  int root = b.Build(0, n_prims);

  // canonical DFS numbering (left-first), matching accel/bvh.py
  int64_t N = 0;
  std::vector<int> dfs_index(b.nodes.size(), -1);
  std::vector<int> stack = {root};
  std::vector<int> flat;
  while (!stack.empty()) {
    int ni = stack.back();
    stack.pop_back();
    dfs_index[ni] = (int)N;
    flat.push_back(ni);
    ++N;
    if (b.nodes[ni].left >= 0) {
      stack.push_back(b.nodes[ni].right);
      stack.push_back(b.nodes[ni].left);
    }
  }

  for (int64_t i = 0; i < N; ++i) {
    const Node& nd = b.nodes[flat[i]];
    packed[i * 8 + 0] = nd.lo[0];
    packed[i * 8 + 1] = nd.lo[1];
    packed[i * 8 + 2] = nd.lo[2];
    packed[i * 8 + 3] = nd.hi[0];
    packed[i * 8 + 4] = nd.hi[1];
    packed[i * 8 + 5] = nd.hi[2];
    int32_t leaf_bits = nd.left < 0 ? ((nd.first << 5) | nd.count) : -1;
    std::memcpy(&packed[i * 8 + 6], &leaf_bits, 4);
    packed[i * 8 + 7] = (float)nd.axis;
  }

  // per-octant near-first threading
  for (int oct = 0; oct < 8; ++oct) {
    std::vector<std::pair<int, int>> st = {{root, (int)N}};
    while (!st.empty()) {
      auto [ni, after] = st.back();
      st.pop_back();
      int i = dfs_index[ni];
      miss_links[oct * N + i] = after;
      const Node& nd = b.nodes[ni];
      if (nd.left < 0) {
        hit_links[oct * N + i] = (int)N;
        continue;
      }
      bool neg = (oct >> nd.axis) & 1;
      int first = neg ? nd.right : nd.left;
      int second = neg ? nd.left : nd.right;
      hit_links[oct * N + i] = dfs_index[first];
      st.push_back({second, after});
      st.push_back({first, dfs_index[second]});
    }
  }
  for (int64_t i = 0; i < n_prims; ++i)
    prim_order[i] = (int32_t)b.ordered[i];
  return N;
}

}  // extern "C"
