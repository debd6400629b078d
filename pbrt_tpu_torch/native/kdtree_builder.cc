// Native SAH kd-tree builder (C ABI, loaded via ctypes; accel/kdtree.py's
// build): the same build as pbrt_tpu.accel.kdtree's numpy `build_kdtree`
// (reference src/accelerators/kdtreeaccel.cpp), node for node and entry for
// entry.
//
// The numpy build spends ~100 us of interpreter time a node; a scene just
// over the dense cap (306k primitives) makes ~4.6M nodes, and it took 454 s
// on the host CPU of an H100 machine.  This file repeats its arithmetic in
// the same order: split costs in double from the f32 edge positions, the
// edge events sorted stably by (t, End after Start), the first least cost
// winning, the axis retries, the badRefines budget and primitive
// duplication; nodes in preorder (below child first), leaves' primitives
// appended in that order.
// Built with -ffp-contract=off so that no product and sum are fused.
//
// Build: native/build.py (g++ -O2 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr int32_t kLeaf = 3;

struct Params {
  double isect_cost, traversal_cost, empty_bonus;
  int max_prims;
};

struct Builder {
  const float* lo;
  const float* hi;
  Params prm;
  std::vector<float> nodes_f;
  std::vector<int32_t> nodes_i;   // 3 a node
  std::vector<int32_t> prim_idx;
  // scratch of the edge sweep
  std::vector<float> t;
  std::vector<int8_t> typ;
  std::vector<int64_t> order;

  int64_t NewNode() {
    nodes_f.push_back(0.f);
    nodes_i.insert(nodes_i.end(), {kLeaf, 0, 0});
    return static_cast<int64_t>(nodes_f.size()) - 1;
  }

  void MakeLeaf(int64_t node, const std::vector<int64_t>& prims) {
    nodes_i[3 * node] = kLeaf;
    nodes_i[3 * node + 1] = static_cast<int32_t>(prim_idx.size());
    nodes_i[3 * node + 2] = static_cast<int32_t>(prims.size());
    for (int64_t p : prims) prim_idx.push_back(static_cast<int32_t>(p));
  }

  int64_t Rec(const std::vector<int64_t>& prims, const double nb_lo[3],
              const double nb_hi[3], int depth, int bad_refines) {
    const int64_t node = NewNode();
    const int64_t n = static_cast<int64_t>(prims.size());
    if (n <= prm.max_prims || depth == 0) {
      MakeLeaf(node, prims);
      return node;
    }
    double d[3];
    for (int k = 0; k < 3; ++k) d[k] = nb_hi[k] - nb_lo[k];
    const double sa = 2.0 * ((d[0] * d[1] + d[1] * d[2]) + d[2] * d[0]);
    const double inv_sa = 1.0 / std::max(sa, 1e-30);
    const double old_cost = prm.isect_cost * static_cast<double>(n);
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1;
    double best_split = 0.0;
    int axis0 = 0;
    for (int k = 1; k < 3; ++k)
      if (d[k] > d[axis0]) axis0 = k;
    for (int retry = 0; retry < 3; ++retry) {
      const int axis = (axis0 + retry) % 3;
      // the edge events, Start before End at equal t (a stable sort of
      // the lo entries, then the hi entries, by (t, type))
      t.resize(2 * n);
      typ.resize(2 * n);
      order.resize(2 * n);
      for (int64_t i = 0; i < n; ++i) {
        t[i] = lo[3 * prims[i] + axis];
        t[n + i] = hi[3 * prims[i] + axis];
        typ[i] = 0;
        typ[n + i] = 1;
      }
      std::iota(order.begin(), order.end(), 0);
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) {
                         return t[a] < t[b] ||
                                (t[a] == t[b] && typ[a] < typ[b]);
                       });
      const int oa0 = (axis + 1) % 3, oa1 = (axis + 2) % 3;
      const double base = d[oa0] * d[oa1];
      const double esum = d[oa0] + d[oa1];
      int64_t ends = 0, starts = 0;
      double k_cost = std::numeric_limits<double>::infinity();
      double k_t = 0.0;
      for (int64_t j = 0; j < 2 * n; ++j) {
        const int64_t e = order[j];
        // nAbove drops at an End before costing; nBelow grows at a Start
        // after it (kdtreeaccel.cpp:198-228)
        if (typ[e] == 1) ++ends;
        const double te = static_cast<double>(t[e]);
        const int64_t n_above = n - ends, n_below = starts;
        if (typ[e] == 0) ++starts;
        if (!(te > nb_lo[axis] && te < nb_hi[axis])) continue;
        const double p_below =
            2.0 * (base + (te - nb_lo[axis]) * esum) * inv_sa;
        const double p_above =
            2.0 * (base + (nb_hi[axis] - te) * esum) * inv_sa;
        const double eb =
            (n_above == 0 || n_below == 0) ? prm.empty_bonus : 0.0;
        const double cost =
            prm.traversal_cost +
            prm.isect_cost * (1.0 - eb) *
                (p_below * static_cast<double>(n_below) +
                 p_above * static_cast<double>(n_above));
        if (cost < k_cost) {
          k_cost = cost;
          k_t = te;
        }
      }
      if (k_cost < best_cost) {
        best_cost = k_cost;
        best_axis = axis;
        best_split = k_t;
      }
      if (best_axis >= 0) break;
    }
    if (best_cost > old_cost) ++bad_refines;
    if ((best_cost > 4 * old_cost && n < 16) || best_axis < 0 ||
        bad_refines == 3) {
      MakeLeaf(node, prims);
      return node;
    }
    // duplication: straddlers go to both children; a zero-extent prim on
    // the split plane stays below
    std::vector<int64_t> below, above;
    for (int64_t p : prims) {
      const double l = lo[3 * p + best_axis], h = hi[3 * p + best_axis];
      if (l < best_split || (l == best_split && h == best_split))
        below.push_back(p);
      if (h > best_split) above.push_back(p);
    }
    double lo_hi[3] = {nb_hi[0], nb_hi[1], nb_hi[2]};
    double hi_lo[3] = {nb_lo[0], nb_lo[1], nb_lo[2]};
    lo_hi[best_axis] = best_split;
    hi_lo[best_axis] = best_split;
    Rec(below, nb_lo, lo_hi, depth - 1, bad_refines);
    const int64_t above_child = Rec(above, hi_lo, nb_hi, depth - 1,
                                    bad_refines);
    nodes_f[node] = static_cast<float>(best_split);
    nodes_i[3 * node] = best_axis;
    nodes_i[3 * node + 1] = static_cast<int32_t>(above_child);
    nodes_i[3 * node + 2] = 0;
    return node;
  }
};

}  // namespace

extern "C" {

// Builds the kd-tree of n_prims boxes lo / hi [n_prims,3] (f32) and returns
// an opaque handle; kd_sizes gives its node and list counts, kd_copy copies
// nodes_f [N] f32, nodes_i [N,3] i32 and prim_idx [M] i32 out, kd_free
// frees it.  max_depth as accel/kdtree.py computes it.
void* kd_build(const float* lo, const float* hi, int64_t n_prims,
               int max_depth, int max_prims, double isect_cost,
               double traversal_cost, double empty_bonus) {
  Builder* b = new Builder();
  b->lo = lo;
  b->hi = hi;
  b->prm = Params{isect_cost, traversal_cost, empty_bonus, max_prims};
  double root_lo[3], root_hi[3];
  for (int k = 0; k < 3; ++k) {
    float l = lo[k], h = hi[k];
    for (int64_t i = 1; i < n_prims; ++i) {
      l = std::min(l, lo[3 * i + k]);
      h = std::max(h, hi[3 * i + k]);
    }
    root_lo[k] = l;
    root_hi[k] = h;
  }
  std::vector<int64_t> prims(n_prims);
  std::iota(prims.begin(), prims.end(), 0);
  b->Rec(prims, root_lo, root_hi, max_depth, 0);
  return b;
}

void kd_sizes(void* h, int64_t* n_nodes, int64_t* n_list) {
  Builder* b = static_cast<Builder*>(h);
  *n_nodes = static_cast<int64_t>(b->nodes_f.size());
  *n_list = static_cast<int64_t>(b->prim_idx.size());
}

void kd_copy(void* h, float* nodes_f, int32_t* nodes_i, int32_t* prim_idx) {
  Builder* b = static_cast<Builder*>(h);
  std::copy(b->nodes_f.begin(), b->nodes_f.end(), nodes_f);
  std::copy(b->nodes_i.begin(), b->nodes_i.end(), nodes_i);
  std::copy(b->prim_idx.begin(), b->prim_idx.end(), prim_idx);
}

void kd_free(void* h) { delete static_cast<Builder*>(h); }

}  // extern "C"
