// B1, D1: the BVH walk and the kd-tree walk, the hit search of a scene over
// the dense cap (ops/accel_walk.py; plain twins bvh_walk_plain and
// kd_walk_plain there).
//
// Replaces no Pallas kernel: pbrt_tpu runs these walks as XLA loops,
// pbrt_tpu/ops/intersect.py::_intersect_bvh (:591-649, with _leaf_test
// :386-425) and ::_intersect_kd (:656-768), one lax.while_loop over the
// whole batch until its last lane ends, because a per-ray stack suits no
// vector machine.  As plain torch that loop costs a host sync and ~40
// launches a step, hundreds to thousands of steps a batch, so on the card
// each walk is one kernel with one thread per ray.
//
//   bvh_walk_kernel<kMotion>  from node 0 to the sentinel N through the
//       octant's threaded links (accel/bvh.py): the slab test of the
//       node's box; a hit leaf tests its first min(count, max_leaf)
//       triangle rows in order, the first least t winning if below the
//       running best (pbrt_tpu's K = max_leaf; the leaf's other primitives
//       are never tested, ROADMAP Queue 3 (v)), then the miss link; a hit
//       interior node its hit link, a missed node its miss link.
//   kd_walk_kernel<kMotion>   kd-restart (accel/kdtree.py) exactly as
//       _intersect_kd: the segment against the root box, a descent
//       toward the child holding the point at t_entry (p_at, the
//       d_ax <= 0 tie rule), the cell's exit shrunk where the split plane
//       is crossed, the leaf's duplicated primitive list, and t_entry moved
//       4 ULPs past the cell by an integer bit increment before the
//       descent restarts from the root.
// kMotion moves each tested triangle's vertices to clamp(time, 0, 1)
// (tri_motion rows d0 | de1 | de2).  An any-hit lane stops once it holds
// a hit (a quadric pre-hit included).
//
// Ties and rounding: every product and sum is written __fmul_rn /
// __fadd_rn / __fsub_rn / __frcp_rn / __fdiv_rn in the plain version's
// order, so that nvcc cannot contract them into FMAs (torch's elementwise
// ops never do), and min / max are exact.  The walk visits nodes and
// triangles in the plain version's order, so (t, prim) agree bit for bit.
//
// What bounds them on the H100: neither the bytes nor the operations
// (kernel_workloads.walk_bound: 0.3-2.2% of their time in their first,
// one-load-at-a-time form), but one lane's chain of dependent loads.  A
// batch's 65,536-131,072 threads are all on the card at once, so a walk
// lasts about as long as its longest lane (the 1% of lanes with the most
// node visits, alone, take as long as the whole batch or longer), and
// each step of that lane waits on a load whose address the step before
// produced.  The design shortens that chain and overlaps the arithmetic
// with it; the sequence of nodes and tests stays the same.  Each choice
// below was A/B-tested against its alternatives on the card
// (tools/ab_walk.py; PERF.md section 6):
//
//   BVH: a step's node row and its octant's (hit, miss) link pair (the
//       derived table `links` [8,N] int2, scene.bvh_links) were loaded by
//       the step before, so a step opens with its row in registers: it
//       then issues, in one round trip, both possible successors' rows and
//       link pairs and, at a leaf, the rows of its first kTriGroup
//       triangles, before the slab test resolves which successor it takes.
//       The first form's step waited on the row, then on the link, then
//       on each triangle in turn.
//   kd: each restart descends level by level from the root as kd-restart
//       does, one 16-byte row a level (an L1 hit for the upper tree), and a
//       leaf loads its list entries, then their triangle rows, kTriGroup
//       at a time, before the tests run in order; the first form's leaf
//       waited on each entry, then on its triangle, one at a time.
//       Replaying the last descent from a per-thread cache in shared
//       memory (36 levels, 36 KB a block) and loading both children ahead
//       of the choice measured slower (PERF.md section 6): the shared
//       memory the cache takes is the L1 that holds the upper tree and the
//       leaves' rows, and the upper levels it saves were L1 hits.
// A coherence order of the rays moved no batch by more than 8% (PERF.md),
// and packets or a wider node would change the visit order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // threads a block
constexpr float kF32Max = 3.4e38f;       // ops/dense_intersect.py F32_MAX
// 1 + 2 gamma(3) (core/geometry.py bounds_ray_intersect), rounded to f32
// as torch rounds the Python double
constexpr float kSlabScale = static_cast<float>(
    1.0 + 2.0 * ((3 * 5.960464477539063e-08) /
                 (1.0 - 3 * 5.960464477539063e-08)));
constexpr int kKdLeaf = 3;
// a walk that took this many steps is broken (a BVH walk takes at most N,
// a kd walk's t_entry only grows); it stops rather than hang the card
constexpr int kMaxKdSteps = 1 << 24;
// triangles whose rows a leaf loads before testing them (4, pbrt's
// MAX_LEAF_SIZE, held more registers and was no faster)
constexpr int kTriGroup = 2;

__device__ __forceinline__ float sel3(float a, float b, float c, int k) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// pbrt_tpu's guarded reciprocal: 1/d, or sign(d) * 1e20 + 1e20
__device__ __forceinline__ float inv_dir(float d) {
  if (fabsf(d) > 1e-20f) return __frcp_rn(d);
  const float s = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
  return __fadd_rn(__fmul_rn(s, 1e20f), 1e20f);
}

struct Ray {
  float o[3], d[3], inv[3];
  // ray_triangle's per-ray part: the permutation and the shear
  int kx, ky, kz;
  float sx, sy, sz;
};

__device__ __forceinline__ void load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d, int i,
                                         Ray& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[3 * i + k];
    r.d[k] = d[3 * i + k];
    r.inv[k] = inv_dir(r.d[k]);
  }
  // kz = argmax |d| (the first of equal ones), kx, ky cyclic after it
  const float a0 = fabsf(r.d[0]), a1 = fabsf(r.d[1]), a2 = fabsf(r.d[2]);
  r.kz = (a1 > a0) ? 1 : 0;
  if (a2 > (r.kz == 0 ? a0 : a1)) r.kz = 2;
  r.kx = (r.kz + 1) % 3;
  r.ky = (r.kx + 1) % 3;
  const float dz = sel3(r.d[0], r.d[1], r.d[2], r.kz);
  r.sx = __fdiv_rn(-sel3(r.d[0], r.d[1], r.d[2], r.kx), dz);
  r.sy = __fdiv_rn(-sel3(r.d[0], r.d[1], r.d[2], r.ky), dz);
  r.sz = __frcp_rn(dz);
}

// ray_triangle (ops/intersect.py) for one triangle: translate, permute,
// shear, the three edge functions (zero within a few ulps of their
// terms), the sign-consistent range test against tmax.
__device__ __forceinline__ bool tri_test(const Ray& r, const float v0[3],
                                         const float e1[3], const float e2[3],
                                         float tmax, float* t_out) {
  float x[3], y[3], z[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pk = v == 0 ? v0[k]
                              : __fadd_rn(v0[k], v == 1 ? e1[k] : e2[k]);
      p[k] = __fsub_rn(pk, r.o[k]);
    }
    const float xx = sel3(p[0], p[1], p[2], r.kx);
    const float yy = sel3(p[0], p[1], p[2], r.ky);
    const float zz = sel3(p[0], p[1], p[2], r.kz);
    x[v] = __fadd_rn(xx, __fmul_rn(r.sx, zz));
    y[v] = __fadd_rn(yy, __fmul_rn(r.sy, zz));
    z[v] = zz;
  }
  float ed[3];
  const int a[3] = {1, 2, 0}, b[3] = {2, 0, 1};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = __fmul_rn(x[a[k]], y[b[k]]);
    const float q = __fmul_rn(y[a[k]], x[b[k]]);
    const float e = __fsub_rn(p, q);
    const bool on = fabsf(e) <= __fmul_rn(__fadd_rn(fabsf(p), fabsf(q)),
                                          4e-7f);
    ed[k] = on ? 0.f : e;
  }
  const bool neg = ed[0] < 0.f || ed[1] < 0.f || ed[2] < 0.f;
  const bool pos = ed[0] > 0.f || ed[1] > 0.f || ed[2] > 0.f;
  const float det = __fadd_rn(__fadd_rn(ed[0], ed[1]), ed[2]);
  bool ok = !(neg && pos) && det != 0.f;
  const float t_scaled = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ed[0], z[0]), __fmul_rn(ed[1], z[1])),
                __fmul_rn(ed[2], z[2])),
      r.sz);
  const float tm = __fmul_rn(tmax, det);
  const bool bad = det < 0.f ? (t_scaled >= 0.f || t_scaled < tm)
                             : (t_scaled <= 0.f || t_scaled > tm);
  ok = ok && !bad;
  *t_out = __fmul_rn(t_scaled, __frcp_rn(det == 0.f ? 1.f : det));
  return ok;
}

// The rows of up to kTriGroup triangles (v0 | e1 | e2 | 0, three float4,
// and with motion d0 | de1 | de2): loaded together, for the tests after.
template <bool kMotion>
struct TriRows {
  static constexpr int kG = kTriGroup;
  float4 r[kG][3];
  float4 m[kMotion ? kG : 1][3];
  int pid[kG];

  // rows of triangles pid[j] for j < n - k0 (the others are not loaded)
  __device__ __forceinline__ void load(const float4* __restrict__ tris,
                                       const float4* __restrict__ motion,
                                       int k0, int n) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (k0 + j < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          r[j][c] = __ldg(tris + 3 * pid[j] + c);
          if constexpr (kMotion) m[j][c] = __ldg(motion + 3 * pid[j] + c);
        }
      }
    }
  }

  // the tests of triangles k0 .. min(k0 + kG, n) - 1 in order, below
  // t_best, moved to time u: the first least t of the leaf so far wins
  __device__ __forceinline__ void test(const Ray& ray, float u, int k0,
                                       int n, float t_best, float& t_min,
                                       int& pid_best, bool& h_best) const {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (k0 + j >= n) break;
      const float4 a = r[j][0], b = r[j][1], c = r[j][2];
      float v0[3] = {a.x, a.y, a.z}, e1[3] = {a.w, b.x, b.y},
            e2[3] = {b.z, b.w, c.x};
      if constexpr (kMotion) {
        const float4 ma = m[j][0], mb = m[j][1], mc = m[j][2];
        const float dm[9] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w,
                             mc.x};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          v0[k] = __fadd_rn(v0[k], __fmul_rn(u, dm[k]));
          e1[k] = __fadd_rn(e1[k], __fmul_rn(u, dm[3 + k]));
          e2[k] = __fadd_rn(e2[k], __fmul_rn(u, dm[6 + k]));
        }
      }
      float t;
      const bool h = tri_test(ray, v0, e1, e2, t_best, &t);
      const float tm = h ? t : kF32Max;
      if (k0 + j == 0 || tm < t_min) {
        t_min = tm;
        pid_best = pid[j];
        h_best = h;
      }
    }
  }
};

__device__ __forceinline__ float shutter(const float* time, int i) {
  return fminf(fmaxf(time[i], 0.f), 1.f);
}

template <bool kMotion>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ time,
                const float* __restrict__ t_init,
                const int* __restrict__ prim_init,
                const uint8_t* __restrict__ anyhit,
                const float4* __restrict__ nodes,
                const int2* __restrict__ links,
                const float4* __restrict__ tris,
                const float4* __restrict__ motion, int n_rays, int n_nodes,
                int n_prims, int max_leaf, float* __restrict__ t_out,
                int* __restrict__ prim_out) {
  constexpr int kG = kTriGroup;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  load_ray(o, d, i, r);
  const float u = kMotion ? shutter(time, i) : 0.f;
  float t_best = t_init[i];
  int prim = prim_init[i];
  const bool any = anyhit != nullptr && anyhit[i] != 0;
  const int oct = (r.d[0] < 0.f ? 1 : 0) | (r.d[1] < 0.f ? 2 : 0) |
                  (r.d[2] < 0.f ? 4 : 0);
  const int2* lk = links + static_cast<size_t>(oct) * n_nodes;
  int node = 0;
  // the step's node: its box row and its (hit, miss) links
  float4 a = __ldg(nodes), b = __ldg(nodes + 1);
  int2 ln = __ldg(lk);
  for (int step = 0; node < n_nodes && step <= n_nodes; ++step) {
    // this step's loads, issued before its arithmetic: both successors'
    // rows and links (the sentinel's clamped), and a leaf's first rows
    const int hc = min(max(ln.x, 0), n_nodes - 1);
    const int mc = min(max(ln.y, 0), n_nodes - 1);
    const float4 ha = __ldg(nodes + 2 * hc), hb = __ldg(nodes + 2 * hc + 1);
    const float4 ma = __ldg(nodes + 2 * mc), mb = __ldg(nodes + 2 * mc + 1);
    const int2 hl = __ldg(lk + hc), ml = __ldg(lk + mc);
    const int bits = __float_as_int(b.z);
    const bool leaf = bits >= 0;
    const int off = bits >> 5, n = leaf ? min(bits & 31, max_leaf) : 0;
    TriRows<kMotion> rows;
#pragma unroll
    for (int j = 0; j < kG; ++j)
      rows.pid[j] = min(max(off + j, 0), n_prims - 1);
    rows.load(tris, motion, 0, n);
    // the slab test of the node's box
    const float lo[3] = {a.x, a.y, a.z}, hi[3] = {a.w, b.x, b.y};
    float tnear = -INFINITY, tfar = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float t0 = __fmul_rn(__fsub_rn(lo[k], r.o[k]), r.inv[k]);
      const float t1 = __fmul_rn(__fsub_rn(hi[k], r.o[k]), r.inv[k]);
      tnear = fmaxf(tnear, fminf(t0, t1));
      tfar = fminf(tfar, fmaxf(t0, t1));
    }
    tfar = __fmul_rn(tfar, kSlabScale);
    const bool box = tnear <= tfar && tnear < t_best && tfar > 0.f;
    if (box && leaf) {
      float t_min = kF32Max;
      int pid_best = 0;
      bool h_best = false;
      rows.test(r, u, 0, n, t_best, t_min, pid_best, h_best);
      for (int k0 = kG; k0 < n; k0 += kG) {
#pragma unroll
        for (int j = 0; j < kG; ++j)
          rows.pid[j] = min(max(off + k0 + j, 0), n_prims - 1);
        rows.load(tris, motion, k0, n);
        rows.test(r, u, k0, n, t_best, t_min, pid_best, h_best);
      }
      if (h_best && t_min < t_best) {
        t_best = t_min;
        prim = pid_best;
      }
    }
    const bool enter = box && !leaf;
    int nxt = enter ? ln.x : ln.y;
    if (any && prim >= 0) nxt = n_nodes;
    a = enter ? ha : ma;
    b = enter ? hb : mb;
    ln = enter ? hl : ml;
    node = nxt;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
}

// a kd node's row: an interior node's split, axis and above child (its
// below child is the next row), or a leaf's axis kKdLeaf, list offset and
// count
struct KdRow {
  float split;
  int axis, a, b;
};

__device__ __forceinline__ KdRow kd_load(const float4* __restrict__ nodes,
                                         int node) {
  const float4 r = __ldg(nodes + node);
  return {r.x, __float_as_int(r.y), __float_as_int(r.z),
          __float_as_int(r.w)};
}

template <bool kMotion>
__global__ void __launch_bounds__(kThreads)
kd_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ time,
               const float* __restrict__ tmax,
               const float* __restrict__ t_init,
               const int* __restrict__ prim_init,
               const uint8_t* __restrict__ anyhit,
               const float4* __restrict__ nodes,
               const int* __restrict__ prim_idx,
               const float* __restrict__ bounds,
               const float4* __restrict__ tris,
               const float4* __restrict__ motion, int n_rays, int n_nodes,
               int n_list, int n_prims, int max_leaf,
               float* __restrict__ t_out, int* __restrict__ prim_out) {
  constexpr int kG = kTriGroup;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  load_ray(o, d, i, r);
  const float u = kMotion ? shutter(time, i) : 0.f;
  float t_best = t_init[i];
  int prim = prim_init[i];
  const bool any = anyhit != nullptr && anyhit[i] != 0;
  // the ray's segment in the root box
  float t0g = -INFINITY, t1g = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ta = __fmul_rn(__fsub_rn(bounds[k], r.o[k]), r.inv[k]);
    const float tb = __fmul_rn(__fsub_rn(bounds[3 + k], r.o[k]), r.inv[k]);
    t0g = fmaxf(t0g, fminf(ta, tb));
    t1g = fminf(t1g, fmaxf(ta, tb));
  }
  t0g = fmaxf(t0g, 0.f);
  bool walking = t0g <= __fadd_rn(__fmul_rn(t1g, 1.0001f), 1e-5f) &&
                 tmax[i] > 0.f;
  float t_entry = t0g, t_cell = t1g;
  int step = 0;
  while (walking) {
    // the descent from the root toward the point at t_entry
    int node = 0;
    KdRow row = kd_load(nodes, 0);
    while (row.axis != kKdLeaf && ++step < kMaxKdSteps) {
      const int axis = row.axis, above = row.a;
      const float o_ax = sel3(r.o[0], r.o[1], r.o[2], axis);
      const float d_ax = sel3(r.d[0], r.d[1], r.d[2], axis);
      const float inv_ax = sel3(r.inv[0], r.inv[1], r.inv[2], axis);
      const float split = row.split;
      const float p_at = __fadd_rn(o_ax, __fmul_rn(t_entry, d_ax));
      const bool below = p_at < split || (p_at == split && d_ax <= 0.f);
      const float t_split = __fmul_rn(__fsub_rn(split, o_ax), inv_ax);
      if (t_split > t_entry && t_split < t_cell)
        t_cell = fminf(t_cell, t_split);
      node = min(below ? node + 1 : above, n_nodes - 1);
      row = kd_load(nodes, node);
    }
    if (row.axis != kKdLeaf) break;       // a broken tree: stop
    // the leaf's duplicated primitive list: entries, then their rows
    const int off = row.a, n = min(row.b, max_leaf);
    float t_min = kF32Max;
    int pid_best = 0;
    bool h_best = false;
    for (int k0 = 0; k0 < n; k0 += kG) {
      TriRows<kMotion> rows;
#pragma unroll
      for (int j = 0; j < kG; ++j)
        rows.pid[j] = k0 + j < n
                          ? __ldg(prim_idx + min(max(off + k0 + j, 0),
                                                 n_list - 1))
                          : 0;
      rows.load(tris, motion, k0, n);
      rows.test(r, u, k0, n, t_best, t_min, pid_best, h_best);
    }
    if (h_best && t_min < t_best) {
      t_best = t_min;
      prim = pid_best;
    }
    // restart past the finished cell, 4 ULPs on
    float adv = __int_as_float(__float_as_int(fmaxf(t_cell, 0.f)) + 4);
    if (t_cell <= 0.f) adv = 1e-30f;
    walking = !(adv >= fminf(t_best, t1g) || (any && prim >= 0)) &&
              ++step < kMaxKdSteps;
    t_entry = adv;
    t_cell = t1g;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
}

}  // namespace

// The BVH walk over n_rays rays (ops/accel_walk.py bvh_walk): o, d
// [n_rays,3], time [n_rays] or null (null: the static instantiation),
// t_init, prim_init [n_rays], anyhit [n_rays] bytes or null; nodes
// [n_nodes,8], links [8,n_nodes,2] (each octant's hit and miss link);
// tris and motion [n_prims,12] (motion null when time is).  Writes t_out,
// prim_out [n_rays].  Returns the launch's CUDA error code.
extern "C" int pbrt_bvh_walk(const float* o, const float* d,
                             const float* time, const float* t_init,
                             const int* prim_init, const uint8_t* anyhit,
                             const float* nodes, const int* links,
                             const float* tris, const float* motion,
                             int n_rays, int n_nodes, int n_prims,
                             int max_leaf, float* t_out, int* prim_out,
                             cudaStream_t stream) {
  // (an empty tree has no node 0 to read: ops/accel_walk.py raises)
  if (n_rays <= 0 || n_nodes <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const int2* l2 = reinterpret_cast<const int2*>(links);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* m4 = reinterpret_cast<const float4*>(motion);
  if (time != nullptr)
    bvh_walk_kernel<true><<<blocks, kThreads, 0, stream>>>(
        o, d, time, t_init, prim_init, anyhit, n4, l2, t4, m4, n_rays,
        n_nodes, n_prims, max_leaf, t_out, prim_out);
  else
    bvh_walk_kernel<false><<<blocks, kThreads, 0, stream>>>(
        o, d, time, t_init, prim_init, anyhit, n4, l2, t4, m4, n_rays,
        n_nodes, n_prims, max_leaf, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

// The kd walk (ops/accel_walk.py kd_walk): as pbrt_bvh_walk, with the
// rays' tmax [n_rays], nodes [n_nodes,4], the duplicated list prim_idx
// [n_list] and the root box bounds [2,3].
extern "C" int pbrt_kd_walk(const float* o, const float* d,
                            const float* time, const float* tmax,
                            const float* t_init, const int* prim_init,
                            const uint8_t* anyhit, const float* nodes,
                            const int* prim_idx, const float* bounds,
                            const float* tris, const float* motion,
                            int n_rays, int n_nodes, int n_list, int n_prims,
                            int max_leaf, float* t_out, int* prim_out,
                            cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* m4 = reinterpret_cast<const float4*>(motion);
  if (time != nullptr)
    kd_walk_kernel<true><<<blocks, kThreads, 0, stream>>>(
        o, d, time, tmax, t_init, prim_init, anyhit, n4, prim_idx, bounds,
        t4, m4, n_rays, n_nodes, n_list, n_prims, max_leaf, t_out,
        prim_out);
  else
    kd_walk_kernel<false><<<blocks, kThreads, 0, stream>>>(
        o, d, time, tmax, t_init, prim_init, anyhit, n4, prim_idx, bounds,
        t4, m4, n_rays, n_nodes, n_list, n_prims, max_leaf, t_out,
        prim_out);
  return static_cast<int>(cudaGetLastError());
}
