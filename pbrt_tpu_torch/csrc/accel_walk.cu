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
//       node's box (two float4 loads); a hit leaf tests its first
//       min(count, max_leaf) triangle rows in order, the first least t
//       winning if below the running best (pbrt_tpu's K = max_leaf; the
//       leaf's other primitives are never tested, ROADMAP Queue 3 (v)),
//       then the miss link; a hit interior node its hit link, a missed
//       node its miss link.
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
// What bounds it on the H100: the node rows (32 bytes a BVH node, 16 a kd
// node) and the triangle rows (48 bytes, 96 with motion) each ray reads,
// and ~70 f32 operations a triangle test and ~20 a slab test;
// kernel_workloads.walk_bound counts them from the plain version's visit
// counts.  The rows of the upper tree are shared by all rays and stay in
// L1 / L2.  A simple kernel: no coherence sort, packet traversal or wider
// node (later work, PERF.md).

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

// triangle row pid (v0 | e1 | e2 | 0, three float4), moved to time u
template <bool kMotion>
__device__ __forceinline__ void load_tri(const float4* __restrict__ tris,
                                         const float4* __restrict__ motion,
                                         int pid, float u, float v0[3],
                                         float e1[3], float e2[3]) {
  const float4 a = __ldg(tris + 3 * pid), b = __ldg(tris + 3 * pid + 1),
               c = __ldg(tris + 3 * pid + 2);
  v0[0] = a.x; v0[1] = a.y; v0[2] = a.z;
  e1[0] = a.w; e1[1] = b.x; e1[2] = b.y;
  e2[0] = b.z; e2[1] = b.w; e2[2] = c.x;
  if (kMotion) {
    const float4 ma = __ldg(motion + 3 * pid),
                 mb = __ldg(motion + 3 * pid + 1),
                 mc = __ldg(motion + 3 * pid + 2);
    const float dm[9] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w,
                         mc.x};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v0[k] = __fadd_rn(v0[k], __fmul_rn(u, dm[k]));
      e1[k] = __fadd_rn(e1[k], __fmul_rn(u, dm[3 + k]));
      e2[k] = __fadd_rn(e2[k], __fmul_rn(u, dm[6 + k]));
    }
  }
}

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
                const int* __restrict__ hit_links,
                const int* __restrict__ miss_links,
                const float4* __restrict__ tris,
                const float4* __restrict__ motion, int n_rays, int n_nodes,
                int n_prims, int max_leaf, float* __restrict__ t_out,
                int* __restrict__ prim_out) {
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
  const int* hl = hit_links + oct * n_nodes;
  const int* ml = miss_links + oct * n_nodes;
  int node = 0;
  for (int step = 0; node < n_nodes && step <= n_nodes; ++step) {
    const float4 a = __ldg(nodes + 2 * node), b = __ldg(nodes + 2 * node + 1);
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
    const int bits = __float_as_int(b.z);
    const bool leaf = bits >= 0;
    if (box && leaf) {
      const int off = bits >> 5, n = min(bits & 31, max_leaf);
      float t_min = kF32Max;
      int k_best = 0;
      bool h_best = false;
      for (int k = 0; k < n; ++k) {
        const int pid = min(max(off + k, 0), n_prims - 1);
        float v0[3], e1[3], e2[3], t;
        load_tri<kMotion>(tris, motion, pid, u, v0, e1, e2);
        const bool h = tri_test(r, v0, e1, e2, t_best, &t);
        const float tm = h ? t : kF32Max;
        if (k == 0 || tm < t_min) {
          t_min = tm;
          k_best = k;
          h_best = h;
        }
      }
      if (h_best && t_min < t_best) {
        t_best = t_min;
        prim = min(max(off + k_best, 0), n_prims - 1);
      }
    }
    int nxt = (box && !leaf) ? __ldg(hl + node) : __ldg(ml + node);
    if (any && prim >= 0) nxt = n_nodes;
    node = nxt;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
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
  const bool live = t0g <= __fadd_rn(__fmul_rn(t1g, 1.0001f), 1e-5f) &&
                    tmax[i] > 0.f;
  int node = live ? 0 : -1;
  float t_entry = live ? t0g : 0.f, t_cell = live ? t1g : 0.f;
  for (int step = 0; node >= 0 && step < kMaxKdSteps; ++step) {
    const float4 row = __ldg(nodes + node);
    const int axis = __float_as_int(row.y);
    const int ri1 = __float_as_int(row.z), ri2 = __float_as_int(row.w);
    if (axis != kKdLeaf) {
      // descend toward the child that holds the point at t_entry
      const float o_ax = sel3(r.o[0], r.o[1], r.o[2], axis);
      const float d_ax = sel3(r.d[0], r.d[1], r.d[2], axis);
      const float inv_ax = sel3(r.inv[0], r.inv[1], r.inv[2], axis);
      const float split = row.x;
      const float p_at = __fadd_rn(o_ax, __fmul_rn(t_entry, d_ax));
      const bool below_first =
          p_at < split || (p_at == split && d_ax <= 0.f);
      const int near = below_first ? node + 1 : ri1;
      const float t_split = __fmul_rn(__fsub_rn(split, o_ax), inv_ax);
      if (t_split > t_entry && t_split < t_cell)
        t_cell = fminf(t_cell, t_split);
      node = min(near, n_nodes - 1);
      continue;
    }
    // the leaf's duplicated primitive list
    const int n = min(ri2, max_leaf);
    float t_min = kF32Max;
    int pid_best = 0;
    bool h_best = false;
    for (int k = 0; k < n; ++k) {
      const int pid = __ldg(prim_idx + min(max(ri1 + k, 0), n_list - 1));
      float v0[3], e1[3], e2[3], t;
      load_tri<kMotion>(tris, motion, pid, u, v0, e1, e2);
      const bool h = tri_test(r, v0, e1, e2, t_best, &t);
      const float tm = h ? t : kF32Max;
      if (k == 0 || tm < t_min) {
        t_min = tm;
        pid_best = pid;
        h_best = h;
      }
    }
    if (h_best && t_min < t_best) {
      t_best = t_min;
      prim = pid_best;
    }
    // restart past the finished cell, 4 ULPs on
    float adv = __int_as_float(__float_as_int(fmaxf(t_cell, 0.f)) + 4);
    if (t_cell <= 0.f) adv = 1e-30f;
    const bool done = adv >= fminf(t_best, t1g) || (any && prim >= 0);
    node = done ? -1 : 0;
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
// [n_nodes,8], hit / miss links [8,n_nodes]; tris and motion [n_prims,12]
// (motion null when time is).  Writes t_out, prim_out [n_rays].  Returns
// the launch's CUDA error code.
extern "C" int pbrt_bvh_walk(const float* o, const float* d,
                             const float* time, const float* t_init,
                             const int* prim_init, const uint8_t* anyhit,
                             const float* nodes, const int* hit_links,
                             const int* miss_links, const float* tris,
                             const float* motion, int n_rays, int n_nodes,
                             int n_prims, int max_leaf, float* t_out,
                             int* prim_out, cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* m4 = reinterpret_cast<const float4*>(motion);
  if (time != nullptr)
    bvh_walk_kernel<true><<<blocks, kThreads, 0, stream>>>(
        o, d, time, t_init, prim_init, anyhit, n4, hit_links, miss_links,
        t4, m4, n_rays, n_nodes, n_prims, max_leaf, t_out, prim_out);
  else
    bvh_walk_kernel<false><<<blocks, kThreads, 0, stream>>>(
        o, d, time, t_init, prim_init, anyhit, n4, hit_links, miss_links,
        t4, m4, n_rays, n_nodes, n_prims, max_leaf, t_out, prim_out);
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
