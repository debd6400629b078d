// K2: Plücker closest-hit / any-hit ray-triangle loop of the dense
// intersector.
//
// Replaces pbrt_tpu/ops/pallas_intersect.py::_kernel_loop (:329), which
// dense_intersect_loop (:589) launched once per intersect call, in both of
// its variants: the static one (n_coef=1, `dense_loop_kernel` below) and
// the motion-blur one (n_coef=4, `dense_loop_motion_kernel` at the end of
// this file), which takes each ray's shutter time.
//
// Contract (plain twin: ops/dense_intersect.py::loop_hits_plain): each
// ray r = [d, (o-c)xd, o-c, 1/d, anyhit, 0, 0, 1] is tested against every
// triangle of its tile's first n_active listed chunks.  With the sections
// s1, s2, s0 (edge sides) and num of a triangle, nd = s0 + s1 + s2, the
// ray is inside iff the three sides share a sign bit, and t = num / nd is
// accepted when t > 1e-4 and (t, prim) is lexicographically below the
// lane's best (initially (tmax, -1): tmax <= 0 marks a dead lane).  Any-hit
// lanes stop at their first accept and report t = -1.
//
// What bounds it on the H100: f32 arithmetic at best.  A ray-triangle test
// is 21 FMAs, two adds, a division and a few integer ops, with every
// operand of the triangle read from shared memory as a warp-wide
// broadcast; device memory traffic is one 11 KB chunk per (tile, active
// chunk), served mostly from L2.  This first version is far below the f32
// FMA peak (PERF.md gives an estimate of its share): the per-chunk
// barriers and the staging latency they expose, and the IEEE division,
// come first.
//
// Design: one thread per ray, one block per ray tile.  The block walks
// its tile's active chunks front to back; for each it stages the chunk's
// 22 used section rows (s1, s2, s0: 6 floats each; num: 3 + a constant)
// as f32 structure-of-arrays in shared memory, synchronises, and every
// thread tests its ray against all of them.  The inside test works on
// sign bits, as the TPU kernel does (:496-499), so rays through a shared
// edge see consistent signs from both triangles.  The winner is an exact
// lexicographic (t, prim) minimum, replacing the TPU kernel's lane id
// packed into t's low mantissa bits, and t is a true division.  Lanes
// that are done (any-hit after an accept, or dead) skip the tests but
// keep joining the block's barriers.  cp.async double buffering of the
// next chunk and tensor cores are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 22;   // staged section rows per triangle

// Section rows of a W chunk block [16][ncoef*4*chunk] (inside a row:
// coefficient-major, then section-major: s1 | s2 | num | s0, each chunk
// wide) that K2 reads, in the order they are staged: s1 rows 0-5, s2 rows
// 0-5, s0 rows 0-5, num rows 6-8 and the constant row 15.  The offset is
// that of coefficient plane 0; plane k lies k*4*chunk further on.
__device__ __forceinline__ int staged_offset(int row, int chunk,
                                             int ncoef = 1) {
  int sec, w;
  if (row < 6) {
    sec = 0; w = row;
  } else if (row < 12) {
    sec = 1; w = row - 6;
  } else if (row < 18) {
    sec = 3; w = row - 12;
  } else if (row < 21) {
    sec = 2; w = row - 12;
  } else {
    sec = 2; w = 15;
  }
  return w * ncoef * 4 * chunk + sec * chunk;
}

__device__ __forceinline__ float side(const float* s, int chunk, int j,
                                      const float r[6]) {
  float v = r[5] * s[5 * chunk + j];
  for (int k = 4; k >= 0; --k) v = fmaf(r[k], s[k * chunk + j], v);
  return v;
}

__global__ void dense_loop_kernel(const float* __restrict__ r16,
                                  const float* __restrict__ tmax,
                                  const float* __restrict__ W,
                                  const int* __restrict__ chunk_list,
                                  const int* __restrict__ n_active,
                                  int n_chunks, int chunk,
                                  float* __restrict__ t_out,
                                  int* __restrict__ prim_out) {
  extern __shared__ float sec[];   // [kRows][chunk]
  const size_t ray = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const float* r = r16 + ray * 16;
  float dm[6];                      // d, (o-c) x d
  for (int k = 0; k < 6; ++k) dm[k] = r[k];
  const float o0 = r[6], o1 = r[7], o2 = r[8];
  const bool anyhit = r[12] > 0.5f;
  float t_best = tmax[ray];
  int prim = -1;
  bool done = !(t_best > 0.f);

  const int na = n_active[blockIdx.x];
  const int* list = chunk_list + static_cast<size_t>(blockIdx.x) * n_chunks;
  for (int k = 0; k < na; ++k) {
    const int c = list[k];
    const float* wc = W + static_cast<size_t>(c) * 16 * 4 * chunk;
    __syncthreads();   // every thread is done with the previous chunk
    for (int idx = threadIdx.x; idx < kRows * chunk; idx += blockDim.x) {
      const int row = idx / chunk;
      const int j = idx - row * chunk;
      sec[idx] = wc[staged_offset(row, chunk) + j];
    }
    __syncthreads();
    if (done) continue;
    const float* s1p = sec;
    const float* s2p = sec + 6 * chunk;
    const float* s0p = sec + 12 * chunk;
    const float* np = sec + 18 * chunk;
    const int base = c * chunk;
    for (int j = 0; j < chunk; ++j) {
      const float s1 = side(s1p, chunk, j, dm);
      const float s2 = side(s2p, chunk, j, dm);
      const float s0 = side(s0p, chunk, j, dm);
      const float num = fmaf(o0, np[j],
                             fmaf(o1, np[chunk + j],
                                  fmaf(o2, np[2 * chunk + j],
                                       np[3 * chunk + j])));
      const float nd = (s0 + s1) + s2;
      const float t = num / nd;
      const int i0 = __float_as_int(s0);
      const int inside = (i0 ^ __float_as_int(s1)) |
                         (i0 ^ __float_as_int(s2));
      const int p = base + j;
      if (inside >= 0 && t > 1e-4f &&
          (t < t_best || (t == t_best && p < prim))) {
        t_best = t;
        prim = p;
        if (anyhit) {
          t_best = -1.f;
          done = true;
          break;
        }
      }
    }
  }
  t_out[ray] = t_best;
  prim_out[ray] = prim;
}

}  // namespace

// r16 [n_tiles*tile,16], tmax [n_tiles*tile], W [n_chunks,16,4*chunk],
// chunk_list [n_tiles,n_chunks], n_active [n_tiles]; t_out, prim_out
// [n_tiles*tile].  Returns cudaGetLastError().
extern "C" int pbrt_dense_loop(const float* r16, const float* tmax,
                               const float* W, const int* chunk_list,
                               const int* n_active, int n_tiles,
                               int n_chunks, int chunk, int tile,
                               float* t_out, int* prim_out,
                               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows) * chunk * sizeof(float);
  dense_loop_kernel<<<n_tiles, tile, smem, stream>>>(
      r16, tmax, W, chunk_list, n_active, n_chunks, chunk, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2 motion: _kernel_loop with n_coef=4 (pallas_intersect.py:329-572; the
// Horner combine at :470-487, the per-ray time in meta row 2 at
// :637-643).  Plain twin: ops/dense_intersect.py::loop_hits_motion_plain.
//
// Contract: that of dense_loop_kernel, with every section entry a cubic in
// the ray's shutter time u in [0,1].  The table W [n_chunks,16,4*4*chunk]
// holds the four monomial coefficient planes of each entry, coefficient-
// major inside a chunk (build_dense_tables_motion); static triangles have
// zero planes 1-3.
//
// Where the TPU kernel dots the ray with each coefficient plane and
// Horner-combines the four dot outputs, this kernel first Horner-combines
// the four staged coefficients of each of the 22 rows it reads, in the
// ray's own time (3 FMAs a row, 66 a triangle), and then dots once (21
// FMAs): 87 FMAs per ray-triangle test against the static kernel's 21.
// Both orders evaluate the same polynomial; loop_t_reference_motion bounds
// the rounding of either.  A static triangle's Horner returns its plane 0
// entry exactly, so static triangles cost the extra FMAs but round as in
// the static kernel.
//
// What bounds it on the H100: f32 FMAs, about 4x the static kernel's per
// test.  Shared memory per chunk is 22 rows x 4 planes x chunk x 4 B: 45 KB
// at 128 triangles, under the 48 KB a block gets by default; coarser
// chunks (scenes above 73,728 triangles) opt in to more, up to the 227 KB
// a Hopper block can have.  The four coefficients of a row sit together as
// a float4, so one broadcast load fetches them.

namespace {

constexpr int kCoef = 4;
constexpr size_t kSmemDefault = 48 * 1024;

__device__ __forceinline__ float horner(float4 c, float u) {
  return fmaf(fmaf(fmaf(c.w, u, c.z), u, c.y), u, c.x);
}

__device__ __forceinline__ float side_motion(const float4* s, int chunk,
                                             int j, const float r[6],
                                             float u) {
  float v = r[5] * horner(s[5 * chunk + j], u);
  for (int k = 4; k >= 0; --k)
    v = fmaf(r[k], horner(s[k * chunk + j], u), v);
  return v;
}

__global__ void dense_loop_motion_kernel(const float* __restrict__ r16,
                                         const float* __restrict__ tmax,
                                         const float* __restrict__ time,
                                         const float* __restrict__ W,
                                         const int* __restrict__ chunk_list,
                                         const int* __restrict__ n_active,
                                         int n_chunks, int chunk,
                                         float* __restrict__ t_out,
                                         int* __restrict__ prim_out) {
  // [kRows][chunk] float4s: the four coefficient planes of each entry
  extern __shared__ __align__(16) float msec[];
  const float4* sec4 = reinterpret_cast<const float4*>(msec);
  const size_t ray = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const float* r = r16 + ray * 16;
  float dm[6];                      // d, (o-c) x d
  for (int k = 0; k < 6; ++k) dm[k] = r[k];
  const float o0 = r[6], o1 = r[7], o2 = r[8];
  const bool anyhit = r[12] > 0.5f;
  const float u = time[ray];
  float t_best = tmax[ray];
  int prim = -1;
  bool done = !(t_best > 0.f);

  const int na = n_active[blockIdx.x];
  const int* list = chunk_list + static_cast<size_t>(blockIdx.x) * n_chunks;
  const int per_row = kCoef * chunk;
  for (int k = 0; k < na; ++k) {
    const int c = list[k];
    const float* wc = W + static_cast<size_t>(c) * 16 * kCoef * 4 * chunk;
    __syncthreads();   // every thread is done with the previous chunk
    for (int idx = threadIdx.x; idx < kRows * per_row; idx += blockDim.x) {
      const int row = idx / per_row;
      const int rem = idx - row * per_row;
      const int q = rem / chunk;                 // coefficient plane
      const int j = rem - q * chunk;
      msec[(row * chunk + j) * kCoef + q] =
          wc[staged_offset(row, chunk, kCoef) + q * 4 * chunk + j];
    }
    __syncthreads();
    if (done) continue;
    const float4* s1p = sec4;
    const float4* s2p = sec4 + 6 * chunk;
    const float4* s0p = sec4 + 12 * chunk;
    const float4* np = sec4 + 18 * chunk;
    const int base = c * chunk;
    for (int j = 0; j < chunk; ++j) {
      const float s1 = side_motion(s1p, chunk, j, dm, u);
      const float s2 = side_motion(s2p, chunk, j, dm, u);
      const float s0 = side_motion(s0p, chunk, j, dm, u);
      const float num = fmaf(o0, horner(np[j], u),
                             fmaf(o1, horner(np[chunk + j], u),
                                  fmaf(o2, horner(np[2 * chunk + j], u),
                                       horner(np[3 * chunk + j], u))));
      const float nd = (s0 + s1) + s2;
      const float t = num / nd;
      const int i0 = __float_as_int(s0);
      const int inside = (i0 ^ __float_as_int(s1)) |
                         (i0 ^ __float_as_int(s2));
      const int p = base + j;
      if (inside >= 0 && t > 1e-4f &&
          (t < t_best || (t == t_best && p < prim))) {
        t_best = t;
        prim = p;
        if (anyhit) {
          t_best = -1.f;
          done = true;
          break;
        }
      }
    }
  }
  t_out[ray] = t_best;
  prim_out[ray] = prim;
}

}  // namespace

// As pbrt_dense_loop, plus time [n_tiles*tile] (each ray's shutter time in
// [0,1]); W is [n_chunks,16,4*4*chunk].  Returns cudaGetLastError(), or
// the error of raising the block's shared-memory limit.
extern "C" int pbrt_dense_loop_motion(const float* r16, const float* tmax,
                                      const float* time, const float* W,
                                      const int* chunk_list,
                                      const int* n_active, int n_tiles,
                                      int n_chunks, int chunk, int tile,
                                      float* t_out, int* prim_out,
                                      cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kRows) * kCoef * chunk * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_loop_motion_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dense_loop_motion_kernel<<<n_tiles, tile, smem, stream>>>(
      r16, tmax, time, W, chunk_list, n_active, n_chunks, chunk, t_out,
      prim_out);
  return static_cast<int>(cudaGetLastError());
}
