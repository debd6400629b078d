// K2: Plücker closest-hit / any-hit ray-triangle loop of the dense
// intersector.
//
// Replaces pbrt_tpu/ops/pallas_intersect.py::_kernel_loop (:329), which
// dense_intersect_loop (:589) launched once per intersect call (the static
// variant; the motion-blur variant with n_coef=4 is not ported yet).
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

// Section rows of a W chunk block [16][4*chunk] (section-major inside the
// row: s1 | s2 | num | s0, each chunk wide) that K2 reads, in the order
// they are staged: s1 rows 0-5, s2 rows 0-5, s0 rows 0-5, num rows 6-8
// and the constant row 15.
__device__ __forceinline__ int staged_offset(int row, int chunk) {
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
  return w * 4 * chunk + sec * chunk;
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
