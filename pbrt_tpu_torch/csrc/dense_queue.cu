// K1: per-(ray tile, triangle chunk) AABB cull for the dense intersector.
//
// Replaces pbrt_tpu/ops/pallas_intersect.py::_queue_kernel (:761), which
// _tile_chunk_lists (:812) launched once per intersect call.
//
// Contract (plain twin: ops/dense_intersect.py::tile_queue_plain): for
// tile b and chunk c, hits[b,c] says whether any live lane of the tile
// (tmax > 0) enters chunk c's box before its tmax, with the predicate of
// the TPU kernel (pallas_intersect.py:801-806)
//     tnear <= tfar * 1.0001 + 1e-5  &&  tfar > 0  &&  tnear < tmax,
// and near[b,c] is the least max(tnear, 0) over those lanes (F32_MAX if
// none).  The caller sorts each row front to back in plain torch.
//
// What bounds it on the H100: it reads each ray and each chunk box once
// per tile and does ~20 flops per (ray, chunk) pair: a few MFLOP per call
// against 67 TFLOP/s of f32, and ~1 MB read.  Launch latency and the
// torch sort that follows bound it, not arithmetic or bandwidth.
//
// Design: one block per ray tile.  The block stages the tile's origins,
// inverse directions and tmax in shared memory; each warp takes chunks in
// turn, every lane tests a strided subset of the tile's rays, and the
// warp reduces any-hit with a vote and the least entry t with shuffles.
// Products and sums use __fmul_rn/__fadd_rn so nvcc cannot contract them
// into FMAs: the predicate then rounds exactly as the plain version's,
// and hits agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kF32Max = 3.4e38f;

__global__ void dense_queue_kernel(const float* __restrict__ r16,
                                   const float* __restrict__ tmax,
                                   const float* __restrict__ chunk_bounds,
                                   int n_chunks, int tile,
                                   uint8_t* __restrict__ hits,
                                   float* __restrict__ near) {
  extern __shared__ float smem[];
  float* s_oc = smem;              // [3][tile] origin - scene center
  float* s_inv = smem + 3 * tile;  // [3][tile] 1 / direction
  float* s_tm = smem + 6 * tile;   // [tile]
  const size_t ray0 = static_cast<size_t>(blockIdx.x) * tile;

  int live = 0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const float* r = r16 + (ray0 + i) * 16;
    for (int a = 0; a < 3; ++a) {
      s_oc[a * tile + i] = r[6 + a];
      s_inv[a * tile + i] = r[9 + a];
    }
    const float tm = tmax[ray0 + i];
    s_tm[i] = tm;
    live |= tm > 0.f;
  }
  // tiles whose lanes are all dead (the coherence sort sinks them to the
  // back of the batch) skip the slab tests
  live = __syncthreads_or(live);

  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < n_chunks; c += n_warps) {
    bool any = false;
    float best = kF32Max;
    if (live) {
      const float* cb = chunk_bounds + c * 8;
      for (int i = lane; i < tile; i += 32) {
        float tnear = -kF32Max, tfar = kF32Max;
        for (int a = 0; a < 3; ++a) {
          const float oc = s_oc[a * tile + i];
          const float inv = s_inv[a * tile + i];
          const float t0 = __fmul_rn(__fsub_rn(cb[a], oc), inv);
          const float t1 = __fmul_rn(__fsub_rn(cb[4 + a], oc), inv);
          tnear = fmaxf(tnear, fminf(t0, t1));
          tfar = fminf(tfar, fmaxf(t0, t1));
        }
        const float tm = s_tm[i];
        const bool h = tnear <= __fadd_rn(__fmul_rn(tfar, 1.0001f), 1e-5f) &&
                       tfar > 0.f && tnear < tm && tm > 0.f;
        if (h) {
          any = true;
          best = fminf(best, fmaxf(tnear, 0.f));
        }
      }
    }
    any = __any_sync(0xffffffffu, any);
    for (int off = 16; off > 0; off >>= 1)
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) {
      hits[static_cast<size_t>(blockIdx.x) * n_chunks + c] = any;
      near[static_cast<size_t>(blockIdx.x) * n_chunks + c] = best;
    }
  }
}

}  // namespace

// r16 [n_tiles*tile,16], tmax [n_tiles*tile], chunk_bounds [n_chunks,8];
// hits (bool) and near [n_tiles,n_chunks].  Returns cudaGetLastError().
extern "C" int pbrt_dense_queue(const float* r16, const float* tmax,
                                const float* chunk_bounds, int n_tiles,
                                int n_chunks, int tile, uint8_t* hits,
                                float* near, cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = 7 * tile * sizeof(float);
  dense_queue_kernel<<<n_tiles, threads, smem, stream>>>(
      r16, tmax, chunk_bounds, n_chunks, tile, hits, near);
  return static_cast<int>(cudaGetLastError());
}
