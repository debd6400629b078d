// G1: SPPM's photon gather, every (visible point, photon) pair's distance
// test and the deposit of the photons inside a point's radius, in one
// launch (integrators/sppm.py::gather; plain twin gather_plain there).
//
// Replaces no Pallas kernel: pbrt_tpu deposits photons with the XLA chunk
// loop of pbrt_tpu/integrators/sppm.py::_photon_pass (:161-168), shaped
// for the TPU's matrix unit: per chunk of 1,024 photons the [V,1024,3]
// differences, their squares, d2 [V,1024], a float mask and the product
// mask @ beta [1024,31].  As plain torch that loop writes and reads again
// ~8 GB of intermediates a chunk on the card, 128 chunks a call at
// V = P = 131,044.
//
// Contract: for each visible point v and photon p, with d = vp_p[v] - p[p],
//     d2 = (d.x * d.x + d.y * d.y) + d.z * d.z,
// each product and sum rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn: nvcc may not contract them into FMAs, and torch's
// elementwise ops never do), and the pair is a hit iff
//     d2 <= r2[v] && vp_valid[v] && alive[p].
// A hit adds beta[p] [31] to tau_add[v] and 1 to M[v]: the sums are
// written to tau_out and M_out, and the inputs are left as they were.
// Each point's photons are added in ascending index,
// by one thread, with no atomics: two launches give the same bits.  Only
// the order of the f32 additions differs from the plain version's (its
// chunk sums come from a matrix product); the set of hits is the same.
//
// What bounds it on the H100: the f32 operations of the pair tests, V P of
// them a call, 8 each (3 subtractions, 3 products, 2 sums; the compare
// besides): at 33.5e12 f32 instructions/s, 4.1 ms a call at
// V = P = 131,044.  The bytes are small: the photons' positions (1.6 MB a
// call, read by every block from L2), the visible points' state (18 MB
// read and written once), and beta's rows of the hits alone (P x 124 B =
// 16 MB, resident in the 50 MB L2).
//
// Design: each thread owns kPts visible points and keeps each one's
// position, r2, M and tau_add[31] in registers for the whole call.  The
// block stages the photons in tiles of kTile float4 in shared memory; a
// dead photon and the ragged end of the last tile are staged as NaN, and
// an invalid or out-of-range point holds r2 = NaN, so the one compare
// `d2 <= r2` carries the whole predicate (any compare with NaN is false)
// and the inner loop has no mask.  Every thread tests the photons of the
// tile, each read as one broadcast 16-byte shared load, against its
// points, kGroup photons at a time, and or's the compares into one flag
// (a predicate fused into each compare).  A hit is rare (~3 photons a
// point a call), so only a group that holds one is walked again, in
// photon order, to add the rows of its hits, read from beta in L2.
// Nothing of a pair reaches device memory.
//
// Tuned on the H100 at the cell's shapes (PERF.md section 6, row G1): a
// warp's 16-byte shared load takes four cycles of the SM's 128 B/clk, so
// with one point a thread it set the pace (8.6 ms a call, branching on
// every pair); two points a thread share each load, and the group's one
// branch leaves 9 f32 instructions a pair in the hot loop (6.5 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNS = 31;          // spectral samples (core/spectrum.py)
constexpr int kThreads = 256;    // threads a block
constexpr int kPts = 2;          // visible points a thread owns
constexpr int kTile = 1024;      // photons a block stages at a time
constexpr int kGroup = 8;        // photons tested before one hit branch
static_assert(kTile % kGroup == 0, "a tile holds whole groups");

// d2 of a point and a photon, rounded as the plain version's
__device__ __forceinline__ float dist2(float x, float y, float z, float4 e) {
  const float dx = __fsub_rn(x, e.x);
  const float dy = __fsub_rn(y, e.y);
  const float dz = __fsub_rn(z, e.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
    sppm_gather_kernel(const float* __restrict__ vp_p,
                       const uint8_t* __restrict__ vp_valid,
                       const float* __restrict__ r2,
                       const float* __restrict__ p,
                       const uint8_t* __restrict__ alive,
                       const float* __restrict__ beta,
                       const float* __restrict__ tau_add,
                       const float* __restrict__ M, int V, int P,
                       float* __restrict__ tau_out,
                       float* __restrict__ M_out) {
  __shared__ float4 s_p[kTile];
  const float nan = __int_as_float(0x7fffffff);
  const int base = blockIdx.x * (kThreads * kPts) + threadIdx.x;

  float x[kPts], y[kPts], z[kPts], rr[kPts], m[kPts], tau[kPts][kNS];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int v = base + j * kThreads;
    const bool in = v < V;
    const size_t v3 = 3 * static_cast<size_t>(in ? v : 0);
    x[j] = in ? vp_p[v3] : 0.f;
    y[j] = in ? vp_p[v3 + 1] : 0.f;
    z[j] = in ? vp_p[v3 + 2] : 0.f;
    rr[j] = (in && vp_valid[v]) ? r2[v] : nan;
    m[j] = in ? M[v] : 0.f;
    const float* t = tau_add + kNS * static_cast<size_t>(in ? v : 0);
#pragma unroll
    for (int k = 0; k < kNS; ++k) tau[j][k] = in ? t[k] : 0.f;
  }

  for (int t0 = 0; t0 < P; t0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int q = t0 + i;
      float4 e = make_float4(nan, nan, nan, 0.f);
      if (q < P && alive[q]) {
        const size_t q3 = 3 * static_cast<size_t>(q);
        e = make_float4(p[q3], p[q3 + 1], p[q3 + 2], 0.f);
      }
      s_p[i] = e;
    }
    __syncthreads();
    for (int i0 = 0; i0 < kTile; i0 += kGroup) {
      // the hot loop: every pair of the group tested, the hits or'ed
      bool any = false;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float4 e = s_p[i0 + g];
#pragma unroll
        for (int j = 0; j < kPts; ++j)
          any |= dist2(x[j], y[j], z[j], e) <= rr[j];
      }
      if (__builtin_expect(any, 0)) {
        // rare: the group again, in photon order, depositing each hit
#pragma unroll 1
        for (int g = 0; g < kGroup; ++g) {
          const float4 e = s_p[i0 + g];
          const float* b = beta + kNS * static_cast<size_t>(t0 + i0 + g);
#pragma unroll
          for (int j = 0; j < kPts; ++j) {
            if (dist2(x[j], y[j], z[j], e) <= rr[j]) {
#pragma unroll
              for (int k = 0; k < kNS; ++k)
                tau[j][k] = __fadd_rn(tau[j][k], __ldg(b + k));
              m[j] = __fadd_rn(m[j], 1.f);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int v = base + j * kThreads;
    if (v >= V) continue;
    M_out[v] = m[j];
    float* t = tau_out + kNS * static_cast<size_t>(v);
#pragma unroll
    for (int k = 0; k < kNS; ++k) t[k] = tau[j][k];
  }
}

}  // namespace

// vp_p [V,3] f32, vp_valid [V] bool (uint8), r2 [V] f32, p [P,3] f32,
// alive [P] bool (uint8), beta [P,31] f32, tau_add [V,31] and M [V] f32
// -> tau_out [V,31] and M_out [V] f32, which overlap no input.  V and P
// at least 1.  Returns cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int pbrt_sppm_gather(const float* vp_p, const uint8_t* vp_valid,
                                const float* r2, const float* p,
                                const uint8_t* alive, const float* beta,
                                const float* tau_add, const float* M,
                                int V, int P, float* tau_out, float* M_out,
                                cudaStream_t stream) {
  if (V < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads * kPts;
  const int blocks = (V + per_block - 1) / per_block;
  sppm_gather_kernel<<<blocks, kThreads, 0, stream>>>(
      vp_p, vp_valid, r2, p, alive, beta, tau_add, M, V, P, tau_out,
      M_out);
  return static_cast<int>(cudaGetLastError());
}
