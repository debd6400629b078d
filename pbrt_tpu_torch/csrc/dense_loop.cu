// K2: Plücker closest-hit / any-hit ray-triangle loop of the dense
// intersector.
//
// Replaces pbrt_tpu/ops/pallas_intersect.py::_kernel_loop (:329), which
// dense_intersect_loop (:589) launched once per intersect call, in both of
// its variants: the static one (n_coef=1, `dense_loop_kernel` below) and
// the motion-blur one (n_coef=4, `dense_loop_motion_kernel` at the end of
// this file), which takes each ray's shutter time.
//
// The static kernel is a template over an ablation mode (LoopMode below);
// production K2 is its kFull instantiation.  The other modes replace the
// TPU rounds' ablation copies of the loop kernel:
// scripts/ablate_loop.py::make(mode).kern (:39), ablate_pick.py::
// make_kernel(mode).kern (:59) and ablate_kernel_step.py::make_kernel(
// mode)._kernel (:44).  Those were copies and drifted from the kernel
// they measured; these are the production body with parts compiled out.
// One more instantiation, kDump, is the tile dump (`pbrt_dense_tile_dump`
// below), replacing the TPU rounds' debug kernels of the loop kernel:
// scripts/debug/dbg_dense_dump.py::kern (:49), one tile's DMA assembly and
// dot for explicit picks, and scripts/debug/dbg_dense_full.py::kernel
// (:45), an instrumented copy of _kernel_loop dumping the dot's output and
// the epilogue.  Being K2's own body, it stages, rounds and accepts as K2
// does.
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
// What bounds it on the H100, as tools/ablate_k2.py splits its time per
// listed (tile, chunk) step (PERF.md, H100 80GB HBM3 at 700 W): on the
// Cornell random rays, the section dot products take 54% (each test
// issues 22 shared-memory broadcast loads beside its 18 FMAs and 3
// multiplies: LDS 22, FFMA 35 with the division's, in the SASS), the
// epilogue 35% (the IEEE division, the inside test, the compare), the
// staging 10% and the loop with its barriers 2%.  Reading the sections
// from device memory instead (the direct mode, no staging and no
// barriers) is 1.45x slower, so the staging pays.  The barriers and the
// staging latency are not what holds it at ~15% of the f32 bound (the
// slope of the chunks-per-tile sweep); the loads per FMA and the
// division are.  On real lists a second cost comes on top: tiles list
// 2 to 48 chunks, and the heaviest tiles set the kernel's time.
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
#include <stddef.h>
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

// Loads a section entry: from shared memory, or (kGlobal) from the table
// in device memory through the read-only cache.
template <bool kGlobal>
__device__ __forceinline__ float load_entry(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// One edge side of triangle j: the dot of its six section rows (`stride`
// floats apart) with the ray's d and (o-c) x d, summed from row 5 down.
template <bool kGlobal = false>
__device__ __forceinline__ float side(const float* s, int stride, int j,
                                      const float r[6]) {
  float v = r[5] * load_entry<kGlobal>(s + 5 * stride + j);
  for (int k = 4; k >= 0; --k)
    v = fmaf(r[k], load_entry<kGlobal>(s + k * stride + j), v);
  return v;
}

// The loop kernel is one body instantiated per mode.  kFull is production
// K2; the others are ablations of its own code, timed by
// tools/ablate_k2.py, each writing an output that depends on all the work
// it does (so nvcc keeps that work) and that a plain version reproduces
// (ops/dense_intersect.py::loop_hits_ablate_plain):
//   kEmpty     reads each list entry and joins both barriers: t = tmax,
//              prim = chunks walked.
//   kStage     + stages the chunk's 22 rows: t = f32 sum, in list order,
//              of the staged word (kRows * lane) mod (kRows * chunk) of
//              each chunk, prim = chunks walked.
//   kSections  + s1, s2, s0 and num of every triangle: t = the least
//              num + nd over the lane's tests, prim = chunks walked.
//   kDirect    the full test with every section entry read from device
//              memory (through L1/L2) in place of shared memory: no
//              staging, no barriers; (t, prim) as kFull, bit for bit.
//   kDump      kFull on one tile over a given chunk list (picks, repeats
//              allowed), every lane testing every triangle (done lanes
//              too: they accept nothing, as their best is <= 0), writing
//              each test's intermediates and each pick's running best to
//              g_dump.  A debug kernel, launched alone: it bounds nothing.
// Differences between modes split K2's time per listed chunk into
// machinery, staging, sections and the epilogue (PERF.md).
enum LoopMode : int { kEmpty = 0, kStage = 1, kSections = 2, kDirect = 3,
                      kFull = 4, kDump = 5 };

// Where kDump writes (ops/dense_intersect.py::tile_dump's contract): per
// (pick k, triangle j, lane) the sections s1, s2, s0, num (sec
// [n,4,chunk,tile]), t = num / nd (t [n,chunk,tile]) and whether the test
// took the hit (acc [n,chunk,tile]); per (pick, lane) the running (t,
// prim) after the pick (best_t, best_prim [n,tile]; the last row is the
// kernel's own output).  n is the number of picks.  Set by
// pbrt_dense_tile_dump before each launch.
struct DumpOut {
  float* sec;
  float* t;
  uint8_t* acc;
  float* best_t;
  int* best_prim;
  int n;
};
__device__ DumpOut g_dump;

// Index of test (k, j) of this lane in g_dump's [n,rows,tile] outputs.
__device__ __forceinline__ size_t dump_at(int k, int j, int rows) {
  return (static_cast<size_t>(k) * rows + j) * blockDim.x + threadIdx.x;
}

template <int kMode>
__global__ void dense_loop_kernel(const float* __restrict__ r16,
                                  const float* __restrict__ tmax,
                                  const float* __restrict__ W,
                                  const int* __restrict__ chunk_list,
                                  const int* __restrict__ n_active,
                                  int n_chunks, int chunk,
                                  float* __restrict__ t_out,
                                  int* __restrict__ prim_out) {
  constexpr bool kTests = kMode >= kSections;
  constexpr bool kHits = kMode >= kDirect;      // full test, (t, prim) out
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
  // ablation output: kStage's sum, kSections' least num + nd (from +inf)
  float acc = kMode == kSections ? __int_as_float(0x7f800000) : 0.f;
  int walked = 0;
  const int word = (kRows * threadIdx.x) % (kRows * chunk);

  const int na = n_active[blockIdx.x];
  const int* list = chunk_list + static_cast<size_t>(blockIdx.x) * n_chunks;
  for (int k = 0; k < na; ++k) {
    const int c = list[k];
    const float* wc = W + static_cast<size_t>(c) * 16 * 4 * chunk;
    if constexpr (!kHits) walked += c >= 0;
    if constexpr (kMode != kDirect) {
      __syncthreads();   // every thread is done with the previous chunk
      if constexpr (kMode != kEmpty) {
        for (int idx = threadIdx.x; idx < kRows * chunk; idx += blockDim.x) {
          const int row = idx / chunk;
          const int j = idx - row * chunk;
          sec[idx] = wc[staged_offset(row, chunk) + j];
        }
      }
      __syncthreads();
    }
    if constexpr (kMode == kStage) acc += sec[word];
    if constexpr (kTests) {
      if constexpr (kMode != kDump) {
        if (done) continue;
      }
      // staged: rows chunk apart, num's constant row 3 rows on; direct:
      // the table's own rows, 4*chunk apart, the constant row 9 rows on
      const int stride = kMode == kDirect ? 4 * chunk : chunk;
      const float* s1p = kMode == kDirect ? wc : sec;
      const float* s2p = kMode == kDirect ? wc + chunk : sec + 6 * chunk;
      const float* s0p = kMode == kDirect ? wc + 3 * chunk : sec + 12 * chunk;
      const float* np = kMode == kDirect ? wc + 6 * stride + 2 * chunk
                                         : sec + 18 * chunk;
      const int ncst = (kMode == kDirect ? 9 : 3) * stride;
      constexpr bool kG = kMode == kDirect;
      const int base = c * chunk;
      for (int j = 0; j < chunk; ++j) {
        const float s1 = side<kG>(s1p, stride, j, dm);
        const float s2 = side<kG>(s2p, stride, j, dm);
        const float s0 = side<kG>(s0p, stride, j, dm);
        const float num =
            fmaf(o0, load_entry<kG>(np + j),
                 fmaf(o1, load_entry<kG>(np + stride + j),
                      fmaf(o2, load_entry<kG>(np + 2 * stride + j),
                           load_entry<kG>(np + ncst + j))));
        const float nd = (s0 + s1) + s2;
        if constexpr (kMode == kSections) {
          acc = fminf(acc, num + nd);
        } else {
          const float t = num / nd;
          const int i0 = __float_as_int(s0);
          const int inside = (i0 ^ __float_as_int(s1)) |
                             (i0 ^ __float_as_int(s2));
          const int p = base + j;
          if constexpr (kMode == kDump) {
            g_dump.sec[dump_at(4 * k, j, chunk)] = s1;
            g_dump.sec[dump_at(4 * k + 1, j, chunk)] = s2;
            g_dump.sec[dump_at(4 * k + 2, j, chunk)] = s0;
            g_dump.sec[dump_at(4 * k + 3, j, chunk)] = num;
            g_dump.t[dump_at(k, j, chunk)] = t;
            g_dump.acc[dump_at(k, j, chunk)] = 0;
          }
          if (inside >= 0 && t > 1e-4f &&
              (t < t_best || (t == t_best && p < prim))) {
            t_best = t;
            prim = p;
            if constexpr (kMode == kDump) g_dump.acc[dump_at(k, j, chunk)] = 1;
            if (anyhit) {
              t_best = -1.f;
              done = true;
              if constexpr (kMode != kDump) break;
            }
          }
        }
      }
    }
    if constexpr (kMode == kDump) {
      if (k + 1 < na) {   // the last pick's best is the output below
        g_dump.best_t[dump_at(k, 0, 1)] = t_best;
        g_dump.best_prim[dump_at(k, 0, 1)] = prim;
      }
    }
  }
  if constexpr (kHits) {
    t_out[ray] = t_best;
    prim_out[ray] = prim;
  } else {
    t_out[ray] = kMode == kEmpty ? t_best : acc;
    prim_out[ray] = walked;
  }
}

template <int kMode>
int launch_loop(const float* r16, const float* tmax, const float* W,
                const int* chunk_list, const int* n_active, int n_tiles,
                int n_chunks, int chunk, int tile, float* t_out,
                int* prim_out, cudaStream_t stream) {
  const size_t smem = kMode == kDirect || kMode == kEmpty
      ? 0 : static_cast<size_t>(kRows) * chunk * sizeof(float);
  dense_loop_kernel<kMode><<<n_tiles, tile, smem, stream>>>(
      r16, tmax, W, chunk_list, n_active, n_chunks, chunk, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
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
  return launch_loop<kFull>(r16, tmax, W, chunk_list, n_active, n_tiles,
                            n_chunks, chunk, tile, t_out, prim_out, stream);
}

// K2 in ablation mode `mode` (0 empty, 1 stage, 2 sections, 3 direct; see
// LoopMode), with pbrt_dense_loop's arguments.  kFull is launched by
// pbrt_dense_loop alone.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for any other mode.
extern "C" int pbrt_dense_loop_ablate(int mode, const float* r16,
                                      const float* tmax, const float* W,
                                      const int* chunk_list,
                                      const int* n_active, int n_tiles,
                                      int n_chunks, int chunk, int tile,
                                      float* t_out, int* prim_out,
                                      cudaStream_t stream) {
  switch (mode) {
    case kEmpty:
      return launch_loop<kEmpty>(r16, tmax, W, chunk_list, n_active, n_tiles,
                                 n_chunks, chunk, tile, t_out, prim_out,
                                 stream);
    case kStage:
      return launch_loop<kStage>(r16, tmax, W, chunk_list, n_active, n_tiles,
                                 n_chunks, chunk, tile, t_out, prim_out,
                                 stream);
    case kSections:
      return launch_loop<kSections>(r16, tmax, W, chunk_list, n_active,
                                    n_tiles, n_chunks, chunk, tile, t_out,
                                    prim_out, stream);
    case kDirect:
      return launch_loop<kDirect>(r16, tmax, W, chunk_list, n_active,
                                  n_tiles, n_chunks, chunk, tile, t_out,
                                  prim_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tile dump (kDump): r16 [tile,16] and tmax [tile] of one ray tile, W
// [n_chunks,16,4*chunk], picks [n_picks] chunk ids; sec_out, t_out,
// acc_out, best_t, best_prim as DumpOut's sec, t, acc, best_t, best_prim.
// One block of `tile` threads.  Launches share g_dump, so dumps must not
// run concurrently.  Returns the first CUDA error, or cudaSuccess.
extern "C" int pbrt_dense_tile_dump(const float* r16, const float* tmax,
                                    const float* W, const int* picks,
                                    int n_picks, int chunk, int tile,
                                    float* sec_out, float* t_out,
                                    uint8_t* acc_out, float* best_t,
                                    int* best_prim, cudaStream_t stream) {
  const DumpOut out{sec_out, t_out, acc_out, best_t, best_prim, n_picks};
  cudaError_t e = cudaMemcpyToSymbolAsync(g_dump, &out, sizeof(out), 0,
                                          cudaMemcpyHostToDevice, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  char* dev = nullptr;   // g_dump on the device; its `n` is the list length
  e = cudaGetSymbolAddress(reinterpret_cast<void**>(&dev), g_dump);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t last = static_cast<size_t>(n_picks - 1) * tile;
  return launch_loop<kDump>(
      r16, tmax, W, picks,
      reinterpret_cast<const int*>(dev + offsetof(DumpOut, n)), 1, n_picks,
      chunk, tile, best_t + last, best_prim + last, stream);
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
