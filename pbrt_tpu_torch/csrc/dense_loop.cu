// K2: Plücker closest-hit / any-hit ray-triangle loop of the dense
// intersector.
//
// Replaces pbrt_tpu/ops/pallas_intersect.py::_kernel_loop (:329), which
// dense_intersect_loop (:589) launched once per intersect call, in both of
// its variants: the static one (n_coef=1) and the motion-blur one
// (n_coef=4), which takes each ray's shutter time.  Both are
// instantiations of one kernel template below, `dense_loop_kernel<kMode,
// kMotion>`: production K2 is <kFull, false>, K2 motion <kFull, true>.
//
// The static kernel's other modes (LoopMode below) replace the TPU
// rounds' ablation copies of the loop kernel: scripts/ablate_loop.py::
// make(mode).kern (:39), ablate_pick.py::make_kernel(mode).kern (:59) and
// ablate_kernel_step.py::make_kernel(mode)._kernel (:44).  Those were
// copies and drifted from the kernel they measured; these are the
// production body with parts compiled out.  One more instantiation, kDump,
// is the tile dump (`pbrt_dense_tile_dump` below), replacing the TPU
// rounds' debug kernels of the loop kernel: scripts/debug/
// dbg_dense_dump.py::kern (:49), one tile's DMA assembly and dot for
// explicit picks, and scripts/debug/dbg_dense_full.py::kernel (:45), an
// instrumented copy of _kernel_loop dumping the dot's output and the
// epilogue.  Being K2's own body, it stages, rounds and accepts as K2
// does.
//
// Contract (plain twin: ops/dense_intersect.py::loop_hits_plain): each
// ray r = [d, (o-c)xd, o-c, 1/d, anyhit, 0, 0, 1] is tested against every
// triangle of its tile's first n_active listed chunks.  With the sections
// s1, s2, s0 (edge sides) and num of a triangle, nd = s0 + s1 + s2, the
// ray is inside iff the three sides share a sign bit, and t = num / nd is
// accepted when t > 1e-4 and (t, prim) is lexicographically below the
// lane's best (initially (tmax, -1): tmax <= 0 marks a dead lane).  Any-hit
// lanes report the accept least in (rank of its chunk in the tile's list,
// index in the chunk), with t = -1.  Motion: every section entry is a
// cubic in the ray's shutter time u in [0,1]; the table W [n_chunks,16,
// 4*4*chunk] holds its four monomial coefficient planes, coefficient-
// major inside a chunk (build_dense_tables_motion).  Unmoving triangles
// have plane 0 equal to the static table's entry and exactly zero planes
// 1-3, so Horner in any u returns plane 0 exactly, and chunk_static [C]
// marks the chunks whose triangles are all unmoving.
//
// What bounded the first version on the H100 (tools/ablate_k2.py's split
// per listed (tile, chunk) step on the Cornell random rays, PERF.md):
// the section dot products 54% (each test issued 22 scalar shared-memory
// broadcast loads beside its 21 multiply-adds, and an SM issues one
// warp-wide shared load per clock against four warp-wide FFMAs), the
// epilogue 35% (the IEEE division, computed for every test), the
// synchronous staging 10%.  On real lists the heaviest tiles set the
// time: tiles list 2 to 48 chunks.  K2 motion paid 66 Horner FMAs a test
// on top, static triangles included.  The design answers each:
//
// - Four triangles per thread and step.  The staged layout [row][chunk]
//   holds neighbouring triangles' entries of a row together, so one
//   float4 broadcast load (LDS.128) feeds four tests: 5.5 loads a test in
//   place of 22.  Motion stages the planes apart ([row][plane][chunk]),
//   so a row's four planes for four triangles are four float4 loads, and
//   16-byte copies stage it.
// - The division only where it can be accepted: t > 1e-4 needs the three
//   sides and num and nd to agree in sign (the quotient's sign bit is the
//   xor of the operands'), so the IEEE num / nd runs only on lanes whose
//   triangle passes that sign test.  The division itself is unchanged, so
//   t is bit for bit the first version's.
// - A heavy tile's list is split across blocks: the list is cut into
//   slices of G listed chunks, and block (tile, b) of a tile's S blocks
//   walks slices b, b + S, b + 2S, ... in order (S = min(slices, a
//   cap), so that a large table does not launch hundreds of empty blocks
//   per tile); blocks whose first slice starts past n_active exit at
//   once.  Lanes merge by an order-independent 64-bit atomicMax of the
//   inverted key ((t bits) << 32 | prim) for closest-hit lanes (t > 0, so
//   its bits order as the float does) and (rank << 32 | prim) for any-hit
//   lanes; the last block of a tile to finish (a per-tile counter) writes
//   (t, prim).  A tile that lists at most G chunks runs one block, which
//   writes directly.  Both rules give the unsplit result exactly.  G is
//   kSlice below; S is the wrapper's (ops/dense_intersect.py::
//   loop_blocks), and any S >= 1 gives the same result.
// - Staging is asynchronous (cp.async, 16 bytes a copy) into one stage:
//   the next listed chunk's copy is issued as soon as every thread is done
//   with the current one, and the other blocks on the SM hide its
//   latency.  A second stage, testing one chunk while the next one is
//   copied, bought nothing on static K2 (0.3392 against 0.3406 ms on the
//   Cornell bounce-1 batch) and cost K2 motion 22-28% (two 45 KB stages
//   leave two blocks an SM in place of five), PERF.md.  Above 48 KB of
//   shared memory (chunks of 512 and up) the launch opts in.
// - K2 motion runs a static chunk with the static body on plane 0 alone
//   (22 rows staged, 21 FMAs a test): bit for bit what Horner gives there.
//
// Lanes that are done (any-hit after an accept, or dead) skip the tests
// but keep joining the block's barriers; production K2 leaves the list
// once every lane of the block is done.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 22;   // staged section rows per triangle
constexpr int kCoef = 4;    // coefficient planes of the motion table
constexpr size_t kSmemDefault = 48 * 1024;
// G: listed chunks per slice of a tile's list (ops/dense_intersect.py's
// LOOP_SLICE mirrors it, to size the grid).  The main path's tiles list
// 5-11 chunks on average (1-48).  `tools/ab_loop.py --slices 4 8 16` (one
// H100 80GB HBM3 at 700 W, PERF.md section 6) gave, in ms for G = 2, 4,
// 8, 16 and one block per tile: Cornell camera batch 0.120 0.150 0.151
// 0.216 0.225, bounce 1 0.349 0.370 0.400 0.505 0.855; the motion scene's
// camera batch 0.383 0.409 0.481 0.621 0.565, bounce 1 1.002 1.063 1.120
// 1.250 1.756; cornell_random 0.479 0.504 0.531 0.608 1.026; the uniform
// cluster lists (g=8) 0.264 0.271 0.305 0.305 0.270; z40 5.65 5.68 5.72
// 5.58 6.75.  G = 2 is the fastest on all but z40 (1.2% behind G = 16).
constexpr int kSlice = 2;

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

// --- asynchronous copies (Ampere/Hopper LDGSTS) ---
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies chunk block wc's staged rows into buf, 16 bytes a copy: 22
// segments of `chunk` floats (plane 0 of each row), or with `planes` 88
// (row s/4, plane s%4).  Issued by the whole block, one commit group.
__device__ __forceinline__ void stage_chunk(float* buf, const float* wc,
                                            int chunk, int ncoef,
                                            bool planes) {
  const int quarter = chunk >> 2;
  const int n = (planes ? kRows * kCoef : kRows) * quarter;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int s = idx / quarter;
    const int piece = idx - s * quarter;
    const int row = planes ? s >> 2 : s;
    const int q = planes ? s & 3 : 0;
    cp_async16(buf + s * chunk + 4 * piece,
               wc + staged_offset(row, chunk, ncoef) + q * 4 * chunk +
                   4 * piece);
  }
  cp_async_commit();
}

// Loads four neighbouring entries: from shared memory, or (kGlobal) from
// the table in device memory through the read-only cache.
template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float horner(float c0, float c1, float c2,
                                       float c3, float u) {
  return fmaf(fmaf(fmaf(c3, u, c2), u, c1), u, c0);
}

// Four neighbouring triangles' s1, s2, s0 and num.
struct Sec4 {
  float4 s1, s2, s0, num;
};

// One edge side of four triangles: the dot of six section rows (row(r0)
// to row(r0 + 5)) with the ray's d and (o-c) x d, summed from row 5 down.
template <class Row>
__device__ __forceinline__ float4 side4(const Row& row, int r0,
                                        const float dm[6]) {
  float4 e = row(r0 + 5);
  float4 v = make_float4(dm[5] * e.x, dm[5] * e.y, dm[5] * e.z,
                         dm[5] * e.w);
#pragma unroll
  for (int k = 4; k >= 0; --k) {
    e = row(r0 + k);
    v.x = fmaf(dm[k], e.x, v.x);
    v.y = fmaf(dm[k], e.y, v.y);
    v.z = fmaf(dm[k], e.z, v.z);
    v.w = fmaf(dm[k], e.w, v.w);
  }
  return v;
}

template <class Row>
__device__ __forceinline__ Sec4 sections4(const Row& row, const float dm[6],
                                          float o0, float o1, float o2) {
  Sec4 s;
  s.s1 = side4(row, 0, dm);
  s.s2 = side4(row, 6, dm);
  s.s0 = side4(row, 12, dm);
  const float4 a = row(18), b = row(19), c = row(20), d = row(21);
  s.num = make_float4(fmaf(o0, a.x, fmaf(o1, b.x, fmaf(o2, c.x, d.x))),
                      fmaf(o0, a.y, fmaf(o1, b.y, fmaf(o2, c.y, d.y))),
                      fmaf(o0, a.z, fmaf(o1, b.z, fmaf(o2, c.z, d.z))),
                      fmaf(o0, a.w, fmaf(o1, b.w, fmaf(o2, c.w, d.w))));
  return s;
}

// The loop kernel is one body instantiated per mode.  kFull is production
// K2 (and, with kMotion, K2 motion); the others are ablations of its own
// code, timed by tools/ablate_k2.py, each writing an output that depends
// on all the work it does (so nvcc keeps that work), that does not depend
// on how the list is split across blocks, and that a plain version
// reproduces (ops/dense_intersect.py::loop_hits_ablate_plain):
//   kEmpty     reads each list entry and joins both barriers: t = tmax,
//              prim = chunks walked (blocks merge by an integer add).
//   kStage     + stages the chunk's 22 rows: t = the xor of the bits of
//              the staged word (kRows * lane) mod (kRows * chunk) of each
//              chunk, as a float; prim = chunks walked.
//   kSections  + s1, s2, s0 and num of every triangle: t = the least
//              num + nd over the lane's tests (blocks merge by an
//              ordered-int max of its inverse), prim = chunks walked.
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

struct LoopArgs {
  const float* r16;            // [B,16]
  const float* tmax;           // [B]
  const float* time;           // [B] (motion)
  const float* W;              // [C,16,ncoef*4*chunk]
  const int* chunk_list;       // [n_tiles,C]
  const int* n_active;         // [n_tiles]
  const uint8_t* chunk_static; // [C] 1: every triangle unmoving (motion)
  int n_chunks, chunk;
  // [B] merge keys, then [n_tiles] finish counters, zeroed; null when
  // every tile runs one block
  unsigned long long* keys;
  float* t_out;                // [B]
  int* prim_out;               // [B]
};

// The running state of one lane.
struct Lane {
  float t_best;
  int prim;
  int rank;      // any-hit: the accepted chunk's rank in the list
  bool done;
  float acc;     // kSections: least num + nd
};

// A lane's tests against one staged (or, kDirect, resident) chunk, four
// triangles a step.  row(r, j) gives staged row r of triangles j..j+3.
template <int kMode, class RowAt>
__device__ __forceinline__ void test_chunk(const RowAt& row_at, int chunk,
                                           int base, int k, const float dm[6],
                                           float o0, float o1, float o2,
                                           bool anyhit, Lane& L) {
  for (int j = 0; j < chunk; j += 4) {
    const Sec4 S = sections4([&](int r) { return row_at(r, j); }, dm, o0,
                             o1, o2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s1 = at(S.s1, e), s2 = at(S.s2, e), s0 = at(S.s0, e);
      const float num = at(S.num, e);
      const float nd = (s0 + s1) + s2;
      if constexpr (kMode == kSections) {
        L.acc = fminf(L.acc, num + nd);
      } else {
        const int i0 = __float_as_int(s0);
        const int p = base + j + e;
        if constexpr (kMode == kDump) {
          const float t = num / nd;
          const int inside = (i0 ^ __float_as_int(s1)) |
                             (i0 ^ __float_as_int(s2));
          g_dump.sec[dump_at(4 * k, j + e, chunk)] = s1;
          g_dump.sec[dump_at(4 * k + 1, j + e, chunk)] = s2;
          g_dump.sec[dump_at(4 * k + 2, j + e, chunk)] = s0;
          g_dump.sec[dump_at(4 * k + 3, j + e, chunk)] = num;
          g_dump.t[dump_at(k, j + e, chunk)] = t;
          uint8_t took = 0;
          if (inside >= 0 && t > 1e-4f &&
              (t < L.t_best || (t == L.t_best && p < L.prim))) {
            L.t_best = t;
            L.prim = p;
            took = 1;
            if (anyhit) {
              L.t_best = -1.f;
              L.done = true;
            }
          }
          g_dump.acc[dump_at(k, j + e, chunk)] = took;
        } else {
          // t > 1e-4 needs num and nd of one sign, as the sides are
          if (((i0 ^ __float_as_int(s1)) | (i0 ^ __float_as_int(s2)) |
               (__float_as_int(num) ^ __float_as_int(nd))) >= 0) {
            const float t = num / nd;
            if (t > 1e-4f &&
                (t < L.t_best || (t == L.t_best && p < L.prim))) {
              L.t_best = t;
              L.prim = p;
              if (anyhit) {
                L.t_best = -1.f;
                L.rank = k;
                L.done = true;
                break;
              }
            }
          }
        }
      }
    }
    if constexpr (kMode >= kDirect && kMode != kDump) {
      if (L.done) break;
    }
  }
}

// Float order as unsigned order (for the kSections merge).
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

template <int kMode, bool kMotion>
__global__ void __launch_bounds__(128)
    dense_loop_kernel(const LoopArgs a) {
  constexpr bool kTests = kMode >= kSections;
  constexpr bool kHits = kMode >= kDirect;      // full test, (t, prim) out
  constexpr bool kStaged = kMode != kEmpty && kMode != kDirect;
  constexpr bool kBarriers = kMode != kDirect;
  constexpr int kNcoef = kMotion ? kCoef : 1;
  // the stage: [kRows*kNcoef][chunk] floats (motion: [row][plane][chunk])
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int na = a.n_active[tile];
  // the block's m-th listed chunk: slices blockIdx.y, + gridDim.y, ...
  const auto k_at = [&](int m) {
    return (blockIdx.y + (m / kSlice) * gridDim.y) * kSlice + m % kSlice;
  };
  if (blockIdx.y > 0 && k_at(0) >= na) return;   // nothing listed this far
  const int n_blocks = max(1, min(static_cast<int>(gridDim.y),
                                  (na + kSlice - 1) / kSlice));

  const size_t ray = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  const float4* r4 = reinterpret_cast<const float4*>(a.r16 + ray * 16);
  const float4 ra = __ldg(r4), rb = __ldg(r4 + 1), rc = __ldg(r4 + 2),
               rd = __ldg(r4 + 3);
  const float dm[6] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y};   // d, (o-c)xd
  const float o0 = rb.z, o1 = rb.w, o2 = rc.x;
  const bool anyhit = rd.x > 0.5f;
  const float u = kMotion ? a.time[ray] : 0.f;
  const float t0 = a.tmax[ray];
  // kSections' least num + nd starts at +inf
  Lane L{t0, -1, -1, !(t0 > 0.f),
         kMode == kSections ? __int_as_float(0x7f800000) : 0.f};
  unsigned xacc = 0;    // kStage
  int walked = 0;
  const int word = (kRows * threadIdx.x) % (kRows * a.chunk);

  const int* list = a.chunk_list + static_cast<size_t>(tile) * a.n_chunks;
  const size_t block_floats = static_cast<size_t>(16) * kNcoef * 4 * a.chunk;
  const auto moving = [&](int c) { return kMotion && !a.chunk_static[c]; };
  int k = k_at(0);
  int c_next = k < na ? list[k] : 0;
  bool mv_next = k < na && moving(c_next);
  if constexpr (kStaged) {
    if (k < na)
      stage_chunk(smem, a.W + c_next * block_floats, a.chunk, kNcoef,
                  mv_next);
  }
  for (int m = 0; k < na; ++m) {
    const int c = c_next;
    const bool mv = mv_next;
    const float* wc = a.W + c * block_floats;
    const int k_next = k_at(m + 1);
    const bool more = k_next < na;
    if (more) {
      c_next = list[k_next];
      mv_next = moving(c_next);
    }
    if constexpr (!kHits) walked += c >= 0;
    if constexpr (kStaged) cp_async_wait<0>();
    if constexpr (kBarriers) __syncthreads();   // the chunk is staged
    if constexpr (kMode == kStage) xacc ^= __float_as_uint(smem[word]);
    if constexpr (kTests) {
      if (kMode == kDump || !L.done) {
        const int chunk = a.chunk;
        const int base = c * chunk;
        if constexpr (kMode == kDirect) {
          test_chunk<kMode>(
              [&](int r, int j) {
                return ld4<true>(wc + staged_offset(r, chunk) + j);
              },
              chunk, base, k, dm, o0, o1, o2, anyhit, L);
        } else if (kMotion && mv) {
          test_chunk<kMode>(
              [&](int r, int j) {
                const float* p = smem + 4 * r * chunk + j;
                const float4 c0 = ld4<false>(p), c1 = ld4<false>(p + chunk),
                             c2 = ld4<false>(p + 2 * chunk),
                             c3 = ld4<false>(p + 3 * chunk);
                return make_float4(horner(c0.x, c1.x, c2.x, c3.x, u),
                                   horner(c0.y, c1.y, c2.y, c3.y, u),
                                   horner(c0.z, c1.z, c2.z, c3.z, u),
                                   horner(c0.w, c1.w, c2.w, c3.w, u));
              },
              chunk, base, k, dm, o0, o1, o2, anyhit, L);
        } else {
          test_chunk<kMode>(
              [&](int r, int j) {
                return ld4<false>(smem + r * chunk + j);
              },
              chunk, base, k, dm, o0, o1, o2, anyhit, L);
        }
      }
    }
    if constexpr (kMode == kDump) {
      if (more) {   // the last pick's best is the output below
        g_dump.best_t[dump_at(k, 0, 1)] = L.t_best;
        g_dump.best_prim[dump_at(k, 0, 1)] = L.prim;
      }
    }
    // every thread is done with this stage before it is staged again;
    // production K2 leaves once every lane is done
    if constexpr (kMode == kFull) {
      if (__syncthreads_and(L.done)) break;
    } else if constexpr (kBarriers) {
      __syncthreads();
    }
    if constexpr (kStaged) {   // every copy is waited for at the loop's top
      if (more)
        stage_chunk(smem, a.W + c_next * block_floats, a.chunk, kNcoef,
                    mv_next);
    }
    k = k_next;
  }

  if (n_blocks == 1) {    // the tile's only block: write directly
    if constexpr (kHits) {
      a.t_out[ray] = L.t_best;
      a.prim_out[ray] = L.prim;
    } else {
      a.t_out[ray] = kMode == kEmpty ? t0
                     : kMode == kStage ? __uint_as_float(xacc) : L.acc;
      a.prim_out[ray] = walked;
    }
    return;
  }
  // merge into the lane's key: [0] and [1] are its low and high words
  unsigned long long* key = a.keys + ray;
  unsigned* half = reinterpret_cast<unsigned*>(key);
  if constexpr (kHits) {
    if (L.prim >= 0) {
      const unsigned hi = anyhit ? static_cast<unsigned>(L.rank)
                                 : __float_as_uint(L.t_best);
      atomicMax(key, ~((static_cast<unsigned long long>(hi) << 32) |
                       static_cast<unsigned>(L.prim)));
    }
  } else {
    atomicAdd(&half[0], static_cast<unsigned>(walked));
    if constexpr (kMode == kStage) atomicXor(&half[1], xacc);
    if constexpr (kMode == kSections) atomicMax(&half[1], ~ordered(L.acc));
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) {
    unsigned long long* count =
        a.keys + static_cast<size_t>(gridDim.x) * blockDim.x + tile;
    last = atomicAdd(count, 1ull) == static_cast<unsigned long long>(
                                         n_blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned long long v = __ldcg(key);
  if constexpr (kHits) {
    if (v == 0) {
      a.t_out[ray] = t0;
      a.prim_out[ray] = -1;
    } else {
      const unsigned long long w = ~v;
      a.t_out[ray] = anyhit ? -1.f
                            : __uint_as_float(static_cast<unsigned>(w >> 32));
      a.prim_out[ray] = static_cast<int>(static_cast<unsigned>(w));
    }
  } else {
    const unsigned hi = static_cast<unsigned>(v >> 32);
    a.t_out[ray] = kMode == kEmpty ? t0
                   : kMode == kStage ? __uint_as_float(hi)
                                     : from_ordered(~hi);
    a.prim_out[ray] = static_cast<int>(static_cast<unsigned>(v));
  }
}

template <int kMode, bool kMotion>
int launch_loop(const LoopArgs& a, int n_tiles, int tile, int blocks,
                cudaStream_t stream) {
  constexpr bool kStaged = kMode != kEmpty && kMode != kDirect;
  if (blocks < 1 || a.chunk % 4 != 0 || (blocks > 1 && a.keys == nullptr) ||
      (kMotion && a.chunk_static == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kStaged ? static_cast<size_t>(kRows) *
                                    (kMotion ? kCoef : 1) * a.chunk *
                                    sizeof(float)
                              : 0;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_loop_kernel<kMode, kMotion>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dense_loop_kernel<kMode, kMotion>
      <<<dim3(n_tiles, blocks), tile, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

LoopArgs loop_args(const float* r16, const float* tmax, const float* time,
                   const float* W, const int* chunk_list,
                   const int* n_active, const uint8_t* chunk_static,
                   int n_chunks, int chunk, unsigned long long* keys,
                   float* t_out, int* prim_out) {
  return LoopArgs{r16, tmax, time, W, chunk_list, n_active, chunk_static,
                  n_chunks, chunk, keys, t_out, prim_out};
}

}  // namespace

// K2.  r16 [n_tiles*tile,16], tmax [n_tiles*tile], W [n_chunks,16,
// 4*chunk], chunk_list [n_tiles,n_chunks], n_active [n_tiles]; `blocks`
// blocks per tile (each walking every blocks-th slice of kSlice listed
// chunks); keys [n_tiles*tile + n_tiles] zeroed uint64 (may be null if
// blocks is 1); t_out, prim_out [n_tiles*tile].  Returns
// cudaGetLastError(), the error of raising the block's shared-memory
// limit, or cudaErrorInvalidValue.
extern "C" int pbrt_dense_loop(const float* r16, const float* tmax,
                               const float* W, const int* chunk_list,
                               const int* n_active, int n_tiles,
                               int n_chunks, int chunk, int tile,
                               int blocks, void* keys, float* t_out,
                               int* prim_out, cudaStream_t stream) {
  return launch_loop<kFull, false>(
      loop_args(r16, tmax, nullptr, W, chunk_list, n_active, nullptr,
                n_chunks, chunk, static_cast<unsigned long long*>(keys),
                t_out, prim_out),
      n_tiles, tile, blocks, stream);
}

// K2 in ablation mode `mode` (0 empty, 1 stage, 2 sections, 3 direct; see
// LoopMode), with pbrt_dense_loop's arguments.  kFull is launched by
// pbrt_dense_loop alone.  Returns as pbrt_dense_loop, or
// cudaErrorInvalidValue for any other mode.
extern "C" int pbrt_dense_loop_ablate(int mode, const float* r16,
                                      const float* tmax, const float* W,
                                      const int* chunk_list,
                                      const int* n_active, int n_tiles,
                                      int n_chunks, int chunk, int tile,
                                      int blocks, void* keys, float* t_out,
                                      int* prim_out, cudaStream_t stream) {
  const LoopArgs a = loop_args(
      r16, tmax, nullptr, W, chunk_list, n_active, nullptr, n_chunks, chunk,
      static_cast<unsigned long long*>(keys), t_out, prim_out);
  switch (mode) {
    case kEmpty:
      return launch_loop<kEmpty, false>(a, n_tiles, tile, blocks, stream);
    case kStage:
      return launch_loop<kStage, false>(a, n_tiles, tile, blocks, stream);
    case kSections:
      return launch_loop<kSections, false>(a, n_tiles, tile, blocks,
                                           stream);
    case kDirect:
      return launch_loop<kDirect, false>(a, n_tiles, tile, blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2 motion: as pbrt_dense_loop, plus time [n_tiles*tile] (each ray's
// shutter time in [0,1]) and chunk_static [n_chunks] (1 where every
// triangle of the chunk is unmoving); W is [n_chunks,16,4*4*chunk].
extern "C" int pbrt_dense_loop_motion(const float* r16, const float* tmax,
                                      const float* time, const float* W,
                                      const int* chunk_list,
                                      const int* n_active,
                                      const uint8_t* chunk_static,
                                      int n_tiles, int n_chunks, int chunk,
                                      int tile, int blocks, void* keys,
                                      float* t_out, int* prim_out,
                                      cudaStream_t stream) {
  return launch_loop<kFull, true>(
      loop_args(r16, tmax, time, W, chunk_list, n_active, chunk_static,
                n_chunks, chunk, static_cast<unsigned long long*>(keys),
                t_out, prim_out),
      n_tiles, tile, blocks, stream);
}

// The tile dump (kDump): r16 [tile,16] and tmax [tile] of one ray tile, W
// [n_chunks,16,4*chunk], picks [n_picks] chunk ids; sec_out, t_out,
// acc_out, best_t, best_prim as DumpOut's sec, t, acc, best_t, best_prim.
// One block of `tile` threads walks every pick.  Launches share g_dump,
// so dumps must not run concurrently.  Returns the first CUDA error, or
// cudaSuccess.
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
  return launch_loop<kDump, false>(
      loop_args(r16, tmax, nullptr, W, picks,
                reinterpret_cast<const int*>(dev + offsetof(DumpOut, n)),
                nullptr, n_picks, chunk, nullptr, best_t + last,
                best_prim + last),
      1, tile, 1, stream);
}
