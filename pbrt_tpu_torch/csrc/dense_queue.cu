// K1: per-(ray tile, triangle chunk) AABB cull for the dense intersector,
// and the front-to-back chunk lists that K2 walks.
//
// Replaces pbrt_tpu/ops/pallas_intersect.py::_queue_kernel (:761), which
// _tile_chunk_lists (:812) launched once per intersect call, and the
// packed lax.sort that followed it there.
//
// One template, two instantiations (plain twins in ops/dense_intersect.py):
//   kCull  the TPU kernel's contract (tile_queue_plain): for tile b and
//          chunk c, hits[b,c] says whether any live lane of the tile
//          (tmax > 0) enters chunk c's box before its tmax, with the
//          predicate of the TPU kernel (pallas_intersect.py:801-806)
//              tnear <= tfar * 1.0001 + 1e-5 && tfar > 0 && tnear < tmax,
//          and near[b,c] is the least max(tnear, 0) over those lanes
//          (F32_MAX if none).
//   kList  the main path's (tile_chunk_lists_plain): the same cull, then
//          chunk_list[b] holds the hit chunks front to back by near, ties
//          by chunk id, then the missed chunks in id order, and
//          n_active[b] the number of hit chunks: what a stable sort of
//          where(hits, near, +inf) gives.
//
// What bounds it on the H100: it reads each live ray's 64-byte row once
// and the C chunk boxes, and does 28 f32 operations per (live ray, chunk)
// pair: at the Cornell scene's 48 chunks ~4.6 MB and ~90 MFLOP per 65,536
// rays, about 1.4 us either way; at the 514 chunks of the cluster mesh
// ~0.9 GFLOP, 14 us of operations.  The order costs compares only.
//
// Design: one block of 256 threads per 128-ray tile, with registers
// enough for the cull not to spill (kMinBlocks blocks an SM).  The block
// stages the tile's live rays, compacted, in shared memory (origin and
// tmax, inverse direction: two float4 each, from a float2 and a float4
// load of the row), and the chunk boxes.  The work is cut into units
// (chunk c, ray group g): a unit tests chunk c against every G-th live
// ray from g, with the box in registers and the rays broadcast from
// shared memory, and merges its least entry t into the chunk's slot with
// one shared atomicMin; G, a power of two, is picked per tile to balance
// the units over the threads (many groups at C = 48, few at C = 514).
// Entry t is kept as the bits of a canonical non-negative float (-0.0
// becomes +0.0, a miss is +inf), so unsigned order is float order, and
// the 64-bit key (t bits, chunk id) is unique: any sort of the keys is
// the stable one.  kList then finds the hit chunks with a ballot and a
// one-warp scan, compacts their keys in id order, and orders them by
// counting or by a bitonic sort (kRankMax); the missed chunks follow in
// id order.  Dead tiles skip the tests: no chunk is hit, and the list is
// the identity.  Products and sums use __fmul_rn/__fadd_rn so nvcc cannot
// contract them into FMAs: the predicate then rounds exactly as the
// plain version's, and hits agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr int kTile = 128;         // rays per tile (ops TILE)
constexpr int kThreads = 256;      // threads of a tile's block
constexpr int kMinBlocks = 5;      // blocks an SM must hold (registers)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 576;    // ops MAX_CHUNKS
constexpr int kMaxWords = (kMaxChunks + 31) / 32;
constexpr unsigned kInfBits = 0x7f800000u;
// a unit's fixed cost (box, atomic, index arithmetic) in ray tests, for
// the choice of G
constexpr int kUnitCost = 4;
// how kList orders a tile's A hit chunks: at most kRankMax it counts for
// each the hit keys below its own (A^2 compares, a warp per key, no
// barrier); above, it sorts the hit keys bitonically (A log^2 A, but ten
// of its 45 stages end in the block's barrier at A ~ 400).  Measured on the
// H100 (PERF.md): counting the faster at the Cornell scene's 48 chunks,
// sorting at the cluster mesh's 514
constexpr int kRankMax = 128;

enum QueueMode { kCull, kList };

struct QueueArgs {
  const float* r16;
  const float* tmax;
  const float* chunk_bounds;
  int n_chunks;
  uint8_t* hits;         // kCull
  float* near;           // kCull
  int* chunk_list;       // kList
  int* n_active;         // kList
};

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// keys kList orders: the hit chunks, at most C, padded to a power of two
// for the bitonic sort
__host__ __device__ constexpr int n_keys(int C) { return pow2_at_least(C); }

// dynamic shared memory: boxes [2C] float4, then kList's keys [n_keys]
// uint64 and list [C] int32, then the chunk slots [C] uint32
__host__ __device__ constexpr size_t smem_bytes(int mode, int C) {
  return static_cast<size_t>(C) * 32 +
         (mode == kList ? static_cast<size_t>(n_keys(C)) * 8 + C * 4 : 0) +
         static_cast<size_t>(C) * 4;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dense_queue_kernel(const QueueArgs a) {
  extern __shared__ float4 smem[];
  __shared__ float4 s_ray[2 * kTile];     // (oc, tmax), (inv, 0) per ray
  __shared__ int s_wcnt[kTile / 32];
  __shared__ unsigned s_mask[kMaxWords];  // kList: hit chunks, by word
  __shared__ int s_off[kMaxWords];        // kList: hit chunks before a word
  __shared__ int s_nact;
  const int C = a.n_chunks;
  float4* s_box = smem;                   // lo, hi per chunk
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + 2 * C);
  int* s_list = reinterpret_cast<int*>(s_key + (kMode == kList
                                                    ? n_keys(C) : 0));
  unsigned* s_near = reinterpret_cast<unsigned*>(
      kMode == kList ? s_list + C : reinterpret_cast<int*>(s_key));
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const size_t ray0 = static_cast<size_t>(blockIdx.x) * kTile;

  // --- stage: live rays compacted, boxes, empty chunk slots ---
  bool live = false;
  unsigned vote = 0;
  float tm = 0.f;
  if (t < kTile) {
    tm = a.tmax[ray0 + t];
    live = tm > 0.f;
    vote = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_wcnt[warp] = __popc(vote);
  }
  const float4* cb = reinterpret_cast<const float4*>(a.chunk_bounds);
  for (int k = t; k < 2 * C; k += kThreads) s_box[k] = cb[k];
  for (int c = t; c < C; c += kThreads) s_near[c] = kInfBits;
  __syncthreads();
  int n_live = 0, off = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    off += w < warp ? s_wcnt[w] : 0;
    n_live += s_wcnt[w];
  }
  if (live) {
    const float* r = a.r16 + (ray0 + t) * 16;
    const float2 o01 = *reinterpret_cast<const float2*>(r + 6);
    const float4 o2i = *reinterpret_cast<const float4*>(r + 8);
    const int i = off + __popc(vote & ((1u << lane) - 1u));
    s_ray[2 * i] = make_float4(o01.x, o01.y, o2i.x, tm);
    s_ray[2 * i + 1] = make_float4(o2i.y, o2i.z, o2i.w, 0.f);
  }
  __syncthreads();

  // --- cull: units (chunk, ray group) over the threads ---
  if (n_live > 0) {
    // G = 2^lg groups, the least estimated rounds x (rays + unit cost)
    int lg = 0, best_cost = 0x7fffffff;
    for (int l = 0; (1 << l) <= kTile; ++l) {
      const int rounds = (C * (1 << l) + kThreads - 1) / kThreads;
      const int cost =
          rounds * (((n_live + (1 << l) - 1) >> l) + kUnitCost);
      if (cost < best_cost) {
        best_cost = cost;
        lg = l;
      }
    }
    const int G = 1 << lg;
    for (int u = t; u < C * G; u += kThreads) {
      const int c = u % C;
      const float4 lo = s_box[2 * c], hi = s_box[2 * c + 1];
      float best = __uint_as_float(kInfBits);
      for (int i = u / C; i < n_live; i += G) {
        const float4 o = s_ray[2 * i], inv = s_ray[2 * i + 1];
        float t0 = __fmul_rn(__fsub_rn(lo.x, o.x), inv.x);
        float t1 = __fmul_rn(__fsub_rn(hi.x, o.x), inv.x);
        // the plain version starts tnear at -F32_MAX: left out, tnear
        // differs only where it is below -F32_MAX, and then the lane's
        // hit flag and max(tnear, 0) are the same
        float tnear = fminf(t0, t1);
        float tfar = fminf(kF32Max, fmaxf(t0, t1));
        t0 = __fmul_rn(__fsub_rn(lo.y, o.y), inv.y);
        t1 = __fmul_rn(__fsub_rn(hi.y, o.y), inv.y);
        tnear = fmaxf(tnear, fminf(t0, t1));
        tfar = fminf(tfar, fmaxf(t0, t1));
        t0 = __fmul_rn(__fsub_rn(lo.z, o.z), inv.z);
        t1 = __fmul_rn(__fsub_rn(hi.z, o.z), inv.z);
        tnear = fmaxf(tnear, fminf(t0, t1));
        tfar = fminf(tfar, fmaxf(t0, t1));
        if (tnear <= __fadd_rn(__fmul_rn(tfar, 1.0001f), 1e-5f) &&
            tfar > 0.f && tnear < o.w)
          best = fminf(best, tnear);
      }
      // the least max(tnear, 0) is max(least tnear, 0); + 0 turns -0.0
      // into +0.0, so that the slot's unsigned order is float order
      if (best < __uint_as_float(kInfBits))
        atomicMin(&s_near[c],
                  __float_as_uint(__fadd_rn(fmaxf(best, 0.f), 0.f)));
    }
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(blockIdx.x) * C;
  if constexpr (kMode == kCull) {
    for (int c = t; c < C; c += kThreads) {
      const unsigned v = s_near[c];
      a.hits[row + c] = v != kInfBits;
      a.near[row + c] = v != kInfBits ? __uint_as_float(v) : kF32Max;
    }
    return;
  } else {
    // --- the hit chunks: a bit per chunk, then a one-warp scan ---
    for (int base = 0; base < C; base += kThreads) {
      const int c = base + t;
      const unsigned m = __ballot_sync(0xffffffffu,
                                       c < C && s_near[c] != kInfBits);
      if (lane == 0 && c < C) s_mask[c >> 5] = m;
    }
    __syncthreads();
    const int n_words = (C + 31) >> 5;
    if (warp == 0) {
      const int cnt = lane < n_words ? __popc(s_mask[lane]) : 0;
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane < n_words) s_off[lane] = incl - cnt;
      if (lane == 31) s_nact = incl;
    }
    __syncthreads();
    const int A = s_nact;
    // hit keys compacted in id order; missed chunks straight to the list,
    // after the hits, in id order
    for (int c = t; c < C; c += kThreads) {
      const unsigned m = s_mask[c >> 5];
      const int pos =
          s_off[c >> 5] + __popc(m & ((1u << (c & 31)) - 1u));
      if (m >> (c & 31) & 1u)
        s_key[pos] = (static_cast<unsigned long long>(s_near[c]) << 32) | c;
      else
        s_list[A + c - pos] = c;
    }
    if (A <= kRankMax) {
      __syncthreads();
      // a warp per hit chunk: its rank is the count of hit keys below its
      // own (keys are unique)
      for (int h = warp; h < A; h += kWarps) {
        const unsigned long long key = s_key[h];
        unsigned below = 0;
        for (int j = lane; j < A; j += 32) below += s_key[j] < key;
        below = __reduce_add_sync(0xffffffffu, below);
        if (lane == 0) s_list[below] = static_cast<int>(key & 0xffffffffu);
      }
    } else {
      // a bitonic sort of the hit keys, padded to a power of two.  Pair q of
      // a stage of span j is (i, i + j), i = 2j (q / j) + q % j; a warp's
      // 32 pairs then lie in one block of 64 keys while j <= 32, the same
      // block at every such stage, so the block's barrier is needed only
      // next to a stage of span 64 or more: after it, and before it
      const int n = pow2_at_least(A);
      for (int k = A + t; k < n; k += kThreads) s_key[k] = ~0ull;
      __syncthreads();
      for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int q = t; q < n / 2; q += kThreads) {
            const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
            const unsigned long long x = s_key[i], y = s_key[i + j];
            if ((x > y) == ((i & k) == 0)) {
              s_key[i] = y;
              s_key[i + j] = x;
            }
          }
          // the next stage's span: j / 2, or k at the end of a merge
          if (j >= 64 || (j == 1 && k >= 64))
            __syncthreads();
          else
            __syncwarp();
        }
      }
      __syncthreads();
      for (int r = t; r < A; r += kThreads)
        s_list[r] = static_cast<int>(s_key[r] & 0xffffffffu);
    }
    __syncthreads();
    for (int c = t; c < C; c += kThreads) a.chunk_list[row + c] = s_list[c];
    if (t == 0) a.n_active[blockIdx.x] = A;
  }
}

template <int kMode>
int launch_queue(const QueueArgs& a, int n_tiles, int tile,
                 cudaStream_t stream) {
  if (tile != kTile || n_tiles < 1 || a.n_chunks < 1 ||
      a.n_chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  dense_queue_kernel<kMode><<<n_tiles, kThreads,
                              smem_bytes(kMode, a.n_chunks), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kList (the main path's K1).  r16 [n_tiles*tile,16], tmax [n_tiles*tile],
// chunk_bounds [n_chunks,8] (16-byte aligned); chunk_list [n_tiles,
// n_chunks] and n_active [n_tiles] int32.  tile must be 128 and n_chunks
// in [1, 576].  Returns cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int pbrt_dense_queue(const float* r16, const float* tmax,
                                const float* chunk_bounds, int n_tiles,
                                int n_chunks, int tile, int* chunk_list,
                                int* n_active, cudaStream_t stream) {
  return launch_queue<kList>(
      QueueArgs{r16, tmax, chunk_bounds, n_chunks, nullptr, nullptr,
                chunk_list, n_active},
      n_tiles, tile, stream);
}

// kCull (the TPU kernel's contract): as pbrt_dense_queue, with hits
// (bool) and near [n_tiles,n_chunks] as outputs.
extern "C" int pbrt_dense_queue_cull(const float* r16, const float* tmax,
                                     const float* chunk_bounds, int n_tiles,
                                     int n_chunks, int tile, uint8_t* hits,
                                     float* near, cudaStream_t stream) {
  return launch_queue<kCull>(
      QueueArgs{r16, tmax, chunk_bounds, n_chunks, hits, near, nullptr,
                nullptr},
      n_tiles, tile, stream);
}
