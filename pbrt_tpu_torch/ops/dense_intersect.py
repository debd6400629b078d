"""Dense chunked Plücker ray-triangle intersection (the port's counterpart
of pbrt_tpu.ops.pallas_intersect).

Triangles stay in BVH-leaf order and are cut into chunks of `chunk`
triangles, each with an AABB.  Rays are cut into tiles of TILE lanes.
Three kernels do the work, each with a plain PyTorch twin of the same
contract:

  K1 `tile_chunk_lists`  per tile: the chunks whose AABB a live lane of
                         the tile enters, front to back by their least
                         entry t, then the rest (csrc/dense_queue.cu, its
                         kList instantiation; replaces `_queue_kernel` and
                         the sort that followed it).  `tile_queue` is its
                         cull alone, the TPU kernel's contract (kCull):
                         per (tile, chunk) the hit flag and least entry t.
  K2 `loop_hits`         per ray: closest (or first, for any-hit lanes)
                         hit over the triangles of its tile's active
                         chunks (csrc/dense_loop.cu; replaces
                         `_kernel_loop` with n_coef=1).
  K2 `loop_hits_motion`  the same for scenes with moving meshes: every
                         section entry is a cubic in the ray's shutter
                         time, stored as four coefficient planes
                         (csrc/dense_loop.cu; replaces `_kernel_loop`
                         with n_coef=4).

Two more serve the timing and debug tools (pbrt_tpu_torch/tools):
`loop_hits_ablate` runs static K2 in an ablation mode (ABLATE_MODES; the
mode template of csrc/dense_loop.cu), and `tile_dump` walks one ray tile
over a list of chunks and returns every intermediate (the kDump
instantiation of the same template).

A ray's 16-vector is r = [d, (o-c)xd, o-c, 1/d, anyhit, 0, 0, 1]; a
triangle's four sections s1|s2|num|s0 dot with it.  nd = s0+s1+s2, the ray
is inside iff the three edge sides share a sign bit, and t = num/nd is
accepted when 1e-4 < t and (t, prim) is lexicographically below the
lane's best.  Any-hit lanes park at t = -1 after their first accept (in
their tile's chunk order, and in triangle order within a chunk).
`dense_intersect_loop` runs K1 (one launch) and K2; given a per-ray
`time` it takes the motion K2.  Once any mesh of a scene moves, its whole
table is the motion table, as in the JAX package; an unmoving triangle's
plane 0 is its static entry and its planes 1-3 are exact zeros, and
K2 motion runs the chunks whose triangles are all unmoving
(`chunk_static`) with the static kernel's body.

K2 cuts a tile's list into slices of LOOP_SLICE listed chunks, walked by
up to LOOP_BLOCKS blocks, and merges their lanes through a zeroed key
buffer (one fill launch, counted as `dense_loop_init`, where a tile can
take more than one block).

Each wrapper takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE = 128           # rays per tile: K1's ray tile and K2's thread block
LOOP_ROWS = 22       # section rows K2 stages per triangle (dense_loop.cu)
CHUNK = 128          # triangles per chunk for small scenes
MAX_CHUNKS = 576     # larger scenes coarsen the chunk (pallas pick_chunking)
F32_MAX = 3.4e38
N_COEF = 4           # coefficient planes of the motion table (cubic in t)
# time nodes the motion tables are fitted through (pallas_intersect.py:221)
MOTION_NODES = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
SMEM_DEFAULT = 48 * 1024     # shared memory a block gets without opting in
SMEM_MAX = 232448            # what a Hopper block can opt in to
# G: listed chunks per slice of a tile's list, the kernel's constant
# kSlice (csrc/dense_loop.cu, where its measurement stands); here it sizes
# the grid
LOOP_SLICE = 2
# K1 orders a tile's A hit chunks by counting while A <= this, by a bitonic
# sort above it: the kernel's constant kRankMax (csrc/dense_queue.cu)
QUEUE_RANK_MAX = 128
# S: the most blocks K2 launches per tile; block b walks slices b, b + S,
# ...  Uncapped, the 514-chunk cluster table launched 129 blocks per tile
# at G = 4, nearly all empty: 0.087 ms for tiles listing no chunk and
# 0.110 ms for one (tools/ablate_k2.py --sweep, g = 0 and 1); capped,
# 0.045 ms for one, against the first version's 0.083 (PERF.md).
LOOP_BLOCKS = 16

#: K2's ablation modes, in the order of the kernel's mode ids
#: (csrc/dense_loop.cu::LoopMode); "full" is production K2
ABLATE_MODES = ("empty", "stage", "sections", "direct", "full")


def ablate_kernel(mode):
    """The LAUNCHES key of an ablation mode's kernel ("full" launches
    production K2 and counts as dense_loop)."""
    return "dense_loop" if mode == "full" else f"dense_loop_ablate[{mode}]"


#: kernel launches made by the wrappers (the plain versions never count)
#: ("dense_queue": K1's lists, "dense_queue_cull": its cull alone;
#: "dense_loop_init": the fills of the loop kernels' merge keys)
LAUNCHES = {k: 0 for k in ("dense_queue", "dense_queue_cull", "dense_loop",
                           "dense_loop_motion",
                           *map(ablate_kernel, ABLATE_MODES[:-1]),
                           "dense_tile_dump", "dense_loop_init")}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host precompute (shared with pallas_intersect)
# ---------------------------------------------------------------------------

def pick_chunking(P):
    """Finest chunk size that keeps the chunk count <= MAX_CHUNKS."""
    chunk = CHUNK
    while max(P, 1) > MAX_CHUNKS * chunk:
        chunk *= 2
    return chunk


def _plucker_cols(v0, e1, e2, center):
    """The three Pluecker edge columns + the (unscaled) normal."""
    a0, b0 = v0 - center, v0 + e1 - center
    a1, b1 = b0, v0 + e2 - center
    a2, b2 = b1, a0
    n = np.cross(e1, e2)
    cols = [np.concatenate([np.cross(a, b), b - a], -1)
            for a, b in [(a0, b0), (a1, b1), (a2, b2)]]
    return cols, n


def _plucker_scale(v0, e1, e2, center):
    """Common per-tri scale: largest magnitude across the 3 edge columns
    and the normal (signs and s0+s1+s2 = nd are scale-invariant)."""
    cols, n = _plucker_cols(v0, e1, e2, center)
    mag = np.maximum.reduce([np.abs(c).max(-1) for c in cols])
    return np.maximum(mag, np.abs(n).max(-1)) + 1e-30


def _plucker_sections(v0, e1, e2, center, inv):
    """[4,16,P] section rows (s1|s2|num|s0) at the per-tri scale `inv`."""
    P = v0.shape[0]
    cols, n = _plucker_cols(v0, e1, e2, center)
    W = np.zeros((4, 16, P), np.float64)
    nn = n * inv
    for s, col in enumerate(cols[1:]):
        col = col * inv
        W[s, 0:3] = col[:, :3].T
        W[s, 3:6] = col[:, 3:].T
    # "num": r lane 15 is the constant 1, so num = n.(v0-c) - n.(o-c)
    W[2, 6:9] = -nn.T
    W[2, 15] = (nn * (v0 - center)).sum(-1)
    c0 = cols[0] * inv
    W[3, 0:3] = c0[:, :3].T
    W[3, 3:6] = c0[:, 3:].T
    return W


def build_dense_tables(v0, e1, e2, chunk=None):
    """Section table + chunk AABBs for [P,3] v0, e1, e2 in BVH-leaf order.

    Returns dict: W [C,16,4*chunk] f32 chunk-major (per chunk the four
    sections s1|s2|num|s0, each `chunk` wide), chunk_bounds [C,8]
    (lo xyz, pad, hi xyz, pad; centered coordinates), chunk, center [3]."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    P = v0.shape[0]
    if chunk is None:
        chunk = pick_chunking(P)
    Pp = max(((P + chunk - 1) // chunk) * chunk, chunk)
    C = Pp // chunk
    center = v0.mean(0) if P else np.zeros(3)
    Wsep = np.zeros((4, 16, Pp), np.float64)
    if P:
        inv = (1.0 / _plucker_scale(v0, e1, e2, center))[:, None]
        Wsep[:, :, :P] = _plucker_sections(v0, e1, e2, center, inv)
    W = np.ascontiguousarray(
        Wsep.astype(np.float32).reshape(4, 16, C, chunk)
        .transpose(2, 1, 0, 3).reshape(C, 16, 4 * chunk))
    cb = np.zeros((C, 8), np.float32)
    cb[:, 0:3] = 1e30
    cb[:, 4:7] = -1e30
    if P:
        verts = np.stack([v0 - center, v0 + e1 - center,
                          v0 + e2 - center], 1)
        for c in range(C):
            s0, s1 = c * chunk, min((c + 1) * chunk, P)
            if s0 < P:
                vv = verts[s0:s1].reshape(-1, 3)
                cb[c, 0:3] = vv.min(0) - 1e-4
                cb[c, 4:7] = vv.max(0) + 1e-4
    return dict(W=W, chunk_bounds=cb, chunk=chunk,
                center=center.astype(np.float32))


def build_dense_tables_motion(v0, e1, e2, dmotion, chunk=None):
    """Motion variant of build_dense_tables (pallas_intersect.py:225-296).

    Vertices move linearly over the shutter: v0(t) = v0 + t*d0, e1(t) =
    e1 + t*de1, e2(t) = e2 + t*de2 (dmotion [P,12] = d0|de1|de2|pad, the
    scene's tri_motion).  Every section entry is then a cubic in t: the
    table holds its four monomial coefficient planes, fitted exactly
    through four time nodes at one per-triangle scale.  An unmoving
    triangle (dmotion all zero; padding too) gets build_dense_tables'
    entry as plane 0 and exact zeros as planes 1-3, so that any Horner
    evaluation returns plane 0 (the fit's inverse Vandermonde rows do not
    sum to exactly 0, and would leave ~1e-15 there).  Returns dict: W
    [C,16,N_COEF*4*chunk] f32, chunk-major and coefficient-major inside a
    chunk (per row: plane k, then sections s1|s2|num|s0, each `chunk`
    wide); chunk_bounds [C,8] grown to hold both keyframes; chunk; center;
    chunk_static [C] bool (every triangle of the chunk unmoving).
    """
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    dm = np.asarray(dmotion, np.float64)
    P = v0.shape[0]
    if chunk is None:
        chunk = pick_chunking(P)
    Pp = max(((P + chunk - 1) // chunk) * chunk, chunk)
    C = Pp // chunk
    center = v0.mean(0) if P else np.zeros(3)
    Wk = np.zeros((N_COEF, 4, 16, Pp), np.float64)
    still = np.ones(Pp, bool)
    if P:
        still[:P] = ~dm.any(1)
        mv = ~still[:P]
        d0, de1, de2 = dm[mv, 0:3], dm[mv, 3:6], dm[mv, 6:9]
        snaps = [(v0[mv] + t * d0, e1[mv] + t * de1, e2[mv] + t * de2)
                 for t in MOTION_NODES]
        mag = np.maximum.reduce([_plucker_scale(*sn, center)
                                 for sn in snaps])
        inv = (1.0 / mag)[:, None]
        Wn = np.stack([_plucker_sections(*sn, center, inv)
                       for sn in snaps])                   # [nodes,4,16,m]
        A = np.linalg.inv(np.vander(MOTION_NODES, N_COEF, increasing=True))
        Wk[:, :, :, np.flatnonzero(mv)] = np.einsum('kn,nsrp->ksrp', A, Wn)
        st = still[:P]
        inv = (1.0 / _plucker_scale(v0[st], e1[st], e2[st], center))[:, None]
        Wk[0, :, :, np.flatnonzero(st)] = _plucker_sections(
            v0[st], e1[st], e2[st], center, inv).transpose(2, 0, 1)
    W = np.ascontiguousarray(
        Wk.astype(np.float32).reshape(N_COEF, 4, 16, C, chunk)
        .transpose(3, 2, 0, 1, 4).reshape(C, 16, N_COEF * 4 * chunk))
    cb = np.zeros((C, 8), np.float32)
    cb[:, 0:3] = 1e30
    cb[:, 4:7] = -1e30
    if P:
        pts = []
        for t in (0.0, 1.0):
            vt, e1t, e2t = v0 + t * dm[:, 0:3], e1 + t * dm[:, 3:6], \
                e2 + t * dm[:, 6:9]
            pts.append(np.stack([vt - center, vt + e1t - center,
                                 vt + e2t - center], 1))
        verts = np.concatenate(pts, 1)                     # [P,6,3]
        for c in range(C):
            s0, s1 = c * chunk, min((c + 1) * chunk, P)
            if s0 < P:
                vv = verts[s0:s1].reshape(-1, 3)
                cb[c, 0:3] = vv.min(0) - 1e-4
                cb[c, 4:7] = vv.max(0) + 1e-4
    return dict(W=W, chunk_bounds=cb, chunk=chunk,
                center=center.astype(np.float32),
                chunk_static=still.reshape(C, chunk).all(1))


def ray_vectors(o, d, center, anyhit=None):
    """r16 rows [B,16] = [d, (o-c)xd, o-c, 1/d, anyhit, 0, 0, 1]."""
    oc = o - center
    m = torch.linalg.cross(oc, d, dim=-1)
    B = o.shape[0]
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)
    flag = (torch.zeros((B, 1), dtype=o.dtype, device=o.device)
            if anyhit is None else anyhit.to(o.dtype)[:, None])
    return torch.cat([d, m, oc, inv_d, flag,
                      torch.zeros((B, 2), dtype=o.dtype, device=o.device),
                      torch.ones((B, 1), dtype=o.dtype, device=o.device)],
                     -1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _on_cpu(*xs):
    devs = {x.device.type for x in xs}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA: {devs}")


def tile_queue(r16, tmax, chunk_bounds):
    """K1's cull alone (the TPU kernel's contract; the kCull instantiation
    of csrc/dense_queue.cu): per-(tile, chunk) AABB test.

    r16 [n_tiles*TILE,16] f32, tmax [n_tiles*TILE] f32 (dead lanes <= 0),
    chunk_bounds [C,8] f32, C <= MAX_CHUNKS.  Returns hits [n_tiles,C]
    bool (any live lane of the tile enters the chunk's box before its
    tmax) and near [n_tiles,C] f32 (least max(entry t, 0) over those
    lanes, else F32_MAX)."""
    if _on_cpu(r16, tmax, chunk_bounds):
        return tile_queue_plain(r16, tmax, chunk_bounds)
    n_tiles, C = _queue_shapes("tile_queue", r16, tmax, chunk_bounds)
    hits = torch.empty((n_tiles, C), dtype=torch.bool, device=r16.device)
    near = torch.empty((n_tiles, C), dtype=torch.float32, device=r16.device)
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_dense_queue_cull(
        _ptr(r16), _ptr(tmax), _ptr(chunk_bounds), n_tiles, C, TILE,
        _ptr(hits), _ptr(near), _stream())
    _raise_on(err, "dense_queue_cull")
    LAUNCHES["dense_queue_cull"] += 1
    return hits, near


def _queue_shapes(name, r16, tmax, chunk_bounds):
    """Checks K1's inputs on the card; returns (n_tiles, C)."""
    B = r16.shape[0]
    C = chunk_bounds.shape[0]
    if B == 0 or B % TILE:
        raise ValueError(f"{name}: batch {B} is not a positive multiple of "
                         f"{TILE}")
    if not 1 <= C <= MAX_CHUNKS:
        raise ValueError(f"{name}: {C} chunks; the kernel takes 1 to "
                         f"{MAX_CHUNKS}")
    _check("r16", r16, torch.float32, (B, 16))
    _check("tmax", tmax, torch.float32, (B,))
    _check("chunk_bounds", chunk_bounds, torch.float32, (C, 8))
    if r16.data_ptr() % 16 or chunk_bounds.data_ptr() % 16:
        raise ValueError(f"{name}: r16 and chunk_bounds must be 16-byte "
                         "aligned (the kernel loads them as float4)")
    return B // TILE, C


def tile_queue_plain(r16, tmax, chunk_bounds):
    """K1's plain version: one broadcast slab test [n_tiles, C, TILE]."""
    n_tiles = r16.shape[0] // TILE
    r = r16.reshape(n_tiles, 1, TILE, 16)
    tm = tmax.reshape(n_tiles, 1, TILE)
    tnear = torch.full((n_tiles, chunk_bounds.shape[0], TILE), -F32_MAX,
                       device=r16.device)
    tfar = torch.full_like(tnear, F32_MAX)
    for ax in range(3):
        lo = chunk_bounds[:, ax][None, :, None]
        hi = chunk_bounds[:, 4 + ax][None, :, None]
        t0 = (lo - r[..., 6 + ax]) * r[..., 9 + ax]
        t1 = (hi - r[..., 6 + ax]) * r[..., 9 + ax]
        tnear = torch.maximum(tnear, torch.minimum(t0, t1))
        tfar = torch.minimum(tfar, torch.maximum(t0, t1))
    hit = ((tnear <= tfar * 1.0001 + 1e-5) & (tfar > 0) & (tnear < tm)
           & (tm > 0))
    near = torch.where(hit, torch.clamp(tnear, min=0.0), F32_MAX).amin(-1)
    return hit.any(-1), near


def tile_chunk_lists(r16, tmax, chunk_bounds):
    """K1 as the main path runs it (the kList instantiation of
    csrc/dense_queue.cu: the cull and the order in one launch):
    per-tile active-chunk lists, (chunk_list [n_tiles,C] int32: the hit
    chunks front to back by near, ties by chunk id, then the missed
    chunks in id order; n_active [n_tiles] int32: the hit chunks).
    Arguments as tile_queue's."""
    if _on_cpu(r16, tmax, chunk_bounds):
        return tile_chunk_lists_plain(r16, tmax, chunk_bounds)
    n_tiles, C = _queue_shapes("tile_chunk_lists", r16, tmax, chunk_bounds)
    chunk_list = torch.empty((n_tiles, C), dtype=torch.int32,
                             device=r16.device)
    n_active = torch.empty(n_tiles, dtype=torch.int32, device=r16.device)
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_dense_queue(
        _ptr(r16), _ptr(tmax), _ptr(chunk_bounds), n_tiles, C, TILE,
        _ptr(chunk_list), _ptr(n_active), _stream())
    _raise_on(err, "dense_queue")
    LAUNCHES["dense_queue"] += 1
    return chunk_list, n_active


def tile_chunk_lists_plain(r16, tmax, chunk_bounds):
    """tile_chunk_lists' plain version: tile_queue_plain, then
    chunk_lists_from_cull."""
    return chunk_lists_from_cull(*tile_queue_plain(r16, tmax, chunk_bounds))


def chunk_lists_from_cull(hits, near):
    """tile_chunk_lists' outputs from the cull's hits and near [n_tiles,C]:
    a stable sort of each tile's keys (near where hit, else +inf), and the
    hit counts.  A near of -0.0 (tile_queue_plain's clamp keeps it) is
    keyed as +0.0, so that it ties with +0.0 and the chunk id decides,
    whatever the sort does with signed zeros."""
    key = torch.where(hits, near + 0.0, float("inf"))
    chunk_list = torch.sort(key, dim=1, stable=True).indices
    return chunk_list.to(torch.int32), hits.sum(1, dtype=torch.int32)


def _smem_bytes(chunk, n_coef):
    """Shared memory one K2 staging buffer takes: LOOP_ROWS rows of every
    plane."""
    return LOOP_ROWS * n_coef * chunk * 4


def loop_blocks(n_chunks):
    """Blocks K2 launches per ray tile: one per slice of LOOP_SLICE listed
    chunks that a list of n_chunks can hold, at most LOOP_BLOCKS."""
    return min(-(-n_chunks // LOOP_SLICE), LOOP_BLOCKS)


def loop_hits(r16, tmax, W, chunk_list, n_active):
    """K2: closest hit (any hit for lanes flagged in r16 lane 12) over the
    triangles of each tile's first n_active listed chunks.

    r16 [B,16] f32 (B = n_tiles*TILE), tmax [B] f32 initial t_best (dead
    lanes <= 0), W [C,16,4*chunk] f32, chunk_list [n_tiles,C] int32,
    n_active [n_tiles] int32.  Returns (t [B] f32, prim [B] int32):
    prim -1 and t = tmax where no triangle is accepted; t = -1 on
    any-hit lanes that hit."""
    if _on_cpu(r16, tmax, W, chunk_list, n_active):
        return loop_hits_plain(r16, tmax, W, chunk_list, n_active)
    return _launch_loop("dense_loop", r16, tmax, None, W, chunk_list,
                        n_active)


def loop_hits_motion(r16, tmax, time, W, chunk_list, n_active,
                     chunk_static):
    """K2 for moving meshes: loop_hits with every section entry evaluated
    at the lane's shutter time.

    time [B] f32 in [0,1]; W [C,16,N_COEF*4*chunk] f32 (the coefficient
    planes of build_dense_tables_motion); chunk_static [C] bool or uint8,
    true for the chunks whose triangles are all unmoving (the table's
    `chunk_static`): the kernel runs those with the static body, which
    gives what Horner gives on their exact-zero planes.  The rest as
    loop_hits."""
    if _on_cpu(r16, tmax, time, W, chunk_list, n_active):
        return loop_hits_motion_plain(r16, tmax, time, W, chunk_list,
                                      n_active)
    return _launch_loop("dense_loop_motion", r16, tmax, time, W, chunk_list,
                        n_active, chunk_static=chunk_static)


def loop_hits_ablate(mode, r16, tmax, W, chunk_list, n_active):
    """Static K2 in an ablation mode, for tools/ablate_k2.py: the same
    arguments as loop_hits, the outputs of loop_hits_ablate_plain.  "full"
    is loop_hits itself."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}: {ABLATE_MODES}")
    if mode == "full":
        return loop_hits(r16, tmax, W, chunk_list, n_active)
    if _on_cpu(r16, tmax, W, chunk_list, n_active):
        return loop_hits_ablate_plain(mode, r16, tmax, W, chunk_list,
                                      n_active)
    return _launch_loop(ablate_kernel(mode), r16, tmax, None, W, chunk_list,
                        n_active, mode=mode)


def _launch_loop(name, r16, tmax, time, W, chunk_list, n_active, mode=None,
                 chunk_static=None, blocks=None):
    """Launches a loop kernel: chunk_static is K2 motion's (required
    there); `blocks` per tile defaults to loop_blocks, and any count gives
    the same result (the tests launch one block per tile to hold the
    split to it)."""
    B = r16.shape[0]
    n_coef = 1 if time is None else N_COEF
    C, _, cw = W.shape
    chunk = cw // (4 * n_coef)
    if B == 0 or B % TILE:
        raise ValueError(f"{name}: batch {B} is not a positive multiple of "
                         f"{TILE}")
    if chunk % 4:
        raise ValueError(f"{name}: chunk {chunk} is not a multiple of 4")
    smem = _smem_bytes(chunk, n_coef)
    if smem > SMEM_MAX:
        raise ValueError(f"{name}: a {chunk}-triangle chunk needs {smem} B "
                         "of shared memory, more than a block can have")
    n_tiles = B // TILE
    _check("r16", r16, torch.float32, (B, 16))
    _check("tmax", tmax, torch.float32, (B,))
    _check("W", W, torch.float32, (C, 16, n_coef * 4 * chunk))
    _check("chunk_list", chunk_list, torch.int32, (n_tiles, C))
    _check("n_active", n_active, torch.int32, (n_tiles,))
    t = torch.empty(B, dtype=torch.float32, device=r16.device)
    prim = torch.empty(B, dtype=torch.int32, device=r16.device)
    keys = None
    blocks = loop_blocks(C) if blocks is None else blocks
    if blocks > 1:
        # per lane a merge key, per tile a count of finished blocks
        keys = torch.zeros(B + n_tiles, dtype=torch.int64, device=r16.device)
        LAUNCHES["dense_loop_init"] += 1
    kp = ctypes.c_void_p(None if keys is None else keys.data_ptr())
    from pbrt_tpu_torch.ops import cuda_kernels
    lib = cuda_kernels.library()
    if mode is not None:
        err = lib.pbrt_dense_loop_ablate(
            ABLATE_MODES.index(mode), _ptr(r16), _ptr(tmax), _ptr(W),
            _ptr(chunk_list), _ptr(n_active), n_tiles, C, chunk, TILE,
            blocks, kp, _ptr(t), _ptr(prim), _stream())
    elif time is None:
        err = lib.pbrt_dense_loop(
            _ptr(r16), _ptr(tmax), _ptr(W), _ptr(chunk_list),
            _ptr(n_active), n_tiles, C, chunk, TILE, blocks, kp, _ptr(t),
            _ptr(prim), _stream())
    else:
        _check("time", time, torch.float32, (B,))
        if getattr(chunk_static, "dtype", None) not in (torch.bool,
                                                        torch.uint8):
            raise TypeError("chunk_static: expected a bool or uint8 tensor, "
                            f"got {type(chunk_static).__name__}")
        chunk_static = chunk_static.view(torch.uint8)
        _check("chunk_static", chunk_static, torch.uint8, (C,))
        err = lib.pbrt_dense_loop_motion(
            _ptr(r16), _ptr(tmax), _ptr(time), _ptr(W), _ptr(chunk_list),
            _ptr(n_active), _ptr(chunk_static), n_tiles, C, chunk, TILE,
            blocks, kp, _ptr(t), _ptr(prim), _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return t, prim


def loop_test_counts(r16, tmax, prim, chunk_list, n_active, chunk,
                     chunk_static):
    """Ray-triangle tests K2 needs on these inputs, as (on static chunks,
    on moving chunks): every triangle of the tile's active chunks for live
    closest-hit lanes and any-hit lanes that miss; for any-hit lanes that
    hit (prim, K2's output), those up to the first accept in chunk-list
    order.  chunk_static [C] bool: true for the chunks whose triangles are
    all unmoving (all of a static table's)."""
    n_tiles, C = chunk_list.shape
    dev = r16.device
    cl = chunk_list.long()
    ranks = torch.arange(C, dtype=torch.int64, device=dev).expand(n_tiles, C)
    on = ranks < n_active[:, None]
    rank_of = torch.full((n_tiles, C), C, dtype=torch.int64, device=dev)
    rank_of.scatter_(1, cl, torch.where(on, ranks, C))
    st = chunk_static.to(device=dev, dtype=torch.bool)
    st_listed = (st[cl] & on).long()
    # static chunks among each tile's first r listed, r = 0..C
    st_before = torch.cat([torch.zeros((n_tiles, 1), dtype=torch.int64,
                                       device=dev), st_listed.cumsum(1)], 1)
    tile = torch.arange(r16.shape[0], device=dev) // TILE
    na = n_active.long()[tile]
    p = prim.long().clamp(min=0)
    rank = rank_of[tile, p // chunk].clamp(max=C - 1)
    hit_any = (r16[:, 12] > 0.5) & (prim >= 0)
    last = torch.where(hit_any, rank, na)          # whole chunks before
    n_st = st_before[tile, last]
    n_st_tests = n_st * chunk
    n_mv_tests = (last - n_st) * chunk
    j = p % chunk + 1
    hit_st = st[p // chunk]
    n_st_tests = n_st_tests + torch.where(hit_any & hit_st, j, 0)
    n_mv_tests = n_mv_tests + torch.where(hit_any & ~hit_st, j, 0)
    live = tmax > 0
    return (int(torch.where(live, n_st_tests, 0).sum()),
            int(torch.where(live, n_mv_tests, 0).sum()))


def loop_hits_plain(r16, tmax, W, chunk_list, n_active):
    """K2's plain version: per chunk, one [B,16] @ [16,4*chunk] f32 matmul,
    lanes masked by their tile's active set.

    Closest-hit lanes keep the lexicographic (t, prim) minimum, which is
    independent of the order chunks are visited.  Any-hit lanes keep the
    hit with the least (rank of its chunk in the tile's list, index in
    the chunk): the first accept the kernel meets."""
    return _loop_plain(r16, tmax, None, W, chunk_list, n_active)


def loop_hits_motion_plain(r16, tmax, time, W, chunk_list, n_active):
    """K2 motion's plain version: per chunk, one [B,16] @ [16,16*chunk]
    matmul gives the ray's dot with each coefficient plane, and a Horner
    step per plane in the lane's time gives the sections; then as
    loop_hits_plain.  (The kernel Horner-combines the table entries first
    and dots once: the same polynomial in another rounding order.)"""
    return _loop_plain(r16, tmax, time, W, chunk_list, n_active)


def _loop_plain(r16, tmax, time, W, chunk_list, n_active):
    B = r16.shape[0]
    n_coef = 1 if time is None else N_COEF
    C, _, cw = W.shape
    chunk = cw // (4 * n_coef)
    n_tiles = B // TILE
    dev = r16.device
    ranks = torch.arange(C, dtype=torch.int32, device=dev).expand(n_tiles, C)
    rank_of = torch.full((n_tiles, C), C, dtype=torch.int32, device=dev)
    rank_of.scatter_(1, chunk_list.long(), torch.where(
        ranks < n_active[:, None], ranks, C))
    lane_rank = rank_of.repeat_interleave(TILE, 0)           # [B, C]
    anyhit = r16[:, 12] > 0.5
    t_best = tmax.clone()
    prim = torch.full((B,), -1, dtype=torch.int32, device=dev)
    any_rank = torch.full((B,), C, dtype=torch.int32, device=dev)
    lane_j = torch.arange(chunk, device=dev)
    for c in range(C):
        active = lane_rank[:, c] < C
        out = r16 @ W[c]
        if time is not None:
            planes = out.reshape(B, n_coef, 4 * chunk)
            out = planes[:, n_coef - 1]
            for k in range(n_coef - 2, -1, -1):
                out = out * time[:, None] + planes[:, k]
        s1, s2 = out[:, 0:chunk], out[:, chunk:2 * chunk]
        num, s0 = out[:, 2 * chunk:3 * chunk], out[:, 3 * chunk:]
        nd = s0 + s1 + s2
        sb0 = torch.signbit(s0)
        inside = (sb0 == torch.signbit(s1)) & (sb0 == torch.signbit(s2))
        t = num / nd
        hit = inside & (t > 1e-4) & (t < tmax[:, None]) & active[:, None]
        t_hit = torch.where(hit, t, float("inf"))
        t_c, j_c = t_hit.min(1)
        j_first = torch.where(hit, lane_j, chunk).amin(1)
        hit_any = hit.any(1)
        # closest-hit lanes: chunks ascend, so a tie keeps the earlier prim
        upd = hit_any & ~anyhit & (t_c < t_best)
        t_best = torch.where(upd, t_c, t_best)
        prim = torch.where(upd, (c * chunk + j_c).to(torch.int32), prim)
        first = hit_any & anyhit & (lane_rank[:, c] < any_rank)
        any_rank = torch.where(first, lane_rank[:, c], any_rank)
        prim = torch.where(first, (c * chunk + j_first).to(torch.int32),
                           prim)
    t_best = torch.where(anyhit & (prim >= 0), -1.0, t_best)
    return t_best, prim


def _gamma(k):
    u = 2.0 ** -24
    return k * u / (1 - k * u)


def _t_and_bound(num_t, nd_t, k_num, k_nd):
    """t = num/nd from the [n, m] exact terms of num and nd, and the
    relative error bound of an f32 evaluation whose num and nd errors are
    at most gamma_k * sum|terms|; the division adds one rounding."""
    return _t_bound(num_t.sum(-1), num_t.abs().sum(-1), nd_t.sum(-1),
                    nd_t.abs().sum(-1), k_num, k_nd)


def _t_bound(num, num_abs, nd, nd_abs, k_num, k_nd):
    """_t_and_bound from the sums num, nd and the sums of their terms'
    magnitudes, num_abs and nd_abs."""
    u = 2.0 ** -24
    d_num = _gamma(k_num) * num_abs / num.abs()
    d_nd = _gamma(k_nd) * nd_abs / nd.abs()
    bound = torch.where(d_nd < 1, (d_num + d_nd) / (1 - d_nd) * (1 + u) + u,
                        float("inf"))
    return num / nd, bound


def loop_t_reference(r16, W, prim):
    """The exact t = num/nd of each ray [n,16] against its triangle `prim`
    [n] (>= 0) of the f32 table W, in f64, and the bound on the relative
    error of any f32 evaluation of it: each of num and s0+s1+s2 is a sum
    of f32 products whose error is at most gamma_k * sum|terms| (k rounds
    deep, for any summation order and with or without FMA), and the
    division adds one rounding.  K2 and its plain version must both land
    within this bound on every lane.  Returns (t [n] f64, rel_bound [n]
    f64; inf where nd's error may reach nd itself)."""
    chunk = W.shape[2] // 4
    p = prim.long()
    c, j = p // chunk, p % chunk
    r = r16.double()

    def terms(sec):                                        # [n,16] products
        return r * W[c, :, sec * chunk + j].double()

    # 16 products summed (the plain version's matmul) is 16 rounds deep;
    # adding the three sides takes two more
    return _t_and_bound(terms(2), torch.cat([terms(0), terms(1), terms(3)],
                                             -1), 16, 18)


def _loop_sides(r16, W, prim):
    """The exact sides s1, s2, s0 [n,3] of each ray [n,16] against its
    triangle prim [n] of the static table W, in f64, and gamma_16
    sum|terms| of each: how far an f32 evaluation of the side (a sum of
    16 products) may lie from it, so that within it its sign may round
    either way."""
    chunk = W.shape[2] // 4
    r = r16.double()
    p = prim.long()
    c, j = p // chunk, p % chunk
    terms = [r * W[c, :, sec * chunk + j].double() for sec in (0, 1, 3)]
    return (torch.stack([x.sum(-1) for x in terms], -1),
            _gamma(16) * torch.stack([x.abs().sum(-1) for x in terms], -1))


def loop_prim_tie(r16, W, prim_a, prim_b):
    """Whether two f32 evaluations may each rightly return their own
    triangle, prim_a or prim_b [n] (>= 0), as the closest hit of rays
    r16 [n,16] on the static table W: [n] bool.  Both triangles must be
    inside up to rounding (each side shares the sign of s0+s1+s2 or lies
    within its f32 error of 0, _loop_sides) and their exact t agree
    within the sum of their loop_t_reference bounds: a ray through an
    edge the two share, or through the point where they cross."""
    ok, ts = torch.ones(r16.shape[0], dtype=torch.bool,
                        device=r16.device), []
    for prim in (prim_a, prim_b):
        v, err = _loop_sides(r16, W, prim)
        nd = v.sum(-1, keepdim=True)
        ok &= ((torch.sign(v) == torch.sign(nd)) | (v.abs() <= err)).all(-1)
        ts.append(loop_t_reference(r16, W, prim))
    (ta, ba), (tb, bb) = ts
    return ok & ((ta - tb).abs() <= ba * ta.abs() + bb * tb.abs())


def loop_prim_skipped(r16, tmax, W, prim_a, prim_b, lanes=8):
    """Two f32 evaluations returned prim_a and prim_b [n] (>= 0) as the
    closest hit of rays r16 [n,16] with limits tmax [n] on the static
    table W, and the two are not a tie (loop_prim_tie).  The evaluation
    that returned the farther of them (by exact t) passed every triangle
    before it; this reads which, over the whole table in f64, `lanes`
    rays at a time.  The candidates are the triangles an f32 evaluation
    may accept: each side shares the sign of s0+s1+s2 or lies within its
    f32 error of 0, and t within its bound of (1e-4, tmax), as in
    loop_hit_marginal.  The skipped ones are the candidates whose exact t
    lies before the farther answer's beyond a tie with it.

    Returns (explained [n] bool, crack [n] bool).  explained: the nearer
    answer is a candidate and each skipped triangle is marginal, so that
    rounding alone may reject it; a candidate that no rounding rejects
    before the farther answer is a fault of that evaluation.  crack: two
    of the skipped triangles tie with each other, the faces on both
    sides of an edge they share: each face's sides are evaluated apart,
    so both may round outside and the ray pass between them.  A graze of
    a silhouette edge skips one face alone."""
    n = r16.shape[0]
    explained = torch.zeros(n, dtype=torch.bool, device=r16.device)
    crack = torch.zeros_like(explained)
    if n == 0:
        return explained, crack
    C, _, cw = W.shape
    chunk = cw // 4
    # [16, 4, P]: row, section (s1|s2|num|s0), triangle
    Wd = W.double().reshape(C, 16, 4, chunk).permute(1, 2, 0, 3).reshape(
        16, 4, C * chunk)
    Wa = Wd.abs()
    for lo in range(0, n, lanes):
        sl = slice(lo, min(lo + lanes, n))
        r = r16[sl].double()
        v = torch.einsum("ni,isp->nsp", r, Wd)              # [m, 4, P]
        a = torch.einsum("ni,isp->nsp", r.abs(), Wa)
        sides, err = v[:, [0, 1, 3]], _gamma(16) * a[:, [0, 1, 3]]
        nd, nd_abs = sides.sum(1), a[:, [0, 1, 3]].sum(1)
        t, b = _t_bound(v[:, 2], a[:, 2], nd, nd_abs, 16, 18)
        lim = tmax[sl].double()[:, None]
        finite = torch.isfinite(b) & torch.isfinite(t)
        inside = ((torch.sign(sides) == torch.sign(nd)[:, None])
                  | (sides.abs() <= err)).all(1)
        cand = inside & (~finite | ((t + b * t.abs() > 1e-4)
                                    & (t - b * t.abs() < lim)))
        marginal = ((sides.abs() <= err).any(1) | ~finite
                    | ((t - 1e-4).abs() <= b * t.abs())
                    | ((t - lim).abs() <= b * t.abs()))
        rows = torch.arange(t.shape[0], device=r16.device)
        pa, pb = prim_a[sl].long(), prim_b[sl].long()
        a_far = t[rows, pa] >= t[rows, pb]
        far = torch.where(a_far, pa, pb)
        near = torch.where(a_far, pb, pa)
        tf, bf = t[rows, far][:, None], b[rows, far][:, None]
        skipped = cand & finite & (t < tf) & (
            (t - tf).abs() > b * t.abs() + bf * tf.abs())
        explained[sl] = (cand[rows, near] & cand[rows, far]
                         & ~(skipped & ~marginal).any(1))
        for i in range(t.shape[0]):
            js = torch.nonzero(skipped[i])[:, 0]
            tj, bj = t[i, js], b[i, js]
            tie = ((tj[:, None] - tj[None]).abs()
                   <= bj[:, None] * tj.abs()[:, None] + bj * tj.abs())
            crack[lo + i] = bool((tie.sum() > len(js)).item())
    return explained, crack


def loop_hit_marginal(r16, tmax, W, prim):
    """Whether an f32 evaluation may either accept or reject triangle prim
    [n] (>= 0) for rays r16 [n,16] with limits tmax [n] on the static
    table W: a side within its f32 error of 0 (_loop_sides), or t within
    its loop_t_reference bound of the acceptance limits 1e-4 and tmax.
    [n] bool."""
    v, err = _loop_sides(r16, W, prim)
    t, b = loop_t_reference(r16, W, prim)

    def near(limit):
        return (t - limit).abs() <= b * t.abs()
    return (v.abs() <= err).any(-1) | near(1e-4) | near(tmax.double())


def loop_t_reference_motion(r16, time, W, prim):
    """loop_t_reference for the motion table: the exact section values are
    sum_k u^k (r . W_k) with u the lane's f32 time, so the terms are
    u^k r_i W_k,i over the four planes.  Either order of evaluation, the
    plain version's (a 16-product dot per plane, then 3 Horner steps in
    u) or the kernel's (3 Horner steps per table entry, then a 16-product
    dot), errs by at most gamma_22 * sum|terms| per section (Horner's
    gamma_6 on top of the dot's gamma_16), and nd's two additions make it
    gamma_24."""
    chunk = W.shape[2] // (4 * N_COEF)
    p = prim.long()
    c, j = p // chunk, p % chunk
    r = r16.double()
    upow = time.double()[:, None] ** torch.arange(
        N_COEF, dtype=torch.float64, device=r16.device)     # [n, N_COEF]

    def terms(sec):                              # [n, N_COEF*16] products
        return torch.cat([r * W[c, :, k * 4 * chunk + sec * chunk + j]
                          .double() * upow[:, k:k + 1]
                          for k in range(N_COEF)], -1)

    return _t_and_bound(terms(2), torch.cat([terms(0), terms(1), terms(3)],
                                             -1), 22, 24)


# ---------------------------------------------------------------------------
# K2's ablation modes and the tile dump (tools/ablate_k2.py, dump_tile.py)
# ---------------------------------------------------------------------------

def staged_offsets(chunk, device=None):
    """[LOOP_ROWS] int64 offsets of the rows K2 stages, in a chunk's block
    of W flattened to [16*4*chunk] (csrc/dense_loop.cu::staged_offset):
    s1 rows 0-5, s2 rows 0-5, s0 rows 0-5, num rows 6-8 and 15."""
    secs = [0] * 6 + [1] * 6 + [3] * 6 + [2] * 4
    rows = list(range(6)) * 3 + [6, 7, 8, 15]
    return torch.tensor([w * 4 * chunk + sec * chunk
                         for sec, w in zip(secs, rows)], device=device)


def loop_hits_ablate_plain(mode, r16, tmax, W, chunk_list, n_active):
    """The plain version of each ablation mode (csrc/dense_loop.cu::
    LoopMode), as (t [B] f32, prim [B] int32):

      empty     (tmax, n_active of the lane's tile).
      stage     (the xor of the bits of the staged word (LOOP_ROWS *
                lane) mod (LOOP_ROWS * chunk) of each listed chunk, lane =
                ray index mod TILE, as f32; n_active): equal bit for bit,
                however the kernel splits the list across blocks.
      sections  (the least num + nd over the lane's tests, +inf on dead
                lanes; n_active), one [TILE,16] @ [16,4*chunk] product per
                listed chunk and tile.  Kernel and plain round differently:
                both lie within sections_reference's bound.
      direct, full  loop_hits_plain (direct is production K2's arithmetic
                with sections read from device memory)."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}: {ABLATE_MODES}")
    if mode in ("direct", "full"):
        return loop_hits_plain(r16, tmax, W, chunk_list, n_active)
    B = r16.shape[0]
    n_tiles = B // TILE
    C, _, cw = W.shape
    chunk = cw // 4
    dev = r16.device
    walked = n_active.repeat_interleave(TILE)
    if mode == "empty":
        return tmax.clone(), walked
    n_steps = int(n_active.max()) if n_tiles else 0
    on = [(k < n_active)[:, None] for k in range(n_steps)]
    if mode == "stage":
        word = (LOOP_ROWS * torch.arange(TILE, device=dev)) % (
            LOOP_ROWS * chunk)
        off = staged_offsets(chunk, dev)[word // chunk] + word % chunk
        Wf = W.reshape(C, -1).view(torch.int32)
        acc = torch.zeros((n_tiles, TILE), dtype=torch.int32, device=dev)
        for k in range(n_steps):
            v = Wf[chunk_list[:, k].long()[:, None], off[None, :]]
            acc = torch.where(on[k], acc ^ v, acc)
        return acc.view(torch.float32).reshape(B), walked
    rt = r16.reshape(n_tiles, TILE, 16)
    live = (tmax > 0).reshape(n_tiles, TILE)
    acc = torch.full((n_tiles, TILE), float("inf"), device=dev)
    for k in range(n_steps):
        out = torch.bmm(rt, W[chunk_list[:, k].long()])
        s1, s2, num, s0 = out.split(chunk, -1)
        v = num + ((s0 + s1) + s2)
        v = torch.where(torch.isnan(v), float("inf"), v).amin(-1)
        acc = torch.where(on[k] & live, torch.fmin(acc, v), acc)
    return acc.reshape(B), walked


def sections_reference(r16, tmax, W, chunk_list, n_active):
    """What the `sections` mode computes, exactly: per lane the least
    num + nd over its tests in f64 from the f32 inputs, and the bound on
    any f32 evaluation's distance from it.  Each num + nd is a sum of 22
    f32 products; the plain version's products go through a 16-term dot
    and three additions, the kernel's through fewer, so each lies within
    gamma_19 * sum|terms| of its exact value, and the least of them within
    the largest such bound over the lane's tests.  Returns (exact [B]
    f64, +inf on dead lanes; bound [B] f64)."""
    B = r16.shape[0]
    n_tiles = B // TILE
    chunk = W.shape[2] // 4
    dev = r16.device
    rt = r16.double().reshape(n_tiles, TILE, 16)
    live = (tmax > 0).reshape(n_tiles, TILE)
    exact = torch.full((n_tiles, TILE), float("inf"), dtype=torch.float64,
                       device=dev)
    mag = torch.zeros((n_tiles, TILE), dtype=torch.float64, device=dev)
    for k in range(int(n_active.max()) if n_tiles else 0):
        on = (k < n_active)[:, None] & live
        Wk = W[chunk_list[:, k].long()].double()
        v = torch.bmm(rt, Wk).reshape(n_tiles, TILE, 4, chunk).sum(2)
        a = torch.bmm(rt.abs(), Wk.abs()).reshape(
            n_tiles, TILE, 4, chunk).sum(2)
        exact = torch.where(on, torch.minimum(exact, v.amin(-1)), exact)
        mag = torch.where(on, torch.maximum(mag, a.amax(-1)), mag)
    return exact.reshape(B), (_gamma(19) * mag).reshape(B)


def tile_dump(r16, tmax, W, picks, tile):
    """One ray tile of static K2 walked over the chunks `picks`, with
    every intermediate (csrc/dense_loop.cu, kDump: K2's own body).

    r16 [B,16], tmax [B]: the batch (the dump takes rays tile*TILE to
    (tile+1)*TILE); W [C,16,4*chunk]; picks [n] int32 chunk ids, repeats
    allowed (a tile's real list is chunk_list[tile, :n_active[tile]]).
    Returns a dict: sections [n,4,chunk,TILE] f32 (s1, s2, s0, num), t
    [n,chunk,TILE] f32 (num / nd), accepted [n,chunk,TILE] bool (the test
    took the hit), best_t [n,TILE] f32 and best_prim [n,TILE] int32 (the
    lane's running best after each pick; after the last, K2's result)."""
    rt = r16[tile * TILE:(tile + 1) * TILE]
    tt = tmax[tile * TILE:(tile + 1) * TILE]
    if _on_cpu(rt, tt, W, picks):
        return tile_dump_plain(rt, tt, W, picks)
    C, _, cw = W.shape
    chunk = cw // 4
    n = picks.shape[0]
    if rt.shape[0] != TILE or n == 0:
        raise ValueError(f"tile_dump: tile {tile} is not a whole tile of "
                         f"the batch, or no picks")
    if _smem_bytes(chunk, 1) > SMEM_MAX or chunk % 4:
        raise ValueError(f"tile_dump: the kernel does not take "
                         f"{chunk}-triangle chunks")
    _check("r16", rt, torch.float32, (TILE, 16))
    _check("tmax", tt, torch.float32, (TILE,))
    _check("W", W, torch.float32, (C, 16, 4 * chunk))
    _check("picks", picks, torch.int32, (n,))
    if int(picks.min()) < 0 or int(picks.max()) >= C:
        raise ValueError(f"tile_dump: picks must be chunk ids in [0, {C})")
    dev = rt.device
    out = dict(
        sections=torch.empty((n, 4, chunk, TILE), dtype=torch.float32,
                             device=dev),
        t=torch.empty((n, chunk, TILE), dtype=torch.float32, device=dev),
        accepted=torch.empty((n, chunk, TILE), dtype=torch.bool, device=dev),
        best_t=torch.empty((n, TILE), dtype=torch.float32, device=dev),
        best_prim=torch.empty((n, TILE), dtype=torch.int32, device=dev))
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_dense_tile_dump(
        _ptr(rt), _ptr(tt), _ptr(W), _ptr(picks), n, chunk, TILE,
        *(_ptr(out[k]) for k in ("sections", "t", "accepted", "best_t",
                                 "best_prim")), _stream())
    _raise_on(err, "dense_tile_dump")
    LAUNCHES["dense_tile_dump"] += 1
    return out


def tile_dump_plain(r16, tmax, W, picks):
    """tile_dump's plain version on one tile's r16 [TILE,16] and tmax
    [TILE]: per pick one [TILE,16] @ [16,4*chunk] product and the
    epilogue of loop_hits_plain.  A test is accepted where the kernel,
    walking the triangles in order, would take it: closest-hit lanes where
    (t, prim) is below the running best before the pick and t below every
    earlier hit of the same pick; any-hit lanes at their first hit below
    tmax, after which they accept nothing."""
    C, _, cw = W.shape
    chunk = cw // 4
    dev = r16.device
    anyhit = r16[:, 12] > 0.5
    t_best = tmax.clone()
    prim = torch.full((TILE,), -1, dtype=torch.int32, device=dev)
    done = ~(tmax > 0)
    lane_j = torch.arange(chunk, device=dev)
    inf = float("inf")
    res = {k: [] for k in ("sections", "t", "accepted", "best_t",
                           "best_prim")}
    for c in picks.tolist():
        out = r16 @ W[c]
        s1, s2, num, s0 = out.split(chunk, -1)
        nd = (s0 + s1) + s2
        t = num / nd
        sb0 = torch.signbit(s0)
        inside = (sb0 == torch.signbit(s1)) & (sb0 == torch.signbit(s2))
        p = c * chunk + lane_j
        below = (t < t_best[:, None]) | ((t == t_best[:, None])
                                          & (p < prim[:, None]))
        hit = inside & (t > 1e-4) & below & ~done[:, None]
        t_hit = torch.where(hit, t, inf)
        earlier = torch.cat([torch.full((TILE, 1), inf, device=dev),
                             torch.cummin(t_hit, 1).values[:, :-1]], 1)
        j_first = torch.where(hit, lane_j, chunk).amin(1)
        acc = torch.where(anyhit[:, None], lane_j == j_first[:, None],
                          hit & (t < earlier))
        t_c, j_c = t_hit.min(1)
        took = hit.any(1)
        j_win = torch.where(anyhit, j_first, j_c)
        t_best = torch.where(took, torch.where(anyhit, -1.0, t_c), t_best)
        prim = torch.where(took, (c * chunk + j_win).to(torch.int32), prim)
        done = done | (took & anyhit)
        res["sections"].append(torch.stack([s1.T, s2.T, s0.T, num.T]))
        res["t"].append(t.T)
        res["accepted"].append(acc.T)
        res["best_t"].append(t_best)
        res["best_prim"].append(prim)
    return {k: torch.stack(v) for k, v in res.items()}


def tile_dump_bounds(r16, W, picks):
    """Per dumped entry, how far two f32 evaluations may lie apart: each
    section [n,4,chunk,TILE] within 2 gamma_16 sum|r_i W_i| (each is a sum
    of at most 16 f32 products, within gamma_16 sum|terms| of exact), and
    t [n,chunk,TILE] within 2b / (1 - b) relative to either evaluation,
    b being loop_t_reference's relative bound of each (both lie within
    b |t| of the exact t, and each is at least (1 - b) |t|; inf where b
    reaches 1).  r16 is the tile's [TILE,16]."""
    chunk = W.shape[2] // 4
    secs, trel = [], []
    ra = r16.double().abs()
    rd = r16.double()
    for c in picks.tolist():
        a = (ra @ W[c].double().abs()).split(chunk, -1)   # s1 s2 num s0
        v = (rd @ W[c].double()).split(chunk, -1)
        secs.append(torch.stack([a[0].T, a[1].T, a[3].T, a[2].T]))
        nd, a_nd = v[0] + v[1] + v[3], a[0] + a[1] + a[3]
        d_num = _gamma(16) * a[2] / v[2].abs()
        d_nd = _gamma(18) * a_nd / nd.abs()
        u = 2.0 ** -24
        b = torch.where(d_nd < 1, (d_num + d_nd) / (1 - d_nd) * (1 + u) + u,
                        float("inf"))
        trel.append(torch.where(b < 1, 2 * b / (1 - b), float("inf")).T)
    return 2 * _gamma(16) * torch.stack(secs), torch.stack(trel)


def dense_intersect_loop(r16, tmax, W, chunk_bounds, chunk_static,
                         time=None):
    """Closest / any-hit query over the dense tables: K1 (the tiles'
    front-to-back chunk lists), then K2 (the motion K2 when a per-ray
    shutter `time` [B] in [0,1] is given; W is then the motion table).
    chunk_static [C] bool: the table's chunks of unmoving triangles (all
    of a static table's; K2 motion reads it).  r16 [B,16], tmax [B].
    Returns (t [B], prim [B] int32), prim -1 on a miss; pads the batch to
    whole tiles with dead lanes."""
    B = r16.shape[0]
    Bp = -(-B // TILE) * TILE
    if Bp != B:
        r16 = torch.cat([r16, r16.new_zeros((Bp - B, 16))])
        tmax = torch.cat([tmax, tmax.new_full((Bp - B,), -1.0)])
        if time is not None:
            time = torch.cat([time, time.new_zeros(Bp - B)])
    r16 = r16.contiguous()
    tmax = tmax.contiguous()
    chunk_list, n_active = tile_chunk_lists(r16, tmax, chunk_bounds)
    if time is None:
        t, prim = loop_hits(r16, tmax, W, chunk_list, n_active)
    else:
        t, prim = loop_hits_motion(r16, tmax, time.contiguous(), W,
                                   chunk_list, n_active, chunk_static)
    return t[:B], prim[:B]
