"""Dense chunked Plücker ray-triangle intersection (the port's counterpart
of pbrt_tpu.ops.pallas_intersect).

Triangles stay in BVH-leaf order and are cut into chunks of `chunk`
triangles, each with an AABB.  Rays are cut into tiles of TILE lanes.
Two kernels do the work, each with a plain PyTorch twin of the same
contract:

  K1 `tile_queue`  per (tile, chunk): does any live lane of the tile hit
                   the chunk's AABB, and the least entry t among them
                   (csrc/dense_queue.cu; replaces `_queue_kernel`).
  K2 `loop_hits`   per ray: closest (or first, for any-hit lanes) hit
                   over the triangles of its tile's active chunks
                   (csrc/dense_loop.cu; replaces `_kernel_loop`).

A ray's 16-vector is r = [d, (o-c)xd, o-c, 1/d, anyhit, 0, 0, 1]; a
triangle's four sections s1|s2|num|s0 dot with it.  nd = s0+s1+s2, the ray
is inside iff the three edge sides share a sign bit, and t = num/nd is
accepted when 1e-4 < t and (t, prim) is lexicographically below the
lane's best.  Any-hit lanes park at t = -1 after their first accept (in
their tile's chunk order, and in triangle order within a chunk).

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

#: kernel launches made by the wrappers (the plain versions never count)
LAUNCHES = {"dense_queue": 0, "dense_loop": 0}


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
    """K1: per-(tile, chunk) AABB cull.

    r16 [n_tiles*TILE,16] f32, tmax [n_tiles*TILE] f32 (dead lanes <= 0),
    chunk_bounds [C,8] f32.  Returns hits [n_tiles,C] bool (any live lane
    of the tile enters the chunk's box before its tmax) and near
    [n_tiles,C] f32 (least max(entry t, 0) over those lanes, else
    F32_MAX)."""
    if _on_cpu(r16, tmax, chunk_bounds):
        return tile_queue_plain(r16, tmax, chunk_bounds)
    B = r16.shape[0]
    C = chunk_bounds.shape[0]
    if B == 0 or B % TILE:
        raise ValueError(f"tile_queue: batch {B} is not a positive "
                         f"multiple of {TILE}")
    _check("r16", r16, torch.float32, (B, 16))
    _check("tmax", tmax, torch.float32, (B,))
    _check("chunk_bounds", chunk_bounds, torch.float32, (C, 8))
    n_tiles = B // TILE
    hits = torch.empty((n_tiles, C), dtype=torch.bool, device=r16.device)
    near = torch.empty((n_tiles, C), dtype=torch.float32, device=r16.device)
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_dense_queue(
        _ptr(r16), _ptr(tmax), _ptr(chunk_bounds), n_tiles, C, TILE,
        _ptr(hits), _ptr(near), _stream())
    _raise_on(err, "dense_queue")
    LAUNCHES["dense_queue"] += 1
    return hits, near


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
    """Per-tile active-chunk lists: (chunk_list [n_tiles,C] int32, front
    to back by entry t, then the inactive chunks; n_active [n_tiles]
    int32)."""
    hits, near = tile_queue(r16, tmax, chunk_bounds)
    key = torch.where(hits, near, float("inf"))
    chunk_list = torch.sort(key, dim=1, stable=True).indices
    return chunk_list.to(torch.int32), hits.sum(1, dtype=torch.int32)


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
    B = r16.shape[0]
    C, _, cw = W.shape
    chunk = cw // 4
    if B == 0 or B % TILE:
        raise ValueError(f"loop_hits: batch {B} is not a positive "
                         f"multiple of {TILE}")
    if LOOP_ROWS * chunk * 4 > 48 * 1024:
        raise ValueError(f"loop_hits: a {chunk}-triangle chunk does not fit "
                         "K2's 48 KB of shared memory (chunk <= 512)")
    n_tiles = B // TILE
    _check("r16", r16, torch.float32, (B, 16))
    _check("tmax", tmax, torch.float32, (B,))
    _check("W", W, torch.float32, (C, 16, 4 * chunk))
    _check("chunk_list", chunk_list, torch.int32, (n_tiles, C))
    _check("n_active", n_active, torch.int32, (n_tiles,))
    t = torch.empty(B, dtype=torch.float32, device=r16.device)
    prim = torch.empty(B, dtype=torch.int32, device=r16.device)
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_dense_loop(
        _ptr(r16), _ptr(tmax), _ptr(W), _ptr(chunk_list), _ptr(n_active),
        n_tiles, C, chunk, TILE, _ptr(t), _ptr(prim), _stream())
    _raise_on(err, "dense_loop")
    LAUNCHES["dense_loop"] += 1
    return t, prim


def loop_hits_plain(r16, tmax, W, chunk_list, n_active):
    """K2's plain version: per chunk, one [B,16] @ [16,4*chunk] f32 matmul,
    lanes masked by their tile's active set.

    Closest-hit lanes keep the lexicographic (t, prim) minimum, which is
    independent of the order chunks are visited.  Any-hit lanes keep the
    hit with the least (rank of its chunk in the tile's list, index in
    the chunk): the first accept the kernel meets."""
    B = r16.shape[0]
    C, _, cw = W.shape
    chunk = cw // 4
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

    num_t = terms(2)
    nd_t = torch.cat([terms(0), terms(1), terms(3)], -1)
    num, nd = num_t.sum(-1), nd_t.sum(-1)
    u = 2.0 ** -24

    def gamma(k):
        return k * u / (1 - k * u)

    # 16 products summed (the plain version's matmul) is 16 rounds deep;
    # adding the three sides takes two more
    d_num = gamma(16) * num_t.abs().sum(-1) / num.abs()
    d_nd = gamma(18) * nd_t.abs().sum(-1) / nd.abs()
    bound = torch.where(d_nd < 1, (d_num + d_nd) / (1 - d_nd) * (1 + u) + u,
                        float("inf"))
    return num / nd, bound


def dense_intersect_loop(r16, tmax, W, chunk_bounds):
    """Closest / any-hit query over the dense tables: K1, the front-to-back
    chunk sort, then K2.  r16 [B,16], tmax [B].  Returns (t [B], prim [B]
    int32), prim -1 on a miss; pads the batch to whole tiles with dead
    lanes."""
    B = r16.shape[0]
    Bp = -(-B // TILE) * TILE
    if Bp != B:
        r16 = torch.cat([r16, r16.new_zeros((Bp - B, 16))])
        tmax = torch.cat([tmax, tmax.new_full((Bp - B,), -1.0)])
    r16 = r16.contiguous()
    tmax = tmax.contiguous()
    chunk_list, n_active = tile_chunk_lists(r16, tmax, chunk_bounds)
    t, prim = loop_hits(r16, tmax, W, chunk_list, n_active)
    return t[:B], prim[:B]
