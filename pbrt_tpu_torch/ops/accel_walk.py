"""The BVH and kd-tree walks: the hit search of a scene over the dense cap
(the port's counterparts of pbrt_tpu.ops.intersect._intersect_bvh and
_intersect_kd, which are XLA loops there, not Pallas kernels).

pbrt_tpu walks in lockstep, one `lax.while_loop` over the whole batch
until its last lane ends, because "a per-ray stack is hostile to a vector
machine".  On the card each walk is a CUDA kernel with one thread per ray
(csrc/accel_walk.cu):

  `bvh_walk`  the octant-threaded BVH (accel/bvh.py): from node 0, the
              slab test of the node's box; a hit leaf tests its first
              `max_leaf` triangles in order (pbrt_tpu's K = scene.max_leaf:
              a larger leaf's other primitives are never tested, ROADMAP
              Queue 3 (v)) and the walk takes the octant's miss link, a hit
              interior node its hit link, a missed node its miss link,
              until the sentinel N.
  `kd_walk`   the SAH kd-tree (accel/kdtree.py) by kd-restart: the ray's
              segment against the root box, a descent toward the child
              that holds the point at t_entry (shrinking the cell's exit
              where the split plane is crossed), the leaf's duplicated
              primitive list, then t_entry moves 4 ULPs past the cell and
              the descent restarts from the root.

Each takes `time` [B] (the ray's shutter time) in a scene with moving
meshes: the tested triangle's vertices move to clamp(time, 0, 1) (`tri_
motion`).  A lane flagged in `anyhit` stops at its first accepted hit
(its prim, and whether it found one, are read; its t is that hit's).  The
quadric pre-test runs before the walk (ops/intersect.py), so t_init /
prim_init may already hold a quadric hit; an any-hit lane with one ends
after its first step.

`bvh_walk_plain` and `kd_walk_plain` are lockstep torch loops that mirror
pbrt_tpu's op for op (each step on the lanes still walking), with the
port's `ray_triangle`; with counts=True they also return what the walk
read (`WalkCounts`: per-lane node visits and triangle tests, and the
distinct node and triangle rows touched), which
kernel_workloads.walk_bound, tools/ab_walk.py and the smoke read.  The
kernels repeat the same f32 operations unfused, so (t, prim) agree bit
for bit.  The BVH's octant links are one table of (hit, miss) pairs,
`bvh_links` (scene.bvh_links), so that the kernel reads both in one load.
Each wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from pbrt_tpu_torch.accel.kdtree import KD_LEAF
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.ops import dense_intersect as dense

#: kernel launches made by the wrappers (the plain versions never count)
LAUNCHES = {k: 0 for k in ("bvh_walk", "bvh_walk_motion", "kd_walk",
                           "kd_walk_motion")}


@dataclass
class WalkCounts:
    """What a walk read (the plain versions' counts=True): per lane the
    node steps and triangle tests, and over the batch the distinct node
    rows, triangle rows and (kd) primitive-list entries touched."""
    visits: torch.Tensor           # [B] int32
    tests: torch.Tensor            # [B] int32
    nodes: int
    tris: int
    list_entries: int = 0


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def inv_direction(d):
    """pbrt_tpu's guarded reciprocal of the direction [B,3]: 1/d, and
    sign(d) * 1e20 + 1e20 where |d| <= 1e-20 (an axis-parallel ray's
    slabs depend on it)."""
    return torch.where(torch.abs(d) > 1e-20, 1.0 / d,
                       torch.sign(d) * 1e20 + 1e20)


def octant(d):
    """Direction-sign octant [B] int: bit k set where d[k] < 0."""
    return ((d[:, 0] < 0).to(torch.int64)
            | ((d[:, 1] < 0).to(torch.int64) << 1)
            | ((d[:, 2] < 0).to(torch.int64) << 2))


def _tests(o, d, pid, valid, t_best, tri_packed, u, tri_motion):
    """The leaf test of pbrt_tpu's _leaf_test: triangles pid [b,K] (valid
    [b,K]) against rays o, d [b,3] below t_best [b], moved to time u [b]
    when tri_motion is given.  Returns (update [b], t [b], prim [b]): the
    first least t among the hits, taken where it is below t_best."""
    from pbrt_tpu_torch.ops.intersect import ray_triangle
    tp = tri_packed[pid]
    v0, e1, e2 = tp[..., 0:3], tp[..., 3:6], tp[..., 6:9]
    if tri_motion is not None:
        tm = tri_motion[pid]
        uu = u[:, None, None]
        v0 = v0 + uu * tm[..., 0:3]
        e1 = e1 + uu * tm[..., 3:6]
        e2 = e2 + uu * tm[..., 6:9]
    t_tri, _, _, hit = ray_triangle(o, d, v0, e1, e2, t_best)
    hit = valid & hit
    t_masked = torch.where(hit, t_tri, dense.F32_MAX)
    k = torch.argmin(t_masked, dim=1, keepdim=True)
    t_new = torch.gather(t_masked, 1, k)[:, 0]
    upd = torch.gather(hit, 1, k)[:, 0] & (t_new < t_best)
    return upd, t_new, torch.gather(pid, 1, k)[:, 0]


def bvh_links(hit_links, miss_links):
    """The BVH's link table [8,N,2] int32 from FlatBVH's hit_links and
    miss_links [8,N]: each octant's hit and miss link of a node side by
    side, so that one 8-byte load reads both (scene.bvh_links, built with
    the scene)."""
    return torch.stack((hit_links, miss_links), -1).contiguous()


def _motion_time(time, tri_motion):
    if (time is None) != (tri_motion is None):
        raise ValueError("time and tri_motion come together")
    return None if time is None else torch.clamp(time, 0.0, 1.0)


def bvh_walk_plain(o, d, t_init, prim_init, packed, links, tri_packed,
                   max_leaf, anyhit=None, time=None, tri_motion=None,
                   counts=False):
    """The plain version of `bvh_walk` (module docstring): rays o, d [B,3]
    f32 from (t_init [B] f32, prim_init [B] i32); the BVH's packed [N,8]
    and links [8,N,2] i32 (`bvh_links`); triangle rows tri_packed [P,12].
    Returns (t [B], prim [B] i32), and with counts a WalkCounts too."""
    B, N, P = o.shape[0], packed.shape[0], tri_packed.shape[0]
    dev = o.device
    u = _motion_time(time, tri_motion)
    inv_d = inv_direction(d)
    base = octant(d) * N
    hit_f, miss_f = links[..., 0].reshape(-1), links[..., 1].reshape(-1)
    leaf_bits_all = packed[:, 6].contiguous().view(torch.int32)
    t, prim = t_init.clone(), prim_init.clone()
    visits = torch.zeros(B, dtype=torch.int32, device=dev)
    tests = torch.zeros(B, dtype=torch.int32, device=dev)
    seen_n = torch.zeros(N, dtype=torch.bool, device=dev)
    seen_t = torch.zeros(P, dtype=torch.bool, device=dev)
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    kk = torch.arange(max_leaf, device=dev)
    lanes = torch.arange(B, device=dev)
    while lanes.numel():
        n = node[lanes]
        if counts:
            seen_n[n] = True
        row = packed[n]
        tb = t[lanes]
        box = geom.bounds_ray_intersect(row[:, 0:3], row[:, 3:6], o[lanes],
                                        inv_d[lanes], tb)
        bits = leaf_bits_all[n]
        is_leaf = bits >= 0
        leaf = box & is_leaf
        if bool(leaf.any()):
            ll = lanes[leaf]
            b = bits[leaf]
            offs, cnt = (b >> 5).to(torch.int64), b & 31
            pid = torch.clamp(offs[:, None] + kk[None, :], 0, P - 1)
            valid = kk[None, :] < cnt[:, None]
            upd, t_new, p_new = _tests(
                o[ll], d[ll], pid, valid, tb[leaf], tri_packed,
                None if u is None else u[ll], tri_motion)
            if counts:
                seen_t[pid[valid]] = True
            t[ll] = torch.where(upd, t_new, t[ll])
            prim[ll] = torch.where(upd, p_new.to(torch.int32), prim[ll])
            tests[ll] += torch.clamp(cnt, max=max_leaf)
        nxt = torch.where(box & ~is_leaf, hit_f[base[lanes] + n],
                          miss_f[base[lanes] + n]).to(torch.int64)
        if anyhit is not None:
            nxt = torch.where(anyhit[lanes] & (prim[lanes] >= 0), N, nxt)
        node[lanes] = nxt
        visits[lanes] += 1
        lanes = lanes[nxt < N]
    if counts:
        return t, prim, WalkCounts(visits, tests, int(seen_n.sum()),
                                   int(seen_t.sum()))
    return t, prim


def kd_walk_plain(o, d, tmax, t_init, prim_init, kd_packed, kd_prim_idx,
                  kd_bounds, tri_packed, kd_max_leaf, anyhit=None, time=None,
                  tri_motion=None, counts=False):
    """The plain version of `kd_walk` (module docstring): rays o, d [B,3]
    of tmax [B] (a lane of tmax <= 0 does not walk) from (t_init,
    prim_init); the tree's kd_packed [Nk,4] (split, bitcast flags /
    above child or offset / count), kd_prim_idx [M] i32, kd_bounds [2,3];
    tri_packed [P,12].  Returns as bvh_walk_plain."""
    B, Nk, M = o.shape[0], kd_packed.shape[0], kd_prim_idx.shape[0]
    dev = o.device
    u = _motion_time(time, tri_motion)
    inv_d = inv_direction(d)
    ta = (kd_bounds[0][None, :] - o) * inv_d
    tb_ = (kd_bounds[1][None, :] - o) * inv_d
    t0g = torch.clamp(torch.amax(torch.minimum(ta, tb_), -1), min=0.0)
    t1g = torch.amin(torch.maximum(ta, tb_), -1)
    live = (t0g <= t1g * 1.0001 + 1e-5) & (tmax > 0)
    t, prim = t_init.clone(), prim_init.clone()
    node = torch.where(live, 0, -1).to(torch.int64)
    t_entry = torch.where(live, t0g, 0.0)
    t_cell = torch.where(live, t1g, 0.0)
    ints = kd_packed[:, 1:4].contiguous().view(torch.int32)
    visits = torch.zeros(B, dtype=torch.int32, device=dev)
    tests = torch.zeros(B, dtype=torch.int32, device=dev)
    seen_n = torch.zeros(Nk, dtype=torch.bool, device=dev)
    seen_l = torch.zeros(M, dtype=torch.bool, device=dev)
    seen_t = torch.zeros(tri_packed.shape[0], dtype=torch.bool, device=dev)
    kk = torch.arange(kd_max_leaf, device=dev)
    lanes = torch.nonzero(live)[:, 0]
    while lanes.numel():
        n = node[lanes]
        if counts:
            seen_n[n] = True
        split = kd_packed[n, 0]
        ri = ints[n]
        axis = ri[:, 0]
        is_leaf = axis == KD_LEAF
        ax = torch.clamp(axis, max=2).to(torch.int64)[:, None]
        o_ax = torch.gather(o[lanes], 1, ax)[:, 0]
        d_ax = torch.gather(d[lanes], 1, ax)[:, 0]
        inv_ax = torch.gather(inv_d[lanes], 1, ax)[:, 0]
        te, tc = t_entry[lanes], t_cell[lanes]
        # the interior descent step
        p_at = o_ax + te * d_ax
        below_first = (p_at < split) | ((p_at == split) & (d_ax <= 0))
        near = torch.where(below_first, n + 1, ri[:, 1].to(torch.int64))
        t_split = (split - o_ax) * inv_ax
        crosses = (t_split > te) & (t_split < tc)
        tc_int = torch.where(crosses, torch.minimum(tc, t_split), tc)
        # the leaf's duplicated primitive list
        if bool(is_leaf.any()):
            ll = lanes[is_leaf]
            offs, cnt = ri[is_leaf, 1], ri[is_leaf, 2]
            entry = torch.clamp(offs[:, None].to(torch.int64) + kk[None, :],
                                0, M - 1)
            pid = kd_prim_idx[entry].to(torch.int64)
            valid = kk[None, :] < cnt[:, None]
            upd, t_new, p_new = _tests(
                o[ll], d[ll], pid, valid, t[ll], tri_packed,
                None if u is None else u[ll], tri_motion)
            if counts:
                seen_l[entry[valid]] = True
                seen_t[pid[valid]] = True
            t[ll] = torch.where(upd, t_new, t[ll])
            prim[ll] = torch.where(upd, p_new.to(torch.int32), prim[ll])
            tests[ll] += torch.clamp(cnt, max=kd_max_leaf)
        # past the finished cell by 4 ULPs (an integer bit increment)
        adv = (torch.clamp(tc, min=0.0).view(torch.int32) + 4).view(
            torch.float32)
        adv = torch.where(tc <= 0.0, 1e-30, adv)
        done = adv >= torch.minimum(t[lanes], t1g[lanes])
        if anyhit is not None:
            done = done | (anyhit[lanes] & (prim[lanes] >= 0))
        nxt = torch.where(is_leaf, torch.where(done, -1, 0),
                          torch.clamp(near, max=Nk - 1))
        node[lanes] = nxt
        t_entry[lanes] = torch.where(is_leaf, adv, te)
        t_cell[lanes] = torch.where(is_leaf, t1g[lanes], tc_int)
        visits[lanes] += 1
        lanes = lanes[nxt >= 0]
    if counts:
        return t, prim, WalkCounts(visits, tests, int(seen_n.sum()),
                                   int(seen_t.sum()), int(seen_l.sum()))
    return t, prim


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _opt_ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _check_rays(o, d, t_init, prim_init, anyhit, time, tri_motion, P):
    B = o.shape[0]
    dense._check("o", o, torch.float32, (B, 3))
    dense._check("d", d, torch.float32, (B, 3))
    dense._check("t_init", t_init, torch.float32, (B,))
    dense._check("prim_init", prim_init, torch.int32, (B,))
    if anyhit is not None:
        dense._check("anyhit", anyhit, torch.bool, (B,))
    if time is not None:
        dense._check("time", time, torch.float32, (B,))
        dense._check("tri_motion", tri_motion, torch.float32, (P, 12))


def _aligned(name, x):
    """The kernels read rows of 16 bytes (float4)."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def bvh_walk(o, d, t_init, prim_init, packed, links, tri_packed, max_leaf,
             anyhit=None, time=None, tri_motion=None):
    """Closest hit (first hit for `anyhit` lanes) of each ray through the
    BVH: (t [B] f32, prim [B] i32), csrc/accel_walk.cu's bvh_walk_kernel
    (its motion instantiation given `time` and `tri_motion`).  Arguments
    as bvh_walk_plain's; every tensor contiguous, all on the CPU (the
    plain version) or all on one card."""
    _motion_time(time, tri_motion)
    if packed.shape[0] == 0:
        raise ValueError("bvh_walk: an empty BVH")
    xs = [x for x in (o, d, t_init, prim_init, packed, links, tri_packed,
                      anyhit, time, tri_motion)
          if x is not None]
    if dense._on_cpu(*xs):
        return bvh_walk_plain(o, d, t_init, prim_init, packed, links,
                              tri_packed, max_leaf, anyhit=anyhit,
                              time=time, tri_motion=tri_motion)
    B, N, P = o.shape[0], packed.shape[0], tri_packed.shape[0]
    _check_rays(o, d, t_init, prim_init, anyhit, time, tri_motion, P)
    dense._check("packed", packed, torch.float32, (N, 8))
    dense._check("links", links, torch.int32, (8, N, 2))
    dense._check("tri_packed", tri_packed, torch.float32, (P, 12))
    for name, x in (("packed", packed), ("links", links),
                    ("tri_packed", tri_packed), ("tri_motion", tri_motion)):
        if x is not None:
            _aligned(name, x)
    if not 0 < max_leaf <= 31:
        raise ValueError(f"bvh_walk: max_leaf {max_leaf} not in 1..31")
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    name = "bvh_walk" if time is None else "bvh_walk_motion"
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_bvh_walk(
        dense._ptr(o), dense._ptr(d), _opt_ptr(time), dense._ptr(t_init),
        dense._ptr(prim_init), _opt_ptr(anyhit), dense._ptr(packed),
        dense._ptr(links), dense._ptr(tri_packed), _opt_ptr(tri_motion), B,
        N, P, max_leaf, dense._ptr(t), dense._ptr(prim), dense._stream())
    dense._raise_on(err, name)
    LAUNCHES[name] += 1
    return t, prim


def kd_walk(o, d, tmax, t_init, prim_init, kd_packed, kd_prim_idx, kd_bounds,
            tri_packed, kd_max_leaf, anyhit=None, time=None, tri_motion=None):
    """Closest hit (first hit for `anyhit` lanes) of each ray through the
    kd-tree: (t [B] f32, prim [B] i32), csrc/accel_walk.cu's
    kd_walk_kernel (its motion instantiation given `time` and
    `tri_motion`).  Arguments as kd_walk_plain's; every tensor
    contiguous, all on the CPU (the plain version) or all on one card."""
    _motion_time(time, tri_motion)
    xs = [x for x in (o, d, tmax, t_init, prim_init, kd_packed, kd_prim_idx,
                      kd_bounds, tri_packed, anyhit, time, tri_motion)
          if x is not None]
    if dense._on_cpu(*xs):
        return kd_walk_plain(o, d, tmax, t_init, prim_init, kd_packed,
                             kd_prim_idx, kd_bounds, tri_packed, kd_max_leaf,
                             anyhit=anyhit, time=time, tri_motion=tri_motion)
    B, Nk, M = o.shape[0], kd_packed.shape[0], kd_prim_idx.shape[0]
    P = tri_packed.shape[0]
    _check_rays(o, d, t_init, prim_init, anyhit, time, tri_motion, P)
    dense._check("tmax", tmax, torch.float32, (B,))
    dense._check("kd_packed", kd_packed, torch.float32, (Nk, 4))
    dense._check("kd_prim_idx", kd_prim_idx, torch.int32, (M,))
    dense._check("kd_bounds", kd_bounds, torch.float32, (2, 3))
    dense._check("tri_packed", tri_packed, torch.float32, (P, 12))
    for name, x in (("kd_packed", kd_packed), ("tri_packed", tri_packed),
                    ("tri_motion", tri_motion)):
        if x is not None:
            _aligned(name, x)
    if M == 0 or kd_max_leaf <= 0:
        raise ValueError("kd_walk: an empty kd-tree")
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    name = "kd_walk" if time is None else "kd_walk_motion"
    from pbrt_tpu_torch.ops import cuda_kernels
    err = cuda_kernels.library().pbrt_kd_walk(
        dense._ptr(o), dense._ptr(d), _opt_ptr(time), dense._ptr(tmax),
        dense._ptr(t_init), dense._ptr(prim_init), _opt_ptr(anyhit),
        dense._ptr(kd_packed), dense._ptr(kd_prim_idx), dense._ptr(kd_bounds),
        dense._ptr(tri_packed), _opt_ptr(tri_motion), B, Nk, M, P,
        kd_max_leaf, dense._ptr(t), dense._ptr(prim), dense._stream())
    dense._raise_on(err, name)
    LAUNCHES[name] += 1
    return t, prim
