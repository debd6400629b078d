"""Ray-scene intersection (port of pbrt_tpu.ops.intersect).

Every query runs the quadric pre-test (every sphere, cylinder, disk, cone
and paraboloid against every ray, plain torch), then one of three routes,
as pbrt_tpu's `intersect` dispatches (:450-459): a scene under the dense
cap (`use_dense`) takes a coherence sort of the rays, the dense kernels
K1 and K2 (ops/dense_intersect.py) and the inverse permutation; a larger
scene walks its kd-tree when it was built (`use_kd`, `_intersect_kd`),
else its BVH (`_intersect_bvh`), one CUDA thread per ray
(ops/accel_walk.py).  `make_hit` then re-solves the winner in f32 and
gathers the surface record.  The search runs under `torch.no_grad()`:
visibility is not differentiated (the JAX package's stop_gradient).

Motion blur: in a scene with moving meshes (`dense_motion`) each ray's
shutter time, clipped to [0,1], rides through the sort beside its origin
and direction into the motion K2 (over the cap, into the walk's motion
instantiation), and `make_hit` moves the winner's vertices to that time;
moving quadrics are intersected, and their normals taken, through the
transform interpolated at the ray's time.

Shadow rays toward a sphere light run closest-hit and drop a hit on that
light's own sphere (`nee_ignore_light`, `trace_pair(ignore_light=)`);
every other shadow lane is an any-hit lane.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.ops import accel_walk
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.scene.ir import (MAT_NONE, PRIM_CONE, PRIM_CYLINDER,
                                     PRIM_DISK, PRIM_PARABOLOID,
                                     PRIM_TRIANGLE, SceneData)
from pbrt_tpu_torch.utils.stats import span


@dataclass
class Hit:
    """SoA surface-interaction batch."""
    valid: torch.Tensor      # [B] bool
    t: torch.Tensor          # [B]
    p: torch.Tensor          # [B,3]
    ng: torch.Tensor         # [B,3] geometric normal (unit)
    ns: torch.Tensor         # [B,3] shading normal (unit)
    uv: torch.Tensor         # [B,2]
    wo: torch.Tensor         # [B,3]
    prim: torch.Tensor       # [B] prim index (BVH order)
    material: torch.Tensor   # [B] material id or -1
    light: torch.Tensor      # [B] area light id or -1
    instance: torch.Tensor   # [B] id of the hit Shape (sidecar names) or -1
    # [B] the face index within the Shape, which only ptex reads: None in
    # a scene without ptex textures (has_ptex)
    face: torch.Tensor = None
    # uv units per world unit at the hit (sqrt of uv area / world area for
    # triangles): a ray cone of world radius r covers ~r * uv_density of
    # texture space.  None when the scene has no textures.
    uv_density: torch.Tensor = None  # [B]
    # with ray differentials (make_hit(ray_diff=)): the uv derivatives
    # [dudx, dvdx, dudy, dvdy], the world-space footprint offsets and the
    # shading normal's screen derivatives (reference interaction.cpp
    # ComputeDifferentials; integrator.cpp:344-429 propagates them)
    duv: torch.Tensor = None         # [B,4]
    dpdx: torch.Tensor = None        # [B,3]
    dpdy: torch.Tensor = None        # [B,3]
    dndx: torch.Tensor = None        # [B,3]
    dndy: torch.Tensor = None        # [B,3]

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def ray_triangle(o, d, v0, e1, e2, tmax):
    """Watertight ray-triangle test (triangle.cpp:188-310); o, d [B,3]
    against triangles v0, e1, e2 [B,K,3].  Returns (t, b1, b2, hit), each
    [B,K]; b1 weighs v0 + e1 and b2 weighs v0 + e2.

    The edge functions of triangles that share an edge come from the same
    sheared vertex coordinates, so a ray through the edge cannot slip
    between them.  As in the JAX package, an edge function within a few
    ulps of its terms' magnitude counts as on the edge (zero), so that
    both neighbours hit and the closest-hit choice picks one."""
    kz = torch.argmax(torch.abs(d), dim=-1)                   # [B]
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def pick(v, k):
        return torch.gather(v, -1, k[:, None])[:, 0]

    dz = pick(d, kz)
    sx = -pick(d, kx) / dz
    sy = -pick(d, ky) / dz
    sz = 1.0 / dz

    def shear(p):
        pt = p - o[:, None, :]
        idx = torch.stack([kx, ky, kz], -1)[:, None, :].expand(
            pt.shape[0], pt.shape[1], 3)
        xx, yy, zz = torch.gather(pt, -1, idx).unbind(-1)
        return xx + sx[:, None] * zz, yy + sy[:, None] * zz, zz

    x0, y0, z0 = shear(v0)
    x1, y1, z1 = shear(v0 + e1)
    x2, y2, z2 = shear(v0 + e2)

    def edge(xa, ya, xb, yb):
        # within a few ulps of its terms' magnitude: on the edge
        e = xa * yb - ya * xb
        on = torch.abs(e) <= (torch.abs(xa * yb) + torch.abs(ya * xb)) * 4e-7
        return torch.where(on, 0.0, e)

    ed0, ed1, ed2 = edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), \
        edge(x0, y0, x1, y1)
    neg = (ed0 < 0) | (ed1 < 0) | (ed2 < 0)
    pos = (ed0 > 0) | (ed1 > 0) | (ed2 > 0)
    det = ed0 + ed1 + ed2
    ok = ~(neg & pos) & (det != 0)
    t_scaled = (ed0 * z0 + ed1 * z1 + ed2 * z2) * sz[:, None]
    # sign-consistent range test (triangle.cpp:286-293)
    tm = tmax[:, None] * det
    bad = torch.where(det < 0, (t_scaled >= 0) | (t_scaled < tm),
                      (t_scaled <= 0) | (t_scaled > tm))
    ok = ok & ~bad
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    return t_scaled * inv_det, ed1 * inv_det, ed2 * inv_det, ok


def _quadric_ts(qtype, params, oo, od, kinds):
    """Both roots of each quadric in object space (oo, od [...,3]):
    (t0, t1, ok) with t0 <= t1; a disk's one root is both (reference
    src/shapes/*.cpp's quadratic set-ups; the JAX package's coefficients,
    stable roots and guards).  qtype [...] holds PRIM_* tags, params
    [...,4] their slots; a tag other than the cylinder, disk, cone and
    paraboloid is a sphere.  kinds: the tags that may occur (the scene's
    quad_kinds), so that absent types launch nothing."""
    r, zmin, zmax = params[..., 0], params[..., 1], params[..., 2]
    ox, oy, oz = oo[..., 0], oo[..., 1], oo[..., 2]
    dx, dy, dz = od[..., 0], od[..., 1], od[..., 2]
    # the sphere
    a = dx * dx + dy * dy + dz * dz
    b = 2 * (dx * ox + dy * oy + dz * oz)
    c = ox * ox + oy * oy + oz * oz - r * r
    if PRIM_CYLINDER in kinds:
        is_cyl = qtype == PRIM_CYLINDER
        a = torch.where(is_cyl, dx * dx + dy * dy, a)
        b = torch.where(is_cyl, 2 * (dx * ox + dy * oy), b)
        c = torch.where(is_cyl, ox * ox + oy * oy - r * r, c)
    if PRIM_CONE in kinds:
        # radius r at z = 0 narrowing to its apex at z = h (zmax)
        is_cone, h = qtype == PRIM_CONE, zmax
        k = (r / torch.where(h == 0, 1.0, h)) ** 2
        a = torch.where(is_cone, dx * dx + dy * dy - k * dz * dz, a)
        b = torch.where(is_cone, 2 * (dx * ox + dy * oy - k * dz * (oz - h)),
                        b)
        c = torch.where(is_cone, ox * ox + oy * oy - k * (oz - h) ** 2, c)
    if PRIM_PARABOLOID in kinds:
        # z = zmax (x^2 + y^2) / r^2
        is_par = qtype == PRIM_PARABOLOID
        kp = zmax / torch.where(r == 0, 1.0, r * r)
        a = torch.where(is_par, kp * (dx * dx + dy * dy), a)
        b = torch.where(is_par, 2 * kp * (dx * ox + dy * oy) - dz, b)
        c = torch.where(is_par, kp * (ox * ox + oy * oy) - oz, c)
    disc = b * b - 4 * a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    safe_a = torch.where(a == 0, 1.0, a)
    safe_q = torch.where(q == 0, 1.0, q)
    ta, tb = q / safe_a, c / safe_q
    t0, t1 = torch.minimum(ta, tb), torch.maximum(ta, tb)
    ok = ok & ~(torch.abs(a) < 1e-12)
    if PRIM_DISK in kinds:
        # the plane z = height (zmin's slot), one root
        is_disk = qtype == PRIM_DISK
        t_disk = (zmin - oz) / torch.where(dz == 0, 1.0, dz)
        t0 = torch.where(is_disk, t_disk, t0)
        t1 = torch.where(is_disk, t_disk, t1)
        ok = torch.where(is_disk, dz != 0, ok)
    return t0, t1, ok


def _quadric_clip(qtype, params, oo, od, t, kinds):
    """Whether the object-space point oo + t od [...] lies inside its
    quadric's extent: z within [min(zmin, zmax), max(zmin, zmax)] (a
    disk: radius^2 only, its innerradius ignored as in the JAX package)
    and phi within phimax, each with the JAX package's 1e-5 slack
    (kinds: as _quadric_ts')."""
    ph = oo + t[..., None] * od
    zmin, zmax = params[..., 1], params[..., 2]
    z_ok = ((ph[..., 2] >= torch.minimum(zmin, zmax) - 1e-5)
            & (ph[..., 2] <= torch.maximum(zmin, zmax) + 1e-5))
    if PRIM_DISK in kinds:
        rad2 = ph[..., 0] ** 2 + ph[..., 1] ** 2
        z_ok = torch.where(qtype == PRIM_DISK, rad2 <= params[..., 0] ** 2,
                           z_ok)
    phi = torch.atan2(ph[..., 1], ph[..., 0])
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    return z_ok & (phi <= params[..., 3] + 1e-5)


def _animated_quad_w2o(scene: SceneData, time, qi=None):
    """World-to-object affines [B,Q,3,4] (or [B,3,4] for one quadric qi
    [B] per ray) interpolated at each ray's time clipped to [0,1]: the
    reference's AnimatedTransform per ray, over the default shutter."""
    u = torch.clamp(time, 0.0, 1.0)
    if qi is None:
        u = u[:, None].expand(-1, scene.quad_params.shape[0])
        at, aq, asc = (x[None] for x in (scene.quad_anim_t,
                                          scene.quad_anim_q,
                                          scene.quad_anim_s))
    else:
        at, aq, asc = (x[qi] for x in (scene.quad_anim_t, scene.quad_anim_q,
                                       scene.quad_anim_s))
    return tfm.affine_inverse(tfm.interp_matrix(at, aq, asc, u))


def all_quadrics_test(scene: SceneData, o, d, tmax, time):
    """Every quadric against every ray at its time: (t [B], prim [B], hit
    [B]).  The z / phi clip runs when the scene has a quadric other than
    a full sphere (`clip_quadrics`)."""
    if scene.has_animated_quads:
        w34 = _animated_quad_w2o(scene, time)                  # [B,Q,3,4]
        oo = torch.einsum('bqij,bj->bqi', w34[..., :3], o) + w34[..., 3]
        od = torch.einsum('bqij,bj->bqi', w34[..., :3], d)
    else:
        w2o = scene.quad_w2o
        oo = torch.einsum('qij,bj->bqi', w2o[:, :3, :3], o) \
            + w2o[None, :, :3, 3]
        od = torch.einsum('qij,bj->bqi', w2o[:, :3, :3], d)
    qtype = scene.quad_type[None, :]
    params = scene.quad_params[None, :, :]
    t0, t1, ok = _quadric_ts(qtype, params, oo, od, scene.quad_kinds)

    def clip_ok(t):
        if not scene.clip_quadrics:
            return torch.ones(t.shape, dtype=torch.bool, device=t.device)
        return _quadric_clip(qtype, params, oo, od, t, scene.quad_kinds)

    use0 = ok & (t0 > 1e-5) & (t0 < tmax[:, None]) & clip_ok(t0)
    use1 = ok & (t1 > 1e-5) & (t1 < tmax[:, None]) & clip_ok(t1) & ~use0
    hit = use0 | use1
    t_masked = torch.where(hit, torch.where(use0, t0, t1),
                           dense.F32_MAX)
    t_best, first = t_masked.min(1)
    return t_best, scene.quad_prim[first], hit.any(1)


def _coherence_key(scene: SceneData, o, d, tmax):
    """Sort key (dead | direction octant | 15-bit Morton cell of the origin
    on a 32^3 grid over the chunk boxes), as in the JAX package."""
    lo = scene.dense_cb[:, 0:3].amin(0)
    hi = scene.dense_cb[:, 4:7].amax(0)
    cell = torch.clamp(((o - scene.dense_center - lo)
                        / torch.clamp(hi - lo, min=1e-6) * 32)
                       .to(torch.int32), 0, 31)
    m = torch.zeros_like(cell[:, 0])
    for b in range(5):
        for ax in range(3):
            m = m | (((cell[:, ax] >> b) & 1) << (3 * b + ax))
    octant = ((d[:, 0] < 0).to(torch.int32)
              | ((d[:, 1] < 0).to(torch.int32) << 1)
              | ((d[:, 2] < 0).to(torch.int32) << 2))
    return torch.where(tmax > 0, (octant << 15) | m, 1 << 18)


def _coherence_order(scene: SceneData, o, d, t_init, anyhit_mask=None):
    """The dense route's coherence sort: the stable permutation by
    _coherence_key; given anyhit_mask, any-hit lanes sort behind
    closest-hit lanes and dead lanes last."""
    key = _coherence_key(scene, o, d, t_init)
    if anyhit_mask is not None:
        key = torch.where(t_init > 0,
                          key | (anyhit_mask.to(torch.int32) << 19), 1 << 20)
    return torch.sort(key, stable=True).indices


@span("intersect")
@torch.no_grad()
def intersect(scene: SceneData, ray: geom.Ray, presorted=False,
              anyhit_mask=None):
    """Closest-hit query, any-hit for lanes flagged in anyhit_mask [B].

    The route: the dense kernels when `scene.use_dense`, else the kd-tree
    when built (`use_kd`), else the BVH.  presorted skips the dense
    route's coherence sort (camera batches arrive in scanline order,
    already tile-coherent).  Returns (t, prim, found) [B]; an any-hit
    lane's t is meaningless (the dense route reports -1 where it hit a
    triangle, a walk the t of its first hit)."""
    if not scene.use_dense:
        if scene.use_kd:
            return _intersect_kd(scene, ray, anyhit_mask)
        return _intersect_bvh(scene, ray, anyhit_mask)
    o, d = ray.o, ray.d
    t_init, prim_init = _quadric_prehit(scene, ray)
    rtime = (torch.clamp(ray.time, 0.0, 1.0).to(torch.float32)
             if scene.dense_motion else None)
    if presorted:
        r16 = dense.ray_vectors(o, d, scene.dense_center, anyhit=anyhit_mask)
        t, prim = dense.dense_intersect_loop(r16, t_init, scene.dense_w,
                                             scene.dense_cb,
                                             scene.dense_static, time=rtime)
    else:
        order = _coherence_order(scene, o, d, t_init, anyhit_mask)
        r16 = dense.ray_vectors(
            o[order], d[order], scene.dense_center,
            anyhit=None if anyhit_mask is None else anyhit_mask[order])
        t_s, prim_s = dense.dense_intersect_loop(
            r16, t_init[order], scene.dense_w, scene.dense_cb,
            scene.dense_static,
            time=None if rtime is None else rtime[order])
        t = torch.empty_like(t_s)
        t[order] = t_s
        prim = torch.empty_like(prim_s)
        prim[order] = prim_s
    # the kernels report triangle wins only; keep the quadric pre-hit
    prim = torch.where(prim >= 0, prim, prim_init)
    return t, prim, prim >= 0


def _quadric_prehit(scene: SceneData, ray: geom.Ray):
    """(t_init [B] f32, prim_init [B] i32): the ray's tmax and no prim,
    or its closest quadric hit where it has one."""
    t_init = ray.tmax.to(torch.float32)
    prim_init = torch.full(t_init.shape, -1, dtype=torch.int32,
                           device=t_init.device)
    if scene.n_quadrics > 0:
        tq, qprim, qhit = all_quadrics_test(scene, ray.o, ray.d, t_init,
                                            ray.time)
        t_init = torch.where(qhit, tq, t_init)
        prim_init = torch.where(qhit, qprim, prim_init)
    return t_init, prim_init


def _walk_args(scene: SceneData, ray: geom.Ray, anyhit_mask):
    """The walks' common arguments: contiguous rays, the quadric pre-hit,
    the any-hit flags, and the time and motion rows when meshes move."""
    t_init, prim_init = _quadric_prehit(scene, ray)
    motion = scene.has_animated_mesh
    return dict(
        o=ray.o.contiguous(), d=ray.d.contiguous(),
        t_init=t_init.contiguous(), prim_init=prim_init.contiguous(),
        anyhit=None if anyhit_mask is None else anyhit_mask.contiguous(),
        time=ray.time.contiguous() if motion else None,
        tri_motion=scene.tri_motion if motion else None)


@torch.no_grad()
def _intersect_bvh(scene: SceneData, ray: geom.Ray, anyhit_mask=None):
    """The BVH route (pbrt_tpu's _intersect_bvh): the quadric pre-test,
    then accel_walk.bvh_walk.  Returns (t, prim, found) [B]."""
    t, prim = accel_walk.bvh_walk(
        packed=scene.bvh_packed, links=scene.bvh_links,
        tri_packed=scene.tri_packed, max_leaf=scene.max_leaf,
        **_walk_args(scene, ray, anyhit_mask))
    return t, prim, prim >= 0


@torch.no_grad()
def _intersect_kd(scene: SceneData, ray: geom.Ray, anyhit_mask=None):
    """The kd-tree route (pbrt_tpu's _intersect_kd): the quadric pre-test,
    then accel_walk.kd_walk.  Returns (t, prim, found) [B]."""
    t, prim = accel_walk.kd_walk(
        tmax=ray.tmax.contiguous(),
        kd_packed=scene.kd_packed, kd_prim_idx=scene.kd_prim_idx,
        kd_bounds=scene.kd_bounds, tri_packed=scene.tri_packed,
        kd_max_leaf=scene.kd_max_leaf,
        **_walk_args(scene, ray, anyhit_mask))
    return t, prim, prim >= 0


def quadric_uv(qtype, params, ph, kinds):
    """(u, v) at the object-space hit point ph [...,3] (sphere.cpp:190 and
    the JAX package's): u = phi / phimax for every type; v = the sphere's
    arccos(z / r) / pi, for a cylinder, cone and paraboloid too, and a
    disk's radius over r (the JAX package's, not the reference's
    (z - zmin) / (zmax - zmin) and (r - rhit) / (r - ri)).

    atan2, arccos and sqrt are held away from their infinite derivatives:
    a camera gradient would otherwise take 0 * inf = NaN through them
    where uv has no cotangent.  kinds: as _quadric_ts'."""
    r = params[..., 0]
    px, py = ph[..., 0], ph[..., 1]
    deg = (px * px + py * py) < 1e-12
    phi = torch.atan2(torch.where(deg, 0.0, py), torch.where(deg, 1.0, px))
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    u = phi / torch.clamp(params[..., 3], min=1e-6)
    zc = torch.clamp(ph[..., 2] / torch.clamp(r, min=1e-6),
                     -1.0 + 1e-6, 1.0 - 1e-6)
    v = torch.arccos(zc) / np.pi
    if PRIM_DISK in kinds:
        v = torch.where(qtype == PRIM_DISK,
                        torch.sqrt(px * px + py * py + 1e-20)
                        / torch.clamp(r, min=1e-6), v)
    return u, v


def quadric_normal_obj(qtype, params, ph, kinds):
    """The outward object-space normal (not unit) at the object-space
    point ph [...,3] of each quadric type (kinds: as _quadric_ts')."""
    r, zmax = params[..., 0], params[..., 2]
    x, y, z = ph[..., 0], ph[..., 1], ph[..., 2]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    n = ph                                                # the sphere
    if PRIM_CYLINDER in kinds:
        n = torch.where((qtype == PRIM_CYLINDER)[..., None],
                        torch.stack([x, y, zero], -1), n)
    if PRIM_DISK in kinds:
        n = torch.where((qtype == PRIM_DISK)[..., None],
                        torch.stack([zero, zero, one], -1), n)
    if PRIM_CONE in kinds:
        h = torch.where(zmax == 0, 1.0, zmax)
        n = torch.where((qtype == PRIM_CONE)[..., None],
                        torch.stack([x, y, (r / h) ** 2 * (h - z)], -1), n)
    if PRIM_PARABOLOID in kinds:
        kp = zmax / torch.where(r == 0, 1.0, r * r)
        n = torch.where((qtype == PRIM_PARABOLOID)[..., None],
                        torch.stack([2 * kp * x, 2 * kp * y, -one], -1), n)
    return n


@span("interaction")
def make_hit(scene: SceneData, ray: geom.Ray, t, prim, found,
             exact_p=False, ray_diff=None) -> Hit:
    """Surface-interaction record of the winning primitives.

    Triangle winners get an exact f32 Moller-Trumbore re-solve of t and
    the barycentrics, accepted when it stays within 1% of the kernel t
    and its barycentrics are a valid simplex point.  Moving triangles are
    solved at the ray's time.

    exact_p: a triangle hit's point is b0 p0 + b1 p1 + b2 p2, the
    reference's construction (triangle.cpp:329), in place of o + t d.

    ray_diff: optional (rxo, rxd, ryo, ryd) ray differentials [B,3] each;
    the hit then carries duv, dpdx / dpdy and dndx / dndy from the
    auxiliary rays' intersections with the hit's tangent plane
    (interaction.cpp:43-87), for triangle hits (quadric hits carry zeros:
    the texture lookup falls back to the ray cone there).  A scene with
    textures also gets uv_density."""
    P = scene.prim_type.shape[0]
    pid = torch.clamp(prim, 0, P - 1).long()
    is_tri = scene.prim_type[pid] == PRIM_TRIANGLE
    t = torch.where(found, t, 1.0)
    e1, e2, v0 = scene.tri_e1[pid], scene.tri_e2[pid], scene.tri_v0[pid]
    if scene.has_animated_mesh:
        dm = scene.tri_motion[pid]
        u_t = torch.clamp(ray.time, 0.0, 1.0)[:, None]
        v0 = v0 + u_t * dm[:, 0:3]
        e1 = e1 + u_t * dm[:, 3:6]
        e2 = e2 + u_t * dm[:, 6:9]
    pvec = geom.cross(ray.d, e2)
    det = geom.dot(e1, pvec)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    tvec = ray.o - v0
    b1 = geom.dot(tvec, pvec) * inv_det
    qvec = geom.cross(tvec, e1)
    b2 = geom.dot(ray.d, qvec) * inv_det
    t_mt = geom.dot(e2, qvec) * inv_det
    refine = (found & is_tri & ok_det & (t_mt > 0) & (t_mt < t * 1.01)
              & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1.0 + 1e-4))
    b1c = torch.clamp(b1, 0.0, 1.0)
    b2c = torch.minimum(torch.clamp(b2, min=0.0), 1.0 - b1c)
    t = torch.where(refine, t_mt, t)
    tri_hit = found & is_tri
    u = torch.where(tri_hit, torch.where(refine, b1, b1c), 0.0)
    v = torch.where(tri_hit, torch.where(refine, b2, b2c), 0.0)
    p = ray.at(t)
    if exact_p:
        b0w = (1.0 - u - v)[:, None]
        p_bary = b0w * v0 + u[:, None] * (v0 + e1) + v[:, None] * (v0 + e2)
        p = torch.where(tri_hit[:, None], p_bary, p)
    ng_tri = geom.normalize(geom.cross(e1, e2))
    b0 = (1.0 - u - v)[:, None]
    tns = scene.tri_ns[pid]
    ns_tri = b0 * tns[:, 0] + u[:, None] * tns[:, 1] + v[:, None] * tns[:, 2]
    has_ns = geom.length_sq(ns_tri) > 1e-12
    ns_tri = torch.where(has_ns[:, None], geom.normalize(ns_tri), ng_tri)
    ns_tri = torch.where(geom.dot(ns_tri, ng_tri)[:, None] < 0,
                         -ns_tri, ns_tri)
    tuv = scene.tri_uv[pid]
    uv = b0 * tuv[:, 0] + u[:, None] * tuv[:, 1] + v[:, None] * tuv[:, 2]
    ng, ns = ng_tri, ns_tri
    qparams = None
    if scene.n_quadrics > 0:
        qi = torch.clamp(scene.quad_idx[pid], 0,
                         scene.quad_params.shape[0] - 1).long()
        w2o = (_animated_quad_w2o(scene, ray.time, qi)
               if scene.has_animated_quads else scene.quad_w2o[qi, :3])
        qparams = scene.quad_params[qi]
        ptype = scene.prim_type[pid]
        ph = torch.einsum('bij,bj->bi', w2o[:, :, :3], p) + w2o[:, :, 3]
        ng_quad = geom.normalize(torch.einsum(
            'bji,bj->bi', w2o[:, :, :3],
            quadric_normal_obj(ptype, qparams, ph, scene.quad_kinds)))
        uq, vq = quadric_uv(ptype, qparams, ph, scene.quad_kinds)
        tri = is_tri[:, None]
        ng = torch.where(tri, ng_tri, ng_quad)
        ns = torch.where(tri, ns_tri, ng_quad)
        uv = torch.where(tri, uv, torch.stack([uq, vq], -1))
    flip = scene.prim_flip_normal[pid][:, None]
    ng = torch.where(flip, -ng, ng)
    ns = torch.where(flip, -ns, ns)
    extra = {}
    if scene.tex_type.shape[0] > 1 or ray_diff is not None:
        extra = _surface_differentials(is_tri, found, e1, e2, tuv, tns, p,
                                       ng, qparams, ray_diff)
    return Hit(valid=found, t=t, p=p, ng=ng, ns=ns, uv=uv,
               wo=-geom.normalize(ray.d), prim=pid,
               material=torch.where(found, scene.prim_material[pid], -1),
               light=torch.where(found, scene.prim_light[pid], -1),
               instance=torch.where(found, scene.prim_instance[pid], -1),
               face=scene.prim_face[pid] if scene.has_ptex else None,
               **extra)


def _surface_differentials(is_tri, found, e1, e2, tuv, tns, p, ng, qparams,
                           ray_diff):
    """uv_density and, with ray_diff, the differentials of make_hit."""
    fin = lambda a: torch.where(torch.isfinite(a), a, 0.0)  # noqa: E731
    uv_e1 = tuv[:, 1] - tuv[:, 0]
    uv_e2 = tuv[:, 2] - tuv[:, 0]
    det_uv = uv_e1[:, 0] * uv_e2[:, 1] - uv_e1[:, 1] * uv_e2[:, 0]
    # triangles: the uv-edge / world-edge area ratio; quadrics: the
    # parameterization's scale (all of [0,1]^2 over ~2 pi r of surface)
    uv_density = torch.sqrt(torch.abs(det_uv) / torch.clamp(
        geom.length(geom.cross(e1, e2)), min=1e-12))
    if qparams is not None:
        r_quad = torch.clamp(torch.abs(qparams[:, 0]), min=1e-6)
        uv_density = torch.where(is_tri, uv_density,
                                 1.0 / (2.0 * np.pi * r_quad))
    out = dict(uv_density=uv_density)
    if ray_diff is None:
        return out
    # dpdu, dpdv from the uv edge matrix (triangle.cpp:157-187)
    ok_uv = torch.abs(det_uv) > 1e-12
    inv_uv = torch.where(ok_uv, 1.0 / torch.where(ok_uv, det_uv, 1.0), 0.0)
    dpdu = (uv_e2[:, 1:2] * e1 - uv_e1[:, 1:2] * e2) * inv_uv[:, None]
    dpdv = (-uv_e2[:, 0:1] * e1 + uv_e1[:, 0:1] * e2) * inv_uv[:, None]
    # the auxiliary rays against the tangent plane (interaction.cpp:52-66)
    rxo, rxd, ryo, ryd = ray_diff
    d_pl = geom.dot(ng, p)

    def plane_hit(ro, rd):
        denom = geom.dot(ng, rd)
        okp = torch.abs(denom) > 1e-12
        tt = torch.where(okp, (d_pl - geom.dot(ng, ro))
                         / torch.where(okp, denom, 1.0), 0.0)
        return ro + tt[:, None] * rd, okp

    px, okx = plane_hit(rxo, rxd)
    py, oky = plane_hit(ryo, ryd)
    dpdx = px - p
    dpdy = py - p
    # least squares on the 2x2 normal equations (dpdx, dpdy lie in the
    # tangent plane, so this equals the reference's axis-picked solve)
    g11 = geom.dot(dpdu, dpdu)
    g12 = geom.dot(dpdu, dpdv)
    g22 = geom.dot(dpdv, dpdv)
    det_g = g11 * g22 - g12 * g12
    ok_g = torch.abs(det_g) > 1e-20
    inv_g = torch.where(ok_g, 1.0 / torch.where(ok_g, det_g, 1.0), 0.0)

    def solve(dp):
        b1 = geom.dot(dp, dpdu)
        b2 = geom.dot(dp, dpdv)
        return (g22 * b1 - g12 * b2) * inv_g, (g11 * b2 - g12 * b1) * inv_g

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    good = (found & is_tri & ok_uv & ok_g & okx & oky)[:, None]
    duv = fin(torch.where(good, torch.stack([dudx, dvdx, dudy, dvdy], -1),
                          0.0))
    # the shading normal's derivatives, for specular propagation (dndu,
    # dndv from the same uv edge matrix over the vertex normals)
    n0 = tns[:, 0]
    dn1 = tns[:, 1] - n0
    dn2 = tns[:, 2] - n0
    dndu = (uv_e2[:, 1:2] * dn1 - uv_e1[:, 1:2] * dn2) * inv_uv[:, None]
    dndv = (-uv_e2[:, 0:1] * dn1 + uv_e1[:, 0:1] * dn2) * inv_uv[:, None]
    gx = good & (geom.length_sq(n0) > 1e-12)[:, None]
    out.update(
        duv=duv, dpdx=fin(torch.where(good, dpdx, 0.0)),
        dpdy=fin(torch.where(good, dpdy, 0.0)),
        dndx=fin(torch.where(gx, dndu * dudx[:, None] + dndv * dvdx[:, None],
                             0.0)),
        dndy=fin(torch.where(gx, dndu * dudy[:, None] + dndv * dvdy[:, None],
                             0.0)))
    return out


def intersect_full(scene: SceneData, ray: geom.Ray, presorted=False,
                   ray_diff=None) -> Hit:
    t, prim, found = intersect(scene, ray, presorted=presorted)
    return make_hit(scene, ray, t, prim, found, ray_diff=ray_diff)


def nee_ignore_light(scene: SceneData, l):
    """The light each shadow lane must not count as an occluder: the
    sampled light l [B] where it is a sphere light, else -1; None when the
    scene has no sphere lights.

    Mesh and delta lights have an exact sample distance, so the shadow
    ray's tmax shave (spawn_shadow_ray) keeps the light's own geometry
    out of the segment, and a mesh light's own faces still occlude, as in
    the reference (SpawnRayTo's 1 - ShadowEpsilon).  A sphere light's
    sample distance is approximate in f32, so its own sphere is excluded
    by id (the JAX package's rule)."""
    if l is None or not scene.has_sphere_lights:
        return None
    lq = scene.light_quad[torch.clamp(l, 0, scene.light_quad.shape[0] - 1)]
    return torch.where((l >= 0) & (lq >= 0), l, -1)


def trace_pair(scene: SceneData, nray: geom.Ray, sray, ignore_light=None,
               ray_diff=None):
    """Trace a bounce's closest-hit rays and NEE shadow rays as ONE batch
    (one sort, one K1 and one K2 launch).  Returns (Hit for nray,
    occluded [B] for sray).

    The shadow half runs any-hit, but for lanes whose ignore_light [sB]
    (nee_ignore_light) is a light: those run closest-hit, as in the JAX
    package, and their winner does not occlude when it is that light's
    own sphere.  ray_diff: the closest-hit rays' differentials
    (make_hit)."""
    if sray is None:
        return intersect_full(scene, nray, ray_diff=ray_diff), None
    B = nray.o.shape[0]
    dev = nray.o.device
    with torch.no_grad():       # the search's input: no gradient to keep
        both = geom.Ray(*(torch.cat([getattr(nray, f), getattr(sray, f)])
                          for f in ("o", "d", "tmax", "wavelength", "time")))
    sh_any = (torch.ones(sray.o.shape[0], dtype=torch.bool, device=dev)
              if ignore_light is None else ignore_light < 0)
    amask = torch.cat([torch.zeros(B, dtype=torch.bool, device=dev), sh_any])
    t, prim, found = intersect(scene, both, anyhit_mask=amask)
    hit = make_hit(scene, nray, t[:B], prim[:B], found[:B],
                   ray_diff=ray_diff)
    occ = found[B:]
    if ignore_light is not None:
        # the winner's light: a sphere light's id only on its sphere
        hit_light = scene.prim_light[torch.clamp(prim[B:], min=0).long()]
        occ = occ & ~((ignore_light >= 0) & (hit_light == ignore_light))
    return hit, occ


def _shadow_anyhit(scene: SceneData, ignore_light, B):
    """The any-hit mask of shadow lanes (the JAX package's): every lane,
    but for lanes excluding a mesh light, which run closest-hit so that a
    first accepted face of that light cannot park the lane before a real
    blocker (nee_ignore_light only names sphere lights, so with it every
    lane is any-hit)."""
    ones = torch.ones(B, dtype=torch.bool, device=scene.device)
    if ignore_light is None or not scene.has_mesh_lights:
        return ones
    lq = scene.light_quad[torch.clamp(ignore_light, 0,
                                      scene.light_quad.shape[0] - 1)]
    return ~((ignore_light >= 0) & (lq < 0))


def occluded(scene: SceneData, ray: geom.Ray, ignore_light=None):
    """Shadow-ray IntersectP (reference scene.h:59): whether each ray is
    blocked before its tmax.  ignore_light [B] (nee_ignore_light): a
    light whose own geometry does not occlude."""
    amask = _shadow_anyhit(scene, ignore_light, ray.o.shape[0])
    _, prim, found = intersect(scene, ray, anyhit_mask=amask)
    if ignore_light is not None and scene.n_quadrics > 0:
        hit_light = scene.prim_light[torch.clamp(prim, min=0).long()]
        found = found & ~((ignore_light >= 0) & (hit_light == ignore_light))
    return found


def intersect_tr_walk(scene: SceneData, org, wi, dist, cand, cur_med,
                      wavelength, time=None, ignore_light=None,
                      max_crossings=8, pixel_id=None, sample_idx=None,
                      dim_salt=0x7400):
    """The shadow ray's transmittance walk across medium interfaces
    (reference Scene::IntersectTr, scene.cpp:57-81; the JAX package's
    wavefront form).

    Each of `max_crossings` steps is one closest-hit `intersect` call
    (K1 and K2) over the whole batch.  A lane whose hit has a material
    is blocked; a material-less primitive is an interface, and so is the
    sampled light's own geometry (ignore_light [B]): the lane adds its
    current medium's part of the sub-segment, takes the crossed side's
    medium (against the outward geometric normal: the inside one) and
    goes on; a lane whose segment ends drops out, so later steps run on
    nearly empty batches.  A homogeneous sub-segment adds optical depth;
    with pixel_id and sample_idx, a grid sub-segment multiplies in its
    ratio-tracked Tr (grid.cpp:89+).  Without them a grid medium counts as
    homogeneous at its unscaled sigma_t, as in the JAX package.  A lane
    still crossing after the last step stops adding (a truncation toward
    brighter).

    The hit is classified from prim_material and prim_light by plain
    gathers (the port has no packed per-primitive row).  Returns (blocked
    [B] bool, optical depth [B,31], tr_ratio [B]): Tr = exp(-optical) *
    tr_ratio."""
    from pbrt_tpu_torch.media import media as medmod
    B = org.shape[0]
    P = scene.prim_type.shape[0]
    M = scene.mat_type.shape[0]
    K = scene.med_sigma_a.shape[0]
    sig_t_tab = scene.med_sigma_a + scene.med_sigma_s           # [K,31]
    remaining = torch.where(torch.isfinite(dist), dist,
                            2 * scene.world_radius)
    med = cur_med
    act = cand
    blocked = torch.zeros(B, dtype=torch.bool, device=org.device)
    optical = torch.zeros((B, sig_t_tab.shape[1]), device=org.device)
    tr_ratio = torch.ones(B, device=org.device)
    grids = scene.has_grid_media and pixel_id is not None
    p = org
    for cross_i in range(max_crossings):
        ray = geom.Ray.make(p, wi, tmax=torch.where(act, remaining, -1.0),
                            wavelength=wavelength, time=time)
        t, prim, found = intersect(scene, ray)
        seg = torch.where(found, t, remaining)
        # the current medium's optical depth over the sub-segment
        mk = torch.clamp(med, 0, K - 1).long()
        in_grid = ((med >= 0) & scene.med_is_grid[mk] if grids
                   else torch.zeros_like(act))
        sig_t = sig_t_tab[mk] * ((med >= 0) & ~in_grid)[:, None]
        optical = optical + torch.where(
            act[:, None], sig_t * torch.clamp(seg, min=0.0)[:, None], 0.0)
        if grids:
            # (a lane that is not walking a grid tracks over an empty
            # segment: the loop's early exit does not wait on it)
            trg = medmod.ratio_tr_lanes(
                scene.med_density, scene.med_dims, scene.med_w2m[mk],
                scene.med_inv_maxd[mk], sig_t_tab[mk].amax(-1), p, wi,
                torch.where(act & in_grid, torch.clamp(seg, min=0.0), 0.0),
                mk, pixel_id, sample_idx, dim_salt + 64 * cross_i)
            tr_ratio = tr_ratio * torch.where(act & in_grid, trg, 1.0)
        # material-less primitives are pass-through interfaces; so is the
        # sampled light's own geometry
        pid = torch.clamp(prim, 0, P - 1).long()
        mat_idx = scene.prim_material[pid]
        mtype = torch.where(
            mat_idx >= 0, scene.mat_type[torch.clamp(mat_idx, 0, M - 1)
                                         .long()], MAT_NONE)
        is_iface = found & (mtype == MAT_NONE)
        is_ignored = (found & (ignore_light >= 0)
                      & (scene.prim_light[pid] == ignore_light)
                      if ignore_light is not None else torch.zeros_like(act))
        blocked = blocked | (act & found & ~is_iface & ~is_ignored)
        # the medium switch: against the outward geometric normal the ray
        # enters the primitive's inside medium
        ng = geom.cross(scene.tri_e1[pid], scene.tri_e2[pid])
        if scene.n_quadrics > 0:
            # a quadric's normal from its static world-to-object transform
            qi = torch.clamp(scene.quad_idx[pid], 0,
                             scene.quad_params.shape[0] - 1).long()
            w2o = scene.quad_w2o[qi]
            ph_w = p + torch.where(found, t, 1.0)[:, None] * wi
            ph = torch.einsum('bij,bj->bi', w2o[:, :3, :3], ph_w) \
                + w2o[:, :3, 3]
            ng_quad = torch.einsum('bji,bj->bi', w2o[:, :3, :3],
                                   quadric_normal_obj(scene.prim_type[pid],
                                                      scene.quad_params[qi],
                                                      ph, scene.quad_kinds))
            ng = torch.where((scene.prim_type[pid] == PRIM_TRIANGLE)[:, None],
                             ng, ng_quad)
        ng = torch.where(scene.prim_flip_normal[pid][:, None], -ng, ng)
        entering = geom.dot(wi, ng) < 0
        new_med = torch.where(entering, scene.prim_medium_in[pid],
                              scene.prim_medium_out[pid])
        med = torch.where(act & is_iface, new_med, med)
        # past the crossing by a relative epsilon
        adv = seg + 1e-4 * torch.clamp(torch.abs(seg), min=1e-3)
        p = torch.where(act[:, None], p + adv[:, None] * wi, p)
        remaining = remaining - adv
        act = act & found & (is_iface | is_ignored) & (remaining > 0)
    return blocked, optical, tr_ratio


def spawn_ray(p, ng, direction, wavelength, time=None, tmax=None,
              eps_scale=1e-4):
    """Offset-origin ray spawn (reference: interaction.h SpawnRay)."""
    scale = torch.clamp(torch.abs(p).amax(-1), min=1.0)
    eps = (eps_scale * scale)[..., None]
    off = torch.where(geom.dot(direction, ng)[..., None] >= 0, eps, -eps) * ng
    return geom.Ray.make(p + off, direction, tmax=tmax,
                         wavelength=wavelength, time=time)


def spawn_shadow_ray(p, ng, wi, dist, cand, wavelength, time=None,
                     eps_scale=1e-4, shave=0.999):
    """Shadow ray toward a light sample at distance `dist` along unit wi;
    the shave applies to the distance from the offset origin.  Lanes not
    in `cand` get tmax = -1 and drop out of the intersect queue."""
    scale = torch.clamp(torch.abs(p).amax(-1), min=1.0)
    eps = (eps_scale * scale)[..., None]
    off = torch.where(geom.dot(wi, ng)[..., None] >= 0, eps, -eps) * ng
    d_eff = dist - geom.dot(off, wi)
    return geom.Ray.make(p + off, wi,
                         tmax=torch.where(cand, d_eff * shave, -1.0),
                         wavelength=wavelength, time=time)
