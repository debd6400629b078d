"""Ray-scene intersection (port of the dense path of pbrt_tpu.ops.intersect).

Every query runs the sphere pre-test, a coherence sort of the rays, the
dense kernels K1 and K2 (ops/dense_intersect.py) and the inverse
permutation; `make_hit` then re-solves the winner in f32 and gathers the
surface record.  The search runs under `torch.no_grad()`: visibility is
not differentiated (the JAX package's stop_gradient).

Sphere area lights are not ported, so the JAX package's sphere-light
exclusion for shadow rays (`nee_ignore_light`, `_shadow_anyhit`) reduces
to "every shadow lane is an any-hit lane" and is folded into
`trace_pair`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.scene.ir import SceneData, PRIM_TRIANGLE


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

    def to(self, device):
        return Hit(*(getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)))


def _sphere_ts(params, oo, od):
    """Both roots of the sphere quadric in object space, t0 <= t1."""
    r = params[..., 0]
    ox, oy, oz = oo[..., 0], oo[..., 1], oo[..., 2]
    dx, dy, dz = od[..., 0], od[..., 1], od[..., 2]
    a = dx * dx + dy * dy + dz * dz
    b = 2 * (dx * ox + dy * oy + dz * oz)
    c = ox * ox + oy * oy + oz * oz - r * r
    disc = b * b - 4 * a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    safe_a = torch.where(a == 0, 1.0, a)
    safe_q = torch.where(q == 0, 1.0, q)
    ta, tb = q / safe_a, c / safe_q
    return (torch.minimum(ta, tb), torch.maximum(ta, tb),
            ok & ~(torch.abs(a) < 1e-12))


def all_quadrics_test(scene: SceneData, o, d, tmax):
    """Every sphere against every ray: (t [B], prim [B], hit [B])."""
    w2o = scene.quad_w2o
    oo = torch.einsum('qij,bj->bqi', w2o[:, :3, :3], o) + w2o[None, :, :3, 3]
    od = torch.einsum('qij,bj->bqi', w2o[:, :3, :3], d)
    params = scene.quad_params[None, :, :]
    t0, t1, ok = _sphere_ts(params, oo, od)

    def clip_ok(t):
        if not scene.clip_quadrics:
            return torch.ones(t.shape, dtype=torch.bool, device=t.device)
        ph = oo + t[..., None] * od
        zmin, zmax = params[..., 1], params[..., 2]
        z_ok = ((ph[..., 2] >= torch.minimum(zmin, zmax) - 1e-5)
                & (ph[..., 2] <= torch.maximum(zmin, zmax) + 1e-5))
        phi = torch.atan2(ph[..., 1], ph[..., 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        return z_ok & (phi <= params[..., 3] + 1e-5)

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


@torch.no_grad()
def intersect(scene: SceneData, ray: geom.Ray, presorted=False,
              anyhit_mask=None):
    """Closest-hit query, any-hit for lanes flagged in anyhit_mask [B].

    presorted skips the coherence sort (camera batches arrive in
    scanline order, already tile-coherent).  Returns (t, prim, found)
    [B]; any-hit lanes that hit a triangle report t = -1."""
    o, d = ray.o, ray.d
    t_init = ray.tmax.to(torch.float32)
    prim_init = torch.full(t_init.shape, -1, dtype=torch.int32,
                           device=t_init.device)
    if scene.n_quadrics > 0:
        tq, qprim, qhit = all_quadrics_test(scene, o, d, t_init)
        t_init = torch.where(qhit, tq, t_init)
        prim_init = torch.where(qhit, qprim, prim_init)
    if presorted:
        r16 = dense.ray_vectors(o, d, scene.dense_center, anyhit=anyhit_mask)
        t, prim = dense.dense_intersect_loop(r16, t_init, scene.dense_w,
                                             scene.dense_cb)
    else:
        key = _coherence_key(scene, o, d, t_init)
        if anyhit_mask is not None:
            # any-hit lanes sort behind closest-hit lanes, dead lanes last
            key = torch.where(t_init > 0,
                              key | (anyhit_mask.to(torch.int32) << 19),
                              1 << 20)
        order = torch.sort(key, stable=True).indices
        r16 = dense.ray_vectors(
            o[order], d[order], scene.dense_center,
            anyhit=None if anyhit_mask is None else anyhit_mask[order])
        t_s, prim_s = dense.dense_intersect_loop(r16, t_init[order],
                                                 scene.dense_w,
                                                 scene.dense_cb)
        t = torch.empty_like(t_s)
        t[order] = t_s
        prim = torch.empty_like(prim_s)
        prim[order] = prim_s
    # the kernels report triangle wins only; keep the sphere pre-hit
    prim = torch.where(prim >= 0, prim, prim_init)
    return t, prim, prim >= 0


def _sphere_uv(params, ph):
    """(u, v) of an object-space sphere point (sphere.cpp:190)."""
    px, py = ph[..., 0], ph[..., 1]
    deg = (px * px + py * py) < 1e-12
    phi = torch.atan2(torch.where(deg, 0.0, py), torch.where(deg, 1.0, px))
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    u = phi / torch.clamp(params[..., 3], min=1e-6)
    zc = torch.clamp(ph[..., 2] / torch.clamp(params[..., 0], min=1e-6),
                     -1.0 + 1e-6, 1.0 - 1e-6)
    return u, torch.arccos(zc) / np.pi


def make_hit(scene: SceneData, ray: geom.Ray, t, prim, found) -> Hit:
    """Surface-interaction record of the winning primitives.

    Triangle winners get an exact f32 Moller-Trumbore re-solve of t and
    the barycentrics, accepted when it stays within 1% of the kernel t
    and its barycentrics are a valid simplex point."""
    P = scene.prim_type.shape[0]
    pid = torch.clamp(prim, 0, P - 1).long()
    is_tri = scene.prim_type[pid] == PRIM_TRIANGLE
    t = torch.where(found, t, 1.0)
    e1, e2, v0 = scene.tri_e1[pid], scene.tri_e2[pid], scene.tri_v0[pid]
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
    if scene.n_quadrics > 0:
        qi = torch.clamp(scene.quad_idx[pid], 0,
                         scene.quad_params.shape[0] - 1).long()
        w2o = scene.quad_w2o[qi, :3]
        qparams = scene.quad_params[qi]
        ph = torch.einsum('bij,bj->bi', w2o[:, :, :3], p) + w2o[:, :, 3]
        ng_quad = geom.normalize(torch.einsum('bji,bj->bi',
                                              w2o[:, :, :3], ph))
        uq, vq = _sphere_uv(qparams, ph)
        tri = is_tri[:, None]
        ng = torch.where(tri, ng_tri, ng_quad)
        ns = torch.where(tri, ns_tri, ng_quad)
        uv = torch.where(tri, uv, torch.stack([uq, vq], -1))
    flip = scene.prim_flip_normal[pid][:, None]
    ng = torch.where(flip, -ng, ng)
    ns = torch.where(flip, -ns, ns)
    return Hit(valid=found, t=t, p=p, ng=ng, ns=ns, uv=uv,
               wo=-geom.normalize(ray.d), prim=pid,
               material=torch.where(found, scene.prim_material[pid], -1),
               light=torch.where(found, scene.prim_light[pid], -1))


def intersect_full(scene: SceneData, ray: geom.Ray, presorted=False) -> Hit:
    t, prim, found = intersect(scene, ray, presorted=presorted)
    return make_hit(scene, ray, t, prim, found)


def trace_pair(scene: SceneData, nray: geom.Ray, sray):
    """Trace a bounce's closest-hit rays and NEE shadow rays as ONE batch
    (one sort, one K1 and one K2 launch).  Returns (Hit for nray,
    occluded [B] for sray); the shadow half runs any-hit."""
    if sray is None:
        return intersect_full(scene, nray), None
    B = nray.o.shape[0]
    both = geom.Ray(*(torch.cat([getattr(nray, f), getattr(sray, f)])
                      for f in ("o", "d", "tmax", "wavelength", "time")))
    amask = torch.cat([torch.zeros(B, dtype=torch.bool, device=nray.o.device),
                       torch.ones(sray.o.shape[0], dtype=torch.bool,
                                  device=nray.o.device)])
    t, prim, found = intersect(scene, both, anyhit_mask=amask)
    hit = make_hit(scene, nray, t[:B], prim[:B], found[:B])
    return hit, found[B:]


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
