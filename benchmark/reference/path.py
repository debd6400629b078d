"""The plain reference of the port's path estimator on the benchmark's
scenes, in plain PyTorch: its own scene reader, sampler, camera,
brute-force intersection, BSDFs, light sampling and bounce loop.

The estimator is the one the port's renders compute, stated here from
pbrt-v3's equations with the port's own choices written out where the
port departs from pbrt-v3 or picks among equivalent forms:
- every sampler dimension is a pure function of (pixel, sample, dim);
  dims 0-1 the film jitter, 2-3 the lens, 4 the time, then 9 a bounce
  from dim 5: light choice, light (2), BSDF lobe, BSDF (2), roulette;
- bounce 0 counts emission whole; later bounces weigh a BSDF-sampled hit
  of the light by the power heuristic against NEE, and NEE's own weight
  uses the light's solid-angle pdf alone; a mesh light is sampled by
  area, a triangle by the area cdf, a point by (1 - sqrt u1, u2 sqrt u1)
  along the triangle's two edges;
- a new ray starts 1e-4 max(1, max|p|) off the surface along the
  geometric normal, on the side it leaves by; a shadow ray's length is
  shaved by 0.999;
- Russian roulette from bounce 4, q = clamp(1 - max(beta) etaScale,
  0.05, 0.99), when max(beta) etaScale < 1;
- plastic picks its diffuse or GGX lobe by u < 0.5 and its pdf is the
  two lobes' mean; glass reflects with probability F.

Every float computes in the dtype given (float32, or bfloat16 for the
control).  Rays are traced against every triangle in blocks of lanes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import sampler
from benchmark.reference import scene as scn

PI = math.pi
DIM_BOUNCE = 5
DIMS_PER_BOUNCE = 9
BLOCK = 2048          # lanes per brute-force intersection block
EDGE = 1e-6
GROUP_MIN = 64        # a Shape this large gets its own bounding box


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=1e-20))[..., None]


class Tables:
    """The scene's arrays on a device in one dtype."""

    def __init__(self, sc: scn.Scene, device, dtype):
        self.sc, self.dev, self.dt = sc, device, dtype

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        v = sc.tri_v
        self.v0, self.e1, self.e2 = f(v[:, 0]), f(v[:, 1] - v[:, 0]), \
            f(v[:, 2] - v[:, 0])
        ng = normalize(cross(self.e1, self.e2))
        flip = torch.as_tensor(sc.tri_flip, device=device)
        self.tri_ng = torch.where(flip[:, None], -ng, ng)
        self.tri_mat = torch.as_tensor(sc.tri_material, device=device)
        self.tri_light = torch.as_tensor(sc.tri_light, device=device)
        self.tri_med = torch.as_tensor(sc.tri_medium, device=device)
        # each large Shape's triangles behind its bounding box; the small
        # ones together, always tested
        self.groups = []
        small = []
        a = 0
        for n in sc.shape_sizes:
            if n >= GROUP_MIN:
                box = v[a:a + n].reshape(-1, 3)
                self.groups.append((a, a + n, f(box.min(0)), f(box.max(0))))
            else:
                small.extend(range(a, a + n))
            a += n
        self.small = torch.as_tensor(small, dtype=torch.int64, device=device)
        self.spheres = []
        for s in sc.spheres:
            w2o = np.linalg.inv(s["o2w"])
            self.spheres.append(dict(w2o=f(w2o[:3]), r=s["radius"],
                                     material=s["material"], flip=s["flip"],
                                     medium=s["medium"]))
        mats = sc.materials
        self.mat_kind = torch.as_tensor([m.kind for m in mats], device=device)
        z = np.zeros(31)
        for k in ("kd", "ks", "kr", "kt"):
            setattr(self, k, f(np.stack([getattr(m, k) if getattr(m, k)
                                         is not None else z for m in mats])))
        self.alpha = f([m.alpha for m in mats])
        self.eta = f([m.eta for m in mats])
        # the area light: its triangles, their area cdf and normals
        lt = np.nonzero(sc.tri_light)[0]
        lv = v[lt]
        areas = 0.5 * np.linalg.norm(np.cross(lv[:, 1] - lv[:, 0],
                                              lv[:, 2] - lv[:, 0]), axis=-1)
        self.light_area = float(areas.sum())
        cdf = np.concatenate([[0.0], np.cumsum(areas) / areas.sum()])
        self.light_cdf = f(cdf.astype(np.float32))
        self.light_v0, self.light_e1, self.light_e2 = (
            self.v0[lt], self.e1[lt], self.e2[lt])
        self.light_n = self.tri_ng[lt]
        self.light_L = f(sc.light_L.astype(np.float32))
        self.n_light_tris = len(lt)
        # the scene's bounding sphere radius, over triangles and spheres
        lo = [v.reshape(-1, 3).min(0)]
        hi = [v.reshape(-1, 3).max(0)]
        for s in sc.spheres:
            c = s["o2w"][:3, 3]
            r = s["radius"] * np.linalg.norm(s["o2w"][:3, 0])
            lo.append(c - r)
            hi.append(c + r)
        self.world_radius = float(np.float32(0.5 * np.linalg.norm(
            np.max(hi, 0) - np.min(lo, 0)) + 1e-3))


# ---------------------------------------------------------------- camera

def camera_rays(sc: scn.Scene, W, H, pixel, index, seed, dtype, device):
    """World-space camera rays (o, d [B,3]) of a pinhole perspective
    camera (pbrt-v3 perspective.cpp) for pixel ids at sample indices."""
    frame = W / H
    sx, sy = (frame, 1.0) if frame > 1 else (1.0, 1.0 / frame)
    t = 1.0 / math.tan(math.radians(sc.fov) / 2.0)
    ix = (pixel % W).to(torch.float32)
    iy = (pixel // W).to(torch.float32)
    fx = ix + sampler.sample(pixel, index, 0, seed)
    fy = iy + sampler.sample(pixel, index, 1, seed)
    # raster -> screen -> camera space at z = 1 (the near plane scales out)
    x = (-sx + 2.0 * sx * fx / W) / t
    y = (sy - 2.0 * sy * fy / H) / t
    d = torch.stack([x, y, torch.ones_like(x)], -1).to(dtype)
    d = normalize(d)
    m = torch.as_tensor(sc.cam_to_world, dtype=dtype, device=device)
    dw = normalize(d @ m[:3, :3].T)
    o = m[:3, 3].expand(dw.shape)
    return o, dw


# ---------------------------------------------------------- intersection

def _tri_block(o, d, tmax, v0, e1, e2, anyhit):
    """Moller-Trumbore of a block of rays against triangles (v0, e1, e2
    [K,3]): closest (t, index) or any hit before tmax."""
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tx = o[:, 0:1] - v0[None, :, 0]
    ty = o[:, 1:2] - v0[None, :, 1]
    tz = o[:, 2:3] - v0[None, :, 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = ok & (u >= -EDGE) & (v >= -EDGE) & (u + v <= 1 + EDGE) & (t > 0) \
        & (t < tmax[:, None])
    if anyhit:
        return hit.any(1)
    tm = torch.where(hit, t, torch.full_like(t, float("inf")))
    return tm.min(1)


def _box_hit(o, d, tmax, lo, hi):
    """Rays whose segment [0, tmax) meets the box (a slab test with a
    little slack)."""
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d,
                            torch.full_like(d, 1e-12))
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1) * (1 + 1e-3) + 1e-4
    return (tn <= tf) & (tf > 0) & (tn < tmax)


def _triangles(o, d, tmax, T: Tables, anyhit):
    """Closest (t, index) or any hit over every triangle, for rays with
    tmax > 0, group by group."""
    B = o.shape[0]
    best = torch.full((B,), float("inf"), dtype=o.dtype, device=o.device)
    idx = torch.full((B,), -1, dtype=torch.int64, device=o.device)
    occ = torch.zeros(B, dtype=torch.bool, device=o.device)
    live = torch.nonzero(tmax > 0)[:, 0]
    parts = [(T.small, live)]
    for a, b, lo, hi in T.groups:
        lanes = live[_box_hit(o[live], d[live], tmax[live], lo, hi)]
        parts.append((torch.arange(a, b, device=o.device), lanes))
    for tris, lanes in parts:
        if tris.numel() == 0:
            continue
        v0, e1, e2 = T.v0[tris], T.e1[tris], T.e2[tris]
        for s in range(0, lanes.shape[0], BLOCK):
            lb = lanes[s:s + BLOCK]
            if anyhit:
                occ[lb] |= _tri_block(o[lb], d[lb], tmax[lb], v0, e1, e2,
                                      True)
                continue
            tb, ib = _tri_block(o[lb], d[lb], tmax[lb], v0, e1, e2, False)
            closer = tb < best[lb]
            best[lb] = torch.where(closer, tb, best[lb])
            idx[lb] = torch.where(closer, tris[ib], idx[lb])
    return occ if anyhit else (best, idx)


def _spheres(o, d, tmax, T: Tables):
    """Closest sphere hit: (t, sphere index or -1)."""
    best = torch.full_like(tmax, float("inf"))
    idx = torch.full(tmax.shape, -1, dtype=torch.int64, device=o.device)
    for k, s in enumerate(T.spheres):
        w = s["w2o"]
        oo = o @ w[:, :3].T + w[:, 3]
        od = d @ w[:, :3].T
        a = dot(od, od)
        b = 2 * dot(od, oo)
        c = dot(oo, oo) - s["r"] * s["r"]
        disc = b * b - 4 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        ta = q / a
        tb = c / torch.where(q == 0, torch.ones_like(q), q)
        t0, t1 = torch.minimum(ta, tb), torch.maximum(ta, tb)
        ok = disc >= 0
        use0 = ok & (t0 > 1e-5) & (t0 < tmax)
        use1 = ok & (t1 > 1e-5) & (t1 < tmax) & ~use0
        t = torch.where(use0, t0, torch.where(use1, t1, best))
        closer = (use0 | use1) & (t < best)
        best = torch.where(closer, t, best)
        idx = torch.where(closer, k, idx)
    return best, idx


def intersect(o, d, tmax, T: Tables):
    """Closest hit of rays with tmax <= 0 skipped: (found, t, triangle
    index or -1, sphere index or -1)."""
    t_tri, i_tri = _triangles(o, d, tmax, T, False)
    t_sph, i_sph = _spheres(o, d, torch.where(tmax > 0, tmax,
                                              torch.zeros_like(tmax)), T)
    sph_wins = (i_sph >= 0) & (t_sph < t_tri)
    t = torch.where(sph_wins, t_sph, t_tri)
    i_tri = torch.where(sph_wins, -1, i_tri)
    i_sph = torch.where(sph_wins, i_sph, -1)
    return (i_tri >= 0) | (i_sph >= 0), t, i_tri, i_sph


def occluded(o, d, tmax, T: Tables):
    """Any hit before tmax, for rays with tmax > 0."""
    occ = _triangles(o, d, tmax, T, True)
    _, i_sph = _spheres(o, d, torch.where(tmax > 0, tmax,
                                          torch.zeros_like(tmax)), T)
    return occ | (i_sph >= 0)


class Hit:
    """The surface record of a batch: point, normals, material, light."""

    def __init__(self, o, d, found, t, i_tri, i_sph, T: Tables):
        dev, dt = o.device, o.dtype
        self.valid = found
        self.t = torch.where(found, t, torch.ones_like(t))
        self.p = o + self.t[:, None] * d
        it = torch.clamp(i_tri, min=0)
        ng = T.tri_ng[it]
        mat = T.tri_mat[it]
        light = T.tri_light[it] & (i_tri >= 0)
        med = T.tri_med[it]
        for k, s in enumerate(T.spheres):
            on = i_sph == k
            w = s["w2o"]
            ph = self.p @ w[:, :3].T + w[:, 3]
            n = normalize(ph @ w[:, :3])
            if s["flip"]:
                n = -n
            ng = torch.where(on[:, None], n, ng)
            mat = torch.where(on, s["material"], mat)
            med = torch.where(on[:, None], torch.as_tensor(
                s["medium"], device=dev), med)
        self.ng = ng
        self.ns = ng
        self.mat = torch.where(found, mat, -1)
        self.light = light & found
        self.medium = med          # (inside, outside) of the surface hit
        self.wo = -normalize(d)


# ------------------------------------------------------------------ BSDFs

def frame(n):
    """(s, t) about unit n (Duff et al.'s branchless frame)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    s = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b,
                     -sign * n[:, 0]], -1)
    t = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return s, t


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance between 1 and eta."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    one = torch.ones_like(eta)
    ei = torch.where(entering, one, eta)
    et = torch.where(entering, eta, one)
    ci = torch.abs(cos_i)
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=1e-14))
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=1e-14))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-9)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-9)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, torch.ones_like(f), f)


def ggx_d(wh, a):
    cos2 = wh[:, 2] ** 2
    e = (wh[:, 0] ** 2 + wh[:, 1] ** 2) / torch.clamp(a * a, min=1e-12) \
        + cos2
    return 1.0 / torch.clamp(PI * a * a * e * e, min=1e-12)


def ggx_lambda(w, a):
    c2 = w[:, 2] ** 2
    tan2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    # isotropic: the azimuth drops out
    return 0.5 * (-1.0 + torch.sqrt(1.0 + a * a * tan2))


def ggx_sample_wh(wo, u1, u2, a):
    """Visible-normal sample of isotropic GGX (Heitz 2018)."""
    flip = wo[:, 2] < 0
    w = torch.where(flip[:, None], -wo, wo)
    vh = normalize(torch.stack([a * w[:, 0], a * w[:, 1], w[:, 2]], -1))
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where((lensq > 1e-20)[:, None], torch.stack(
        [-vh[:, 1] * inv, vh[:, 0] * inv, torch.zeros_like(inv)], -1),
        torch.tensor([1.0, 0.0, 0.0], dtype=wo.dtype, device=wo.device))
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-14)) \
        + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-14))
    nh = p1[:, None] * t1 + p2[:, None] * t2 + pz[:, None] * vh
    wh = normalize(torch.stack([a * nh[:, 0], a * nh[:, 1],
                                torch.clamp(nh[:, 2], min=1e-6)], -1))
    return torch.where(flip[:, None], -wh, wh)


def _half(wo, wi):
    wh = wo + wi
    ln = torch.sqrt(dot(wh, wh) + 1e-12)
    ok = ln > 1e-5
    z = torch.tensor([0.0, 0.0, 1.0], dtype=wo.dtype, device=wo.device)
    return torch.where(ok[:, None], wh / torch.clamp(ln, min=1e-6)[:, None],
                       z), ok


def bsdf_f(kind, kd, ks, a, eta, wo, wi):
    """f(wo, wi) of matte and plastic in the shading frame; 0 for the
    specular materials."""
    co, ci = torch.abs(wo[:, 2]), torch.abs(wi[:, 2])
    refl = wo[:, 2] * wi[:, 2] > 0
    glossy = kind == scn.PLASTIC
    diffuse = (kind == scn.MATTE) | glossy
    valid = (co > 1e-6) & (ci > 1e-6) & diffuse
    f = torch.where((diffuse & refl)[:, None], kd / PI, torch.zeros_like(kd))
    wh, wh_ok = _half(wo, wi)
    F = fresnel_dielectric(dot(wi, wh), eta)
    G = 1.0 / (1.0 + ggx_lambda(wo, a) + ggx_lambda(wi, a))
    spec_ = ks * (F * ggx_d(wh, a) * G / torch.clamp(4 * co * ci, min=1e-9)
                  )[:, None]
    ok = glossy & (co > 1e-6) & (ci > 1e-6) & wh_ok & refl
    f = f + torch.where(ok[:, None], spec_, torch.zeros_like(spec_))
    return torch.where(valid[:, None], f, torch.zeros_like(f))


def bsdf_pdf(kind, a, wo, wi):
    refl = wo[:, 2] * wi[:, 2] > 0
    pdf_diff = torch.where(refl, torch.abs(wi[:, 2]) / PI,
                           torch.zeros_like(a))
    wh, wh_ok = _half(wo, wi)
    G1 = 1.0 / (1.0 + ggx_lambda(wo, a))
    pdf_wh = ggx_d(wh, a) * G1 * torch.abs(dot(wo, wh)) / torch.clamp(
        torch.abs(wo[:, 2]), min=1e-9)
    pdf_ggx = torch.where(refl & wh_ok, pdf_wh / torch.clamp(
        4 * torch.abs(dot(wo, wh)), min=1e-9), torch.zeros_like(a))
    pdf = torch.where(kind == scn.MATTE, pdf_diff,
                      torch.where(kind == scn.PLASTIC,
                                  0.5 * (pdf_diff + pdf_ggx),
                                  torch.zeros_like(a)))
    return pdf


def cosine_hemisphere(u1, u2):
    ox, oy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    zero = (ox == 0) & (oy == 0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    theta = torch.where(use_x, (PI / 4) * (oy / torch.where(ox == 0, one, ox)),
                        PI / 2 - (PI / 4) * (ox / torch.where(oy == 0, one,
                                                                oy)))
    x = torch.where(zero, torch.zeros_like(r), r * torch.cos(theta))
    y = torch.where(zero, torch.zeros_like(r), r * torch.sin(theta))
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=1e-14))
    return torch.stack([x, y, z], -1)


def bsdf_sample(kind, kd, ks, kr, kt, a, eta, wo, u_lobe, u1, u2):
    """(wi, f, pdf, specular, transmitted, eta factor) in the frame."""
    sgn = torch.sign(wo[:, 2:3])
    one = torch.ones_like(sgn)
    wi_diff = cosine_hemisphere(u1, u2) * torch.cat([one, one, sgn], -1)
    wh = ggx_sample_wh(wo, u1, u2, torch.clamp(a, min=1e-4))
    wi_ggx = -wo + 2.0 * dot(wo, wh)[:, None] * wh
    pick_spec = (kind == scn.PLASTIC) & (u_lobe >= 0.5)
    wi = torch.where(pick_spec[:, None], wi_ggx, wi_diff)
    wi_mirror = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    is_mirror = kind == scn.MIRROR
    is_glass = kind == scn.GLASS
    wi = torch.where(is_mirror[:, None], wi_mirror, wi)
    entering = wo[:, 2] > 0
    F = fresnel_dielectric(wo[:, 2], eta)
    eta_ratio = torch.where(entering, 1.0 / eta, eta)
    # refraction about the normal on wo's side
    cos_i = torch.abs(wo[:, 2])
    sin2_t = eta_ratio * eta_ratio * torch.clamp(1.0 - cos_i * cos_i,
                                                 min=0.0)
    can_refract = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-14))
    n_side = torch.cat([torch.zeros_like(sgn), torch.zeros_like(sgn), sgn],
                       -1)
    wi_t = eta_ratio[:, None] * -wo + (eta_ratio * cos_i - cos_t)[:, None] \
        * n_side
    do_reflect = (u_lobe < F) | ~can_refract
    wi = torch.where(is_glass[:, None], torch.where(
        do_reflect[:, None], wi_mirror, wi_t), wi)
    wi = normalize(wi)
    f = bsdf_f(kind, kd, ks, a, eta, wo, wi)
    pdf = bsdf_pdf(kind, a, wo, wi)
    abs_ci = torch.clamp(torch.abs(wi[:, 2]), min=1e-9)[:, None]
    f = torch.where(is_mirror[:, None], kr / abs_ci, f)
    pdf = torch.where(is_mirror, torch.ones_like(pdf), pdf)
    f_glass = torch.where(do_reflect[:, None], F[:, None] / abs_ci * kr,
                          ((1.0 - F) * eta_ratio * eta_ratio)[:, None]
                          / abs_ci * kt)
    pdf_glass = torch.where(do_reflect, torch.where(can_refract, F,
                                                    torch.ones_like(F)),
                            1.0 - F)
    f = torch.where(is_glass[:, None], f_glass, f)
    pdf = torch.where(is_glass, pdf_glass, pdf)
    specular = is_mirror | is_glass
    transmitted = is_glass & ~do_reflect
    eta_fac = torch.where(transmitted, torch.where(entering, eta * eta,
                                                   1.0 / (eta * eta)),
                          torch.ones_like(eta))
    return wi, f, pdf, specular, transmitted, eta_fac


# ----------------------------------------------------------------- lights

def sample_light(T: Tables, p, u1, u2):
    """A point on the area light by area: (wi, Li, pdf, dist)."""
    cdf = T.light_cdf
    n = T.n_light_tris
    ti = torch.clamp((cdf[None, :] <= u1[:, None]).sum(-1) - 1, 0, n - 1)
    c0, c1 = cdf[ti], cdf[ti + 1]
    u1r = torch.clamp((u1 - c0) / torch.clamp(c1 - c0, min=1e-9), 0.0,
                      0.999999)
    su = torch.sqrt(torch.clamp(u1r, min=1e-14))
    q = T.light_v0[ti] + (1.0 - su)[:, None] * T.light_e1[ti] \
        + (u2 * su)[:, None] * T.light_e2[ti]
    to_q = q - p
    d2 = torch.clamp(dot(to_q, to_q), min=1e-12)
    dist = torch.sqrt(d2)
    wi = to_q / dist[:, None]
    cos_l = dot(T.light_n[ti], -wi)
    pdf = d2 / torch.clamp(torch.abs(cos_l) * T.light_area, min=1e-9)
    li = torch.where((T.sc.light_two_sided | (cos_l > 0))[:, None],
                     T.light_L[None, :],
                     torch.zeros_like(T.light_L)[None, :])
    return wi, li, pdf, dist


def light_pdf(T: Tables, t, wi, ng):
    """The solid-angle pdf with which NEE samples a light point hit at
    distance t along unit wi, with normal ng."""
    return t * t / torch.clamp(torch.abs(dot(ng, -wi)) * T.light_area,
                               min=1e-9)


def emitted(T: Tables, hit: Hit):
    facing = T.sc.light_two_sided | (dot(hit.ng, hit.wo) > 0)
    return torch.where((hit.light & facing)[:, None], T.light_L[None, :],
                       torch.zeros_like(T.light_L)[None, :])


def spawn(p, ng, w):
    """A ray origin off the surface on w's side (see the module note)."""
    scale = torch.clamp(torch.abs(p).amax(-1), min=1.0)
    eps = (1e-4 * scale)[:, None]
    return p + torch.where(dot(w, ng)[:, None] >= 0, eps, -eps) * ng


def power(a, b):
    return a * a / torch.clamp(a * a + b * b, min=1e-20)


class Surface:
    """A hit's material record and shading frame (the shading normal and
    Duff et al.'s tangents), with its BSDF in that frame."""

    def __init__(self, T: Tables, hit: Hit):
        m = torch.clamp(hit.mat, min=0)
        self.kind = torch.where(hit.mat >= 0, T.mat_kind[m], -1)
        self.kd, self.ks, self.kr, self.kt = T.kd[m], T.ks[m], T.kr[m], \
            T.kt[m]
        self.a, self.eta = T.alpha[m], T.eta[m]
        self.n = hit.ns
        self.s, self.t = frame(hit.ns)
        self.wo = self.local(hit.wo)

    def local(self, w):
        return torch.stack([dot(w, self.s), dot(w, self.t), dot(w, self.n)],
                           -1)

    def world(self, w):
        return w[:, 0:1] * self.s + w[:, 1:2] * self.t + w[:, 2:3] * self.n

    def f(self, wi):
        """f(wo, wi) |cos| toward the world direction wi."""
        return bsdf_f(self.kind, self.kd, self.ks, self.a, self.eta,
                      self.wo, self.local(wi)) * \
            torch.abs(dot(wi, self.n))[:, None]

    def pdf(self, wi):
        return bsdf_pdf(self.kind, self.a, self.wo, self.local(wi))

    def sample(self, u_lobe, u1, u2):
        """(world wi, f, pdf, specular, transmitted, eta factor)."""
        wi, f, pdf, spec_, trans, eta_fac = bsdf_sample(
            self.kind, self.kd, self.ks, self.kr, self.kt, self.a, self.eta,
            self.wo, u_lobe, u1, u2)
        return self.world(wi), f, pdf, spec_, trans, eta_fac


# ------------------------------------------------------------ the estimator

def trace(T: Tables, pixel, index, seed, W, H, max_depth):
    """Radiance [B,31] of camera samples (pixel, index) under `seed`."""
    dt, dev = T.dt, T.dev
    sc = T.sc
    B = pixel.shape[0]

    def sdim(d):
        return sampler.sample(pixel, index, d, seed, dt)

    def bdim(b, k):
        return sdim(DIM_BOUNCE + b * DIMS_PER_BOUNCE + k)

    o, d = camera_rays(sc, W, H, pixel, index, seed, dt, dev)
    tmax = torch.full((B,), float("inf"), dtype=dt, device=dev)
    L = torch.zeros((B, 31), dtype=dt, device=dev)
    beta = torch.ones_like(L)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    specular = torch.ones_like(alive)
    prev_pdf = torch.ones(B, dtype=dt, device=dev)
    eta_scale = torch.ones(B, dtype=dt, device=dev)
    hit = Hit(o, d, *intersect(o, d, tmax, T), T)
    for bounce in range(max_depth + 1):
        dn = normalize(d)
        le = emitted(T, hit)
        if bounce == 0:
            w_hit = torch.ones(B, dtype=dt, device=dev)
        else:
            w_hit = torch.where(specular, torch.ones_like(prev_pdf), power(
                prev_pdf, light_pdf(T, hit.t, dn, hit.ng)))
        L = L + torch.where((alive & hit.valid)[:, None],
                            beta * le * w_hit[:, None], torch.zeros_like(L))
        alive = alive & hit.valid
        if bounce == max_depth:
            break
        surf = Surface(T, hit)
        # NEE toward the area light
        wi, li, pdf_l, dist = sample_light(T, hit.p, bdim(bounce, 1),
                                           bdim(bounce, 2))
        f = surf.f(wi)
        cand = alive & (pdf_l > 1e-12) & (li != 0).any(-1) & (f != 0).any(-1)
        so = spawn(hit.p, hit.ng, wi)
        s_tmax = torch.where(cand, (dist - dot(so - hit.p, wi)) * 0.999,
                             -torch.ones_like(dist))
        w_l = power(pdf_l, surf.pdf(wi))
        contrib = beta * f * li * (w_l / torch.clamp(pdf_l, min=1e-12)
                                   )[:, None]
        # BSDF sampling
        wi_w, fs, pdf, spec_, _, eta_fac = surf.sample(
            bdim(bounce, 3), bdim(bounce, 4), bdim(bounce, 5))
        cos_t = torch.abs(dot(wi_w, hit.ns))
        ok = (pdf > 1e-12) & (fs != 0).any(-1)
        beta_new = beta * fs * (cos_t / torch.clamp(pdf, min=1e-12))[:, None]
        alive = alive & ok
        beta = torch.where(alive[:, None], beta_new, beta)
        eta_scale = eta_scale * torch.where(alive, eta_fac,
                                            torch.ones_like(eta_fac))
        specular = spec_
        prev_pdf = pdf
        o = spawn(hit.p, hit.ng, wi_w)
        d = wi_w
        if bounce > 3:
            # the roulette is sampling: no gradient through q
            rr = (beta.amax(-1) * eta_scale).detach()
            q = torch.clamp(1.0 - rr, 0.05, 0.99)
            apply = rr < 1.0
            alive = alive & ~(apply & (bdim(bounce, 6) < q))
            beta = beta * torch.where(apply & alive, 1.0 / (1.0 - q),
                                      torch.ones_like(q))[:, None]
        tmax = torch.where(alive, torch.full_like(tmax, float("inf")),
                           -torch.ones_like(tmax))
        occ = occluded(so, wi, s_tmax, T)
        hit = Hit(o, d, *intersect(o, d, tmax, T), T)
        L = L + torch.where((cand & ~occ)[:, None], contrib,
                            torch.zeros_like(contrib))
    L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
    return torch.maximum(L, torch.zeros((), dtype=dt, device=dev))


FILTER_TABLE_WIDTH = 16     # pbrt-v3's filter table, a box filter's 1s


def film_lanes(pixels, counts_of, seed, W, H, dtype=torch.float32):
    """The samples that land in each of `pixels` [N] (int64 ids) on a
    film with pbrt-v3's box filter of radius 0.5: a sample's film point
    is the float32 sum of its pixel's corner and its jitter (dims 0-1),
    so a jitter within an ulp of 1 rounds into the next pixel.  Returns
    (rows, q, index, raw_keep, weight [N]): each candidate lane's row,
    its own pixel and sample index, whether its raw sum lands in the
    row's pixel (the pixel floor(film point) names), and each row's
    summed filter weight.  counts_of(q) gives pixel q's sample count."""
    dev = pixels.device
    x, y = pixels % W, pixels // W
    rows, qs = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        r = torch.nonzero((x >= dx) & (y >= dy))[:, 0]
        rows.append(r)
        qs.append(pixels[r] - dx - dy * W)
    rows, qs = torch.cat(rows), torch.cat(qs)
    c = counts_of(qs)
    lane_row = torch.repeat_interleave(rows, c)
    lane_q = torch.repeat_interleave(qs, c)
    first = torch.cumsum(c, 0) - c
    index = torch.arange(lane_row.shape[0], device=dev) - \
        torch.repeat_interleave(first, c)
    fx = (lane_q % W).to(dtype) + sampler.sample(lane_q, index, 0, seed,
                                                 dtype)
    fy = (lane_q // W).to(dtype) + sampler.sample(lane_q, index, 1, seed,
                                                  dtype)
    target = pixels[lane_row]
    raw_pix = (torch.clamp(fy.long(), 0, H - 1) * W
               + torch.clamp(fx.long(), 0, W - 1))
    # the film's filter footprint: the pixel at ceil(p - 0.5 - r), weight
    # 1 inside the table's extent
    px, py = fx - 0.5, fy - 0.5
    x0 = torch.ceil(px - 0.5).long()
    y0 = torch.ceil(py - 0.5).long()
    inb = ((x0 >= 0) & (x0 < W) & (y0 >= 0) & (y0 < H)
           & (torch.abs(x0.to(px.dtype) - px) * (2 * FILTER_TABLE_WIDTH)
              < FILTER_TABLE_WIDTH)
           & (torch.abs(y0.to(py.dtype) - py) * (2 * FILTER_TABLE_WIDTH)
              < FILTER_TABLE_WIDTH))
    w_keep = inb & (y0 * W + x0 == target)
    weight = torch.zeros(pixels.shape[0], dtype=torch.float32, device=dev)
    weight.index_add_(0, lane_row[w_keep],
                      torch.ones(int(w_keep.sum()), device=dev))
    return lane_row, lane_q, index, raw_pix == target, weight


def render_film(T: Tables, pixels, counts_of, seed, W, H, max_depth,
                integrator="path", lanes=1 << 17):
    """(raw [N,31], weight [N]): the film's unweighted sums and filter
    weights at pixels [N] after each pixel q's samples
    0..counts_of(q)-1 under the sampler seed, accumulated in float32."""
    if integrator == "path":
        fn = trace
    elif integrator == "volpath":
        from benchmark.reference import volpath
        media = volpath.Media(T)

        def fn(T, *args):
            return volpath.trace(T, media, *args)
    else:
        raise NotImplementedError(f"the {integrator} reference")
    N = pixels.shape[0]
    rows, qs, index, keep, weight = film_lanes(pixels, counts_of, seed, W, H,
                                               T.dt)
    rows, qs, index = rows[keep], qs[keep], index[keep]
    out = torch.zeros((N, 31), dtype=torch.float32, device=T.dev)
    for s in range(0, rows.shape[0], lanes):
        L = fn(T, qs[s:s + lanes], index[s:s + lanes], seed, W, H, max_depth)
        out.index_add_(0, rows[s:s + lanes], L.to(torch.float32))
    return out, weight
