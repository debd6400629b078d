"""The plain reference of the port's volumetric path estimator on a
scene whose media are bound to shapes (MediumInterface), such as the
smoke in a glass sphere: the bounce loop of `path.py` with a free flight
through each lane's current medium, in plain PyTorch.

What it computes, beside path.py's estimator:
- each lane carries its medium, the camera's at first; crossing a
  transmissive surface takes the surface's inside medium when the new
  direction goes against the outward normal, else its outside one;
- in a density grid the free flight is delta tracking with the majorant
  max(sigma_t) / max(density), at most 32 steps, each step's two
  uniforms drawn from counters (pixel, sample, salt), salts 0x9008 +
  256 a bounce; an event scatters with weight sigma_s / majorant and
  samples Henyey-Greenstein about the direction of travel with the
  bounce's BSDF uniforms; the density is trilinear over voxel centres;
- NEE from a medium vertex weighs the phase function's value, which is
  also its pdf, and the shadow ray walks up to 8 surfaces: a surface
  with a material blocks, a material-less one is crossed into its
  medium, and each sub-segment in a grid multiplies in its ratio-tracked
  transmittance (salts 0x9040 + 256 a bounce + 64 a crossing);
- Russian roulette on max(beta) alone.
Only density-grid media are read (a homogeneous medium raises).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import path as P
from benchmark.reference import sampler

SALT_BASE = 0x9000
SALT_STRIDE = 256
TRACK_STEPS = 32
CROSSINGS = 8


class Media:
    """The scene's grids on a device."""

    def __init__(self, T: P.Tables):
        sc = T.sc
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa
                                      dtype=T.dt, device=T.dev)
        if not sc.media:
            raise NotImplementedError("a volpath scene without media")
        self.sigma_a = f(np.stack([m.sigma_a.astype(np.float32)
                                   for m in sc.media]))
        self.sigma_s = f(np.stack([m.sigma_s.astype(np.float32)
                                   for m in sc.media]))
        self.g = f([m.g for m in sc.media])
        self.grids = [f(m.density.astype(np.float32)) for m in sc.media]
        self.w2m = [f(m.world_to_medium.astype(np.float32))
                    for m in sc.media]
        self.inv_maxd = [1.0 / max(float(m.density.astype(np.float32).max()),
                                   1e-9) for m in sc.media]
        self.world_radius = T.world_radius


def _span(om, dm, tmax):
    one = torch.full_like(dm, 1e-12)
    inv = 1.0 / torch.where(torch.abs(dm) > 1e-12, dm, one)
    t0 = -om * inv
    t1 = (1.0 - om) * inv
    tlo = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    thi = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax)
    return tlo, thi, thi > tlo


def _density(grid, p):
    nz, ny, nx = grid.shape
    gx = p[:, 0] * nx - 0.5
    gy = p[:, 1] * ny - 0.5
    gz = p[:, 2] * nz - 0.5
    ix, iy, iz = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx, fy, fz = gx - ix, gy - iy, gz - iz
    ix, iy, iz = ix.long(), iy.long(), iz.long()
    acc = torch.zeros_like(gx)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                inb = ((jx >= 0) & (jy >= 0) & (jz >= 0) & (jx < nx)
                       & (jy < ny) & (jz < nz))
                w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz))
                v = grid[jz.clamp(0, nz - 1), jy.clamp(0, ny - 1),
                         jx.clamp(0, nx - 1)]
                acc = acc + torch.where(inb, w * v, torch.zeros_like(w))
    return acc


def _to_medium(w, o, d):
    return o @ w[:3, :3].T + w[:3, 3], d @ w[:3, :3].T


def delta_track(M, k, o, d, tmax, st, pixel, index, salt):
    """Free flight in grid k: (t, scattered)."""
    om, dm = _to_medium(M.w2m[k], o, d)
    t, thi, live = _span(om, dm, tmax)
    st = torch.clamp(st, min=1e-9)
    imd = M.inv_maxd[k]
    hit = torch.zeros_like(live)
    for s in range(TRACK_STEPS):
        u1 = sampler.uniform(pixel, index, salt + 2 * s, o.dtype)
        u2 = sampler.uniform(pixel, index, salt + 2 * s + 1, o.dtype)
        t_new = t - torch.log(torch.clamp(1 - u1, min=1e-9)) * imd / st
        esc = t_new >= thi
        real = u2 < _density(M.grids[k], om + t_new[:, None] * dm) * imd
        hit = hit | (live & ~esc & real)
        t = torch.where(live & ~esc, t_new, t)
        live = live & ~esc & ~real
    return torch.where(hit, t, tmax), hit


def ratio_track(M, k, o, d, tmax, st, pixel, index, salt):
    """Ratio-tracked transmittance through grid k over [0, tmax]."""
    om, dm = _to_medium(M.w2m[k], o, d)
    t, thi, live = _span(om, dm, tmax)
    st = torch.clamp(st, min=1e-9)
    imd = M.inv_maxd[k]
    tr = torch.ones_like(t)
    for s in range(TRACK_STEPS):
        u1 = sampler.uniform(pixel, index, salt + 2 * s, o.dtype)
        t_new = t - torch.log(torch.clamp(1 - u1, min=1e-9)) * imd / st
        esc = t_new >= thi
        ratio = 1.0 - _density(M.grids[k], om + t_new[:, None] * dm) * imd
        step = live & ~esc
        tr = torch.where(step, tr * torch.clamp(ratio, min=0.0), tr)
        t = torch.where(step, t_new, t)
        live = step & (tr > 1e-5)
    return tr


def hg_p(g, cos_t):
    denom = 1 + g * g + 2 * g * cos_t
    return (1 - g * g) / (4 * math.pi * denom
                          * torch.sqrt(torch.clamp(denom, min=1e-9)))


def hg_sample(g, d, u1, u2):
    """A direction about the direction of travel d, and its pdf."""
    sq = (1 - g * g) / torch.clamp(1 - g + 2 * g * u1, min=1e-6)
    small = torch.abs(g) < 1e-3
    gg = torch.where(small, torch.ones_like(g), g)
    cos_t = torch.where(small, 1 - 2 * u1, (1 + g * g - sq * sq) / (2 * gg))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0.0))
    phi = 2 * math.pi * u2
    v1, v2 = P.frame(d)
    wi = ((sin_t * torch.cos(phi))[:, None] * v1
          + (sin_t * torch.sin(phi))[:, None] * v2 + cos_t[:, None] * d)
    return P.normalize(wi), hg_p(g, cos_t)


def shadow_walk(T, M, org, wi, dist, cand, med, pixel, index, salt):
    """(blocked, transmittance [B]) of shadow rays across interfaces."""
    B = org.shape[0]
    remaining = torch.where(torch.isfinite(dist), dist,
                            torch.full_like(dist, 2 * M.world_radius))
    act = cand
    blocked = torch.zeros(B, dtype=torch.bool, device=org.device)
    tr = torch.ones_like(dist)
    p = org
    for c in range(CROSSINGS):
        tmax = torch.where(act, remaining, -torch.ones_like(remaining))
        found, t, i_tri, i_sph = P.intersect(p, wi, tmax, T)
        seg = torch.where(found, t, remaining)
        for k in range(len(M.grids)):
            lanes = act & (med == k)
            st = (M.sigma_a[k] + M.sigma_s[k]).amax(-1).expand(B)
            trk = ratio_track(M, k, p, wi, torch.where(
                lanes, torch.clamp(seg, min=0.0), torch.zeros_like(seg)),
                st, pixel, index, salt + 64 * c)
            tr = torch.where(lanes, tr * trk, tr)
        # every surface of these scenes has a material: it blocks
        blocked = blocked | (act & found)
        adv = seg + 1e-4 * torch.clamp(torch.abs(seg), min=1e-3)
        p = torch.where(act[:, None], p + adv[:, None] * wi, p)
        remaining = remaining - adv
        act = torch.zeros_like(act)
    return blocked, tr


def trace(T: P.Tables, M: Media, pixel, index, seed, W, H, max_depth):
    """Radiance [B,31] of camera samples through the scene's media."""
    dt, dev = T.dt, T.dev
    sc = T.sc
    B = pixel.shape[0]

    def bdim(b, k):
        return sampler.sample(pixel, index,
                              P.DIM_BOUNCE + b * P.DIMS_PER_BOUNCE + k,
                              seed, dt)

    o, d = P.camera_rays(sc, W, H, pixel, index, seed, dt, dev)
    tmax = torch.full((B,), float("inf"), dtype=dt, device=dev)
    L = torch.zeros((B, 31), dtype=dt, device=dev)
    beta = torch.ones_like(L)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    specular = torch.ones_like(alive)
    prev_pdf = torch.ones(B, dtype=dt, device=dev)
    med = torch.full((B,), sc.camera_medium, dtype=torch.int64, device=dev)
    zero31 = torch.zeros((1, 31), dtype=dt, device=dev)
    for bounce in range(max_depth + 1):
        found, t, i_tri, i_sph = P.intersect(o, d, tmax, T)
        hit = P.Hit(o, d, found, t, i_tri, i_sph, T)
        dn = P.normalize(d)
        t_seg = torch.where(hit.valid, hit.t, torch.clamp(
            tmax, max=2 * M.world_radius))
        t_seg = torch.clamp(t_seg, min=0.0)
        salt = SALT_BASE + bounce * SALT_STRIDE
        # the free flight: vacuum lanes pass, grid lanes delta-track
        t_m = t_seg
        in_med = torch.zeros_like(alive)
        w_med = torch.ones_like(L)
        g_eff = torch.zeros(B, dtype=dt, device=dev)
        for k in range(len(M.grids)):
            lanes = med == k
            st = (M.sigma_a[k] + M.sigma_s[k]).amax(-1).expand(B)
            tk, hk = delta_track(M, k, o, dn, torch.where(
                lanes, t_seg, torch.zeros_like(t_seg)), st, pixel, index,
                salt + 8)
            wk = torch.where(hk[:, None], (M.sigma_s[k] / torch.clamp(
                st[:1], min=1e-9))[None, :].expand(B, 31),
                torch.ones_like(L))
            t_m = torch.where(lanes, tk, t_m)
            in_med = torch.where(lanes, hk, in_med)
            w_med = torch.where(lanes[:, None], wk, w_med)
            g_eff = torch.where(lanes, M.g[k], g_eff)
        in_med = in_med & alive
        beta = beta * torch.where(alive[:, None], w_med, torch.ones_like(L))
        le = P.emitted(T, hit)
        if bounce == 0:
            w_hit = torch.ones(B, dtype=dt, device=dev)
        else:
            w_hit = torch.where(specular, torch.ones_like(prev_pdf), P.power(
                prev_pdf, P.light_pdf(T, hit.t, dn, hit.ng)))
        L = L + torch.where((alive & ~in_med & hit.valid)[:, None],
                            beta * le * w_hit[:, None], torch.zeros_like(L))
        alive = alive & (hit.valid | in_med)
        if bounce == max_depth:
            break
        p_med = o + t_m[:, None] * dn
        p_vert = torch.where(in_med[:, None], p_med, hit.p)
        surf = P.Surface(T, hit)
        wi, li, pdf_l, dist = P.sample_light(T, p_vert, bdim(bounce, 1),
                                             bdim(bounce, 2))
        f_surf = surf.f(wi)
        ph = hg_p(g_eff, P.dot(-dn, wi))
        f = torch.where(in_med[:, None], ph[:, None].expand(B, 31), f_surf)
        pdf_b = torch.where(in_med, ph, surf.pdf(wi))
        cand = alive & (pdf_l > 1e-12) & (li != 0).any(-1) & \
            (f != 0).any(-1)
        sp_n = torch.where(in_med[:, None], wi, hit.ng)
        so = P.spawn(p_vert, sp_n, wi)
        occ, tr = shadow_walk(T, M, so, wi,
                              (dist - P.dot(so - p_vert, wi)) * 0.999,
                              cand, med, pixel, index, salt + 64)
        w_l = P.power(pdf_l, pdf_b)
        contrib = beta * f * li * tr[:, None] * (
            w_l / torch.clamp(pdf_l, min=1e-12))[:, None]
        L = L + torch.where((cand & ~occ)[:, None], contrib,
                            torch.zeros_like(contrib))
        ub1, ub2 = bdim(bounce, 4), bdim(bounce, 5)
        wi_surf, f_s, pdf_s, spec_, transmitted, _ = surf.sample(
            bdim(bounce, 3), ub1, ub2)
        cos_t = torch.abs(P.dot(wi_surf, hit.ns))
        ok_s = (pdf_s > 1e-12) & (f_s != 0).any(-1)
        beta_s = f_s * (cos_t / torch.clamp(pdf_s, min=1e-12))[:, None]
        wi_med, ph_pdf = hg_sample(g_eff, dn, ub1, ub2)
        wi_new = torch.where(in_med[:, None], wi_med, wi_surf)
        alive = alive & (in_med | ok_s)
        beta = torch.where(alive[:, None], beta * torch.where(
            in_med[:, None], torch.ones_like(beta_s), beta_s), beta)
        specular = ~in_med & spec_
        prev_pdf = torch.where(in_med, ph_pdf, pdf_s)
        o = P.spawn(p_vert, torch.where(in_med[:, None], wi_new, hit.ng),
                    wi_new)
        d = wi_new
        tmax = torch.where(alive, torch.full_like(tmax, float("inf")),
                           -torch.ones_like(tmax))
        entering = P.dot(wi_new, hit.ng) < 0
        new_med = torch.where(entering, hit.medium[:, 0], hit.medium[:, 1])
        crossed = alive & ~in_med & hit.valid & transmitted
        med = torch.where(crossed, new_med, med)
        if bounce > 3:
            rr = beta.amax(-1).detach()
            q = torch.clamp(1.0 - rr, 0.05, 0.99)
            apply = rr < 1.0
            alive = alive & ~(apply & (bdim(bounce, 6) < q))
            beta = beta * torch.where(apply & alive, 1.0 / (1.0 - q),
                                      torch.ones_like(q))[:, None]
            tmax = torch.where(alive, tmax, -torch.ones_like(tmax))
    L = torch.where(torch.isfinite(L), L, zero31.expand_as(L))
    return torch.clamp(L, min=0.0)
