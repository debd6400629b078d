"""The plain reference of the port's stochastic progressive photon
mapping (SPPM), in plain PyTorch, for a sample of pixels: their camera
paths and visible points, every photon of each iteration, the gather of
those photons at the sampled pixels' visible points, and the per-pixel
radius and flux update.

What it computes (pbrt-v3 sppm.cpp's estimator, with the port's
choices written out):
- a camera path follows specular lobes to its first matte or plastic
  vertex, the visible point, which keeps beta kd / pi; emission counts
  whole and NEE runs at every vertex up to the visible point, without
  MIS;
- an iteration emits W * H photons, ids from 0x50000000 at the
  iteration's sample index, cosine-weighted from a point of the area
  light drawn by area (dims 1-4); each bounce samples the BSDF with dims
  8 + 4 b .. 10 + 4 b, then roulette with q = clamp(1 - max(beta), 0,
  0.95) on dim 11 + 4 b, beta / max(1 - q, 0.05); a photon deposits at
  every visible point within the point's radius from its second hit on;
- the radius shrinks as r sqrt((N + 2/3 M) / (N + M)) and the flux
  scales by the squared ratio; L = mean(Ld) + tau / (photons pi r^2).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import path as P
from benchmark.reference import sampler
from benchmark.reference import scene as scn

ALPHA = 2.0 / 3.0
PHOTON_ID_BASE = 0x50000000
CHUNK = 8192


def camera_pass(T, pixels, it, seed, W, H, depth):
    dt, dev = T.dt, T.dev
    B = pixels.shape[0]
    index = torch.full_like(pixels, it)

    def bdim(b, k):
        return sampler.sample(pixels, index,
                              P.DIM_BOUNCE + b * P.DIMS_PER_BOUNCE + k,
                              seed, dt)

    o, d = P.camera_rays(T.sc, W, H, pixels, index, seed, dt, dev)
    tmax = torch.full((B,), float("inf"), dtype=dt, device=dev)
    Ld = torch.zeros((B, 31), dtype=dt, device=dev)
    beta = torch.ones_like(Ld)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    vp_p = torch.zeros((B, 3), dtype=dt, device=dev)
    vp_f = torch.zeros_like(Ld)
    found_vp = torch.zeros_like(alive)
    for bounce in range(depth + 1):
        hit = P.Hit(o, d, *P.intersect(o, d, tmax, T), T)
        Ld = Ld + torch.where((alive & hit.valid)[:, None],
                              beta * P.emitted(T, hit), torch.zeros_like(Ld))
        alive = alive & hit.valid
        if bounce == depth:
            break
        surf = P.Surface(T, hit)
        diffuse = (surf.kind == scn.MATTE) | (surf.kind == scn.PLASTIC)
        record = alive & diffuse & ~found_vp
        vp_p = torch.where(record[:, None], hit.p, vp_p)
        vp_f = torch.where(record[:, None], beta * surf.kd / math.pi, vp_f)
        found_vp = found_vp | record
        wi, li, pdf_l, dist = P.sample_light(T, hit.p, bdim(bounce, 1),
                                             bdim(bounce, 2))
        f = surf.f(wi)
        cand = alive & (pdf_l > 1e-12) & (li != 0).any(-1) & \
            (f != 0).any(-1)
        so = P.spawn(hit.p, hit.ng, wi)
        s_tmax = torch.where(cand, (dist - P.dot(so - hit.p, wi)) * 0.999,
                             -torch.ones_like(dist))
        occ = P.occluded(so, wi, s_tmax, T)
        Ld = Ld + torch.where((cand & ~occ)[:, None], beta * f * li / (
            torch.clamp(pdf_l, min=1e-12))[:, None], torch.zeros_like(Ld))
        wi_w, f_s, pdf_s, spec_, _, _ = surf.sample(
            bdim(bounce, 3), bdim(bounce, 4), bdim(bounce, 5))
        cont = alive & spec_ & ~found_vp & (pdf_s > 1e-12)
        beta = torch.where(cont[:, None], beta * f_s * (
            torch.abs(P.dot(wi_w, hit.ns)) / torch.clamp(pdf_s, min=1e-12)
        )[:, None], beta)
        alive = cont
        o = P.spawn(hit.p, hit.ng, wi_w)
        d = wi_w
        tmax = torch.where(alive, torch.full_like(tmax, float("inf")),
                           -torch.ones_like(tmax))
    return Ld, vp_p, vp_f, found_vp


def photon_pass(T, it, n_photons, seed, depth, vp_p, vp_valid, radius):
    """(tau_add [N,31], M [N]) of one iteration's photons at the visible
    points."""
    dt, dev = T.dt, T.dev
    N = vp_p.shape[0]
    tau_add = torch.zeros((N, 31), dtype=torch.float32, device=dev)
    M = torch.zeros(N, dtype=torch.float32, device=dev)
    r2 = radius * radius
    for c0 in range(0, n_photons, 1 << 16):
        pid = torch.arange(c0, min(c0 + (1 << 16), n_photons),
                           dtype=torch.int64, device=dev) + PHOTON_ID_BASE
        index = torch.full_like(pid, it)

        def sdim(k):
            return sampler.sample(pid, index, k, seed, dt)
        cdf = T.light_cdf
        n = T.n_light_tris
        u1, u2 = sdim(1), sdim(2)
        ti = torch.clamp((cdf[None, :] <= u1[:, None]).sum(-1) - 1, 0, n - 1)
        u1r = torch.clamp((u1 - cdf[ti]) / torch.clamp(
            cdf[ti + 1] - cdf[ti], min=1e-9), 0.0, 0.999999)
        su = torch.sqrt(torch.clamp(u1r, min=1e-14))
        o = T.light_v0[ti] + (1.0 - su)[:, None] * T.light_e1[ti] + \
            (u2 * su)[:, None] * T.light_e2[ti]
        n_l = T.light_n[ti]
        t1, t2 = P.frame(n_l)
        dl = P.cosine_hemisphere(sdim(3), sdim(4))
        d = dl[:, 0:1] * t1 + dl[:, 1:2] * t2 + dl[:, 2:3] * n_l
        pdf = (1.0 / T.light_area) * torch.clamp(dl[:, 2], min=1e-9) / math.pi
        cos0 = torch.abs(P.dot(n_l, d))
        beta = T.light_L[None, :] * (cos0 / torch.clamp(pdf, min=1e-12)
                                     )[:, None]
        o = P.spawn(o, n_l, d)
        alive = pdf > 1e-12
        tmax = torch.where(alive, torch.full_like(pdf, float("inf")),
                           -torch.ones_like(pdf))
        for bounce in range(depth):
            hit = P.Hit(o, d, *P.intersect(o, d, tmax, T), T)
            alive = alive & hit.valid
            if bounce > 0:
                dep = torch.where(alive[:, None], beta,
                                  torch.zeros_like(beta)).float()
                for v0 in range(0, N, CHUNK):
                    vs = slice(v0, v0 + CHUNK)
                    d2 = ((vp_p[vs, None, :] - hit.p[None, :, :]) ** 2
                          ).sum(-1)
                    w = ((d2 <= r2[vs, None]) & vp_valid[vs, None]
                         & alive[None, :]).float()
                    tau_add[vs] += w @ dep
                    M[vs] += w.sum(-1)
            if bounce == depth - 1:
                break
            base = 8 + bounce * 4
            wi_w, f_s, pdf_s, _, _, _ = P.Surface(T, hit).sample(
                sdim(base), sdim(base + 1), sdim(base + 2))
            ok = (pdf_s > 1e-12) & (f_s != 0).any(-1)
            beta = torch.where((alive & ok)[:, None], beta * f_s * (
                torch.abs(P.dot(wi_w, hit.ns))
                / torch.clamp(pdf_s, min=1e-12))[:, None], beta)
            q = torch.clamp(1.0 - beta.amax(-1), 0.0, 0.95)
            kill = sdim(base + 3) < q
            beta = beta / torch.clamp(1.0 - q, min=0.05)[:, None]
            alive = alive & ok & ~kill
            o = P.spawn(hit.p, hit.ng, wi_w)
            d = wi_w
            tmax = torch.where(alive, torch.full_like(tmax, float("inf")),
                               -torch.ones_like(tmax))
    return tau_add, M


def render(T, pixels, seed, W, H, depth, n_iterations, initial_radius):
    """[N,31] radiance of the sampled pixels after n_iterations."""
    dev = T.dev
    N = pixels.shape[0]
    V = W * H
    radius = torch.full((N,), float(initial_radius), dtype=torch.float32,
                        device=dev)
    n_acc = torch.zeros(N, dtype=torch.float32, device=dev)
    tau = torch.zeros((N, 31), dtype=torch.float32, device=dev)
    ld_sum = torch.zeros((N, 31), dtype=torch.float32, device=dev)
    for it in range(n_iterations):
        Ld, vp_p, vp_f, vp_valid = camera_pass(T, pixels, it, seed, W, H,
                                               depth)
        ld_sum = ld_sum + Ld.float()
        tau_add, Mc = photon_pass(T, it, V, seed, depth, vp_p, vp_valid,
                                  radius.to(T.dt))
        has = Mc > 0
        n_new = n_acc + ALPHA * Mc
        r_new = radius * torch.sqrt(torch.where(
            has, n_new / torch.clamp(n_acc + Mc, min=1e-9),
            torch.ones_like(n_new)))
        ratio = torch.where(has, (r_new / torch.clamp(radius, min=1e-12))
                            ** 2, torch.ones_like(r_new))
        tau = (tau + vp_f.float() * tau_add) * ratio[:, None]
        radius = torch.where(has, r_new, radius)
        n_acc = torch.where(has, n_new, n_acc)
    return ld_sum / n_iterations + tau / (
        n_iterations * V * math.pi * torch.clamp(radius, min=1e-12)[:, None]
        ** 2)
