"""Wavefront path-tracing integrator (port of pbrt_tpu.integrators.path).

A fixed-depth loop over an SoA path-state batch: every bounce is one
round of {emission with MIS, NEE toward one light, BSDF sample} over all
lanes with dead lanes masked.  The NEE shadow rays of a bounce are traced
together with the next bounce's closest-hit rays in one batch
(`trace_pair`).  Russian roulette follows path.cpp:185-191.

Not ported yet: subsurface (BSSRDF probe), hair, ray differentials,
environment lights, the "all" / "power" / "spatial" light strategies and
the primary-sample-space `uniforms` hook.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.cameras import projective
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.lights import distrib, lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import SamplerConfig, sample_dim
from pbrt_tpu_torch.scene import ir

# sampler dimension layout (shared with the JAX package)
DIM_PIXEL_X = 0
DIM_PIXEL_Y = 1
DIM_LENS_U = 2
DIM_LENS_V = 3
DIM_TIME = 4
DIMS_PER_BOUNCE = 9
DIM_BOUNCE_BASE = 5
RR_THRESHOLD = 1.0       # the reference's rrThreshold default


def _bdim(bounce, k):
    return DIM_BOUNCE_BASE + bounce * DIMS_PER_BOUNCE + k


def trace_paths(scene: ir.SceneData, ray: geom.Ray, pixel_id, sample_idx,
                cfg: SamplerConfig, max_depth=5, count_rays=False):
    """Radiance [B,31] for a batch of camera rays.

    count_rays: also return the rays traced, counted as the JAX package
    counts them: True gives live closest-hit lanes + candidate shadow
    lanes, "full" the vector [closest, shadow, camera, path vertices]
    (int64)."""
    B = ray.o.shape[0]
    dev = ray.o.device

    def sdim(dim):
        return sample_dim(cfg, pixel_id, sample_idx, dim)

    L = torch.zeros((B, spec.N_SPECTRAL_SAMPLES), device=dev)
    beta = torch.ones_like(L)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    specular = torch.ones_like(alive)     # bounce 0 counts Le un-MIS'd
    prev_pdf = torch.ones(B, device=dev)
    prev_p = ray.o
    eta_scale = torch.ones(B, device=dev)
    n_rays = torch.zeros(4, dtype=torch.int64, device=dev)
    if count_rays:
        n_cam = (ray.tmax > 0).sum()
        n_rays[0] += n_cam
        n_rays[2] += n_cam
    hit = isect.intersect_full(scene, ray, presorted=True)
    for bounce in range(max_depth + 1):
        # ---- emitted radiance at the hit, MIS'd against NEE ----
        le = lights.area_le(scene, hit.light, hit.ng, hit.wo)
        if bounce == 0:
            w_hit = torch.ones(B, device=dev)
        else:
            sel = distrib.selection_pdf(scene, hit.t)
            pdf_light = lights.pdf_li_area(
                scene, hit.light, prev_p, geom.normalize(ray.d), hit.t,
                hit.ng) * sel
            w_hit = torch.where(specular, 1.0, sampling.power_heuristic(
                1.0, prev_pdf, 1.0, pdf_light))
        L = L + torch.where((alive & hit.valid)[:, None],
                            beta * le * w_hit[:, None], 0.0)
        alive = alive & hit.valid
        if count_rays:
            n_rays[3] += alive.sum()
        if bounce == max_depth:
            break

        mat = bsdf.gather_materials(scene, hit.material)
        ss, ts = geom.coordinate_system(hit.ns)
        wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)

        # ---- NEE: one light, power-heuristic MIS; the shadow ray is
        # traced with the next bounce's closest-hit rays ----
        if scene.n_lights > 0:
            l, sel_pdf = distrib.select_light(scene, sdim(_bdim(bounce, 0)))
            wi, li, pdf_l, dist, delta_l = lights.sample_li(
                scene, l, hit.p, hit.ns, sdim(_bdim(bounce, 1)),
                sdim(_bdim(bounce, 2)))
            wi_l = geom.world_to_frame(ss, ts, hit.ns, wi)
            f = bsdf.eval_f(mat, wo_l, wi_l) * \
                geom.absdot(wi, hit.ns)[:, None]
            cand = (alive & (pdf_l > 1e-12) & ~spec.is_black(li)
                    & ~spec.is_black(f))
            sray = isect.spawn_shadow_ray(hit.p, hit.ng, wi, dist, cand,
                                          ray.wavelength, time=ray.time)
            if count_rays:
                n_rays[1] += cand.sum()
            pdf_b = bsdf.pdf_f(mat, wo_l, wi_l)
            w_l = torch.where(delta_l, 1.0, sampling.power_heuristic(
                1.0, pdf_l, 1.0, pdf_b))
            contrib = beta * f * li * (
                w_l / torch.clamp(pdf_l * sel_pdf, min=1e-12))[:, None]
        else:
            sray = cand = contrib = None

        # ---- BSDF sampling (path.cpp:141-148) ----
        wi_l, f, pdf, is_spec, _, eta_fac = bsdf.sample_f(
            mat, wo_l, sdim(_bdim(bounce, 3)), sdim(_bdim(bounce, 4)),
            sdim(_bdim(bounce, 5)))
        wi_w = geom.frame_to_world(ss, ts, hit.ns, wi_l)
        cos_t = geom.absdot(wi_w, hit.ns)
        ok = (pdf > 1e-12) & ~spec.is_black(f)
        beta_new = beta * f * (cos_t / torch.clamp(pdf, min=1e-12))[:, None]
        alive = alive & ok
        beta = torch.where(alive[:, None], beta_new, beta)
        eta_scale = eta_scale * torch.where(alive, eta_fac, 1.0)
        specular = is_spec
        prev_pdf = pdf
        prev_p = hit.p
        nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength,
                               time=ray.time)
        # dead lanes: zero-length rays drop out of the intersect queue
        ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))

        # ---- Russian roulette (path.cpp:185-191) ----
        if bounce > 3:
            rr_max = beta.amax(-1) * eta_scale
            q = torch.clamp(1.0 - rr_max, 0.05, 0.99)
            apply_rr = rr_max < RR_THRESHOLD
            alive = alive & ~(apply_rr & (sdim(_bdim(bounce, 6)) < q))
            beta = beta * torch.where(apply_rr & alive, 1.0 / (1.0 - q),
                                      1.0)[:, None]
            ray = ray.replace(tmax=torch.where(alive, ray.tmax, -1.0))

        # ---- combined trace: next closest hit + this bounce's shadow ----
        if count_rays:
            n_rays[0] += (ray.tmax > 0).sum()
        hit, occ = isect.trace_pair(scene, ray, sray)
        if sray is not None:
            L = L + torch.where((cand & ~occ)[:, None], contrib, 0.0)

    # NaN/Inf scrub (reference: integrator.cpp:295-316)
    L = torch.clamp(torch.where(torch.isfinite(L), L, 0.0), min=0.0)
    if count_rays == "full":
        return L, n_rays
    if count_rays:
        return L, n_rays[0] + n_rays[1]
    return L


def camera_rays_for_pixels(camera, W, H, cfg, pixel_id, sample_idx,
                           generate_rays=projective.generate_rays):
    """Camera rays for a chunk of pixel ids (int64 tensor of 32-bit words;
    ids >= W*H are padding) at one sample index.

    Returns (ray, weight, pfilm, pid, sidx)."""
    sidx = torch.full_like(pixel_id, int(sample_idx))
    valid = pixel_id < W * H
    pid = torch.where(valid, pixel_id, 0)
    ix = (pid % W).to(torch.float32)
    iy = (pid // W).to(torch.float32)
    pfilm = torch.stack([ix + sample_dim(cfg, pid, sidx, DIM_PIXEL_X),
                         iy + sample_dim(cfg, pid, sidx, DIM_PIXEL_Y)], -1)
    ulens = torch.stack([sample_dim(cfg, pid, sidx, DIM_LENS_U),
                         sample_dim(cfg, pid, sidx, DIM_LENS_V)], -1)
    utime = sample_dim(cfg, pid, sidx, DIM_TIME)
    ray, weight = generate_rays(camera, pfilm, ulens, utime)
    weight = torch.where(valid, weight, 0.0)
    # padded lanes: zero-length rays drop out of the intersect queue
    ray = ray.replace(tmax=torch.where(valid, ray.tmax, -1.0))
    return ray, weight, pfilm, pid, sidx


def render(scene, camera, film, cfg: SamplerConfig, spp, max_depth=5,
           max_rays_per_pass=1 << 18, count_rays=False):
    """Full render: fixed-shape passes over (sample, pixel chunk); the
    samples of every pass splat into `film` in place.

    Returns the film, or (film, rays traced) with count_rays (rays as
    trace_paths counts them with count_rays=True)."""
    H, W = film.height, film.width
    dev = film.weighted.device
    n_pix = H * W
    chunk = min(n_pix, max_rays_per_pass)
    n_chunks = -(-n_pix // chunk)
    ids = np.full(n_chunks * chunk, 0xFFFFFFFF, np.int64)
    ids[:n_pix] = np.arange(n_pix)
    id_chunks = [torch.as_tensor(ids[i * chunk:(i + 1) * chunk], device=dev)
                 for i in range(n_chunks)]
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        for pixel_ids in id_chunks:
            ray, weight, pfilm, pid, sidx = camera_rays_for_pixels(
                camera, W, H, cfg, pixel_ids, s)
            L, n = trace_paths(scene, ray, pid, sidx, cfg,
                               max_depth=max_depth, count_rays=True)
            filmmod.add_samples(film, pfilm, L, weight)
            total += n
    return (film, int(total)) if count_rays else film
