"""Wavefront path-tracing integrator (port of pbrt_tpu.integrators.path).

A fixed-depth loop over an SoA path-state batch: every bounce is one
round of {emission with MIS, NEE toward one light, BSDF sample} over all
lanes with dead lanes masked.  The NEE shadow rays of a bounce are traced
together with the next bounce's closest-hit rays in one batch
(`trace_pair`).  Russian roulette follows path.cpp:185-191.

Textures: the first hit's texture lookups use the camera's ray
differentials (EWA filtering) when `render` passes them, which it does
for projective cameras in scenes with textures; the differentials follow
specular bounces, and every other lookup takes the ray-cone footprint
`tex_spread` (the camera's pixel spread, widened to 0.2 after the first
bounce).  Bump maps perturb the shading normal before the shading frame
is built, and a mix material picks its component with its own sampler
dimension.

Lights: NEE picks one light per lane by the `light_strategy` ("uniform",
"power" or "spatial", lights/distrib.py), or with "all" (the
directlighting integrator's UniformSampleAllLights) samples every light
once a bounce, their shadow rays traced in the same batch; emission
found by a BSDF
sample (at an area light, or the infinite light on an escaped ray) is
MIS-weighted against that strategy's selection pdf; delta lights take
weight 1.  NEE's own MIS weight uses the light's pdf alone, without the
selection pdf, as the JAX package's does, so the two weights sum to 1
only where a light is picked with probability 1 and the image of a
non-delta light depends on the strategy (a recorded deviation from the
reference's estimator).  Shadow rays toward a sphere light ignore its
own sphere (intersect.nee_ignore_light).

Subsurface (`_sss_event`, in a scene with a BSSRDF table): after the
shading frame, a subsurface lane either reflects off the interface or
is relocated to an exit point found by SSS_PROBE_PASSES closest-hit
probe passes (each an intersect call, K1 and K2 on the card), and this
bounce's NEE and sampling then run there with the Sw exit lobe.  Hair
lanes shade in a frame along the fiber (bsdf.shading_frame) and sample
with a ninth sampler dimension a bounce.

Primary sample space (MLT's hook, integrators/mlt.py): given `uniforms`
[B, D], every sampler dimension `dim` of the pass, the camera's, the
bounces' (the mix and hair dimensions included), the BSSRDF probe's and
the "all" strategy's blocks, reads column dim % D instead of the
sampler (reference mlt.h MLTSampler:53-105).
"""

from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch

from pbrt_tpu_torch.cameras import lens, projective
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.lights import distrib, lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.materials import bssrdf as bssrdfmod
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import SamplerConfig, sample_dim
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.utils.stats import span

# sampler dimension layout (shared with the JAX package)
DIM_PIXEL_X = 0
DIM_PIXEL_Y = 1
DIM_LENS_U = 2
DIM_LENS_V = 3
DIM_TIME = 4
DIMS_PER_BOUNCE = 9
DIM_BOUNCE_BASE = 5
# the BSSRDF probe's dimensions, in their own block above the bounces'
# (depths below 64)
DIM_SSS_BASE = DIM_BOUNCE_BASE + 64 * DIMS_PER_BOUNCE
DIMS_PER_SSS = 8
# the "all" strategy's two dimensions a light a bounce, in their own block
# above the BSSRDF probe's
DIM_ALL_BASE = DIM_SSS_BASE + 64 * DIMS_PER_SSS
RR_THRESHOLD = 1.0       # the reference's rrThreshold default
# the probe's closest-hit passes a subsurface event: the reference walks
# the whole chain of intersections along the probe segment
# (bssrdf.cpp:255-270); each pass here extends it by one hit,
# reservoir-sampling among the hits of the same material, so chains of
# up to this many hits are exact and longer ones truncated.  4 covers a
# two-sided slab pierced twice.  The JAX package reads it from the
# environment; here it is a module constant that callers may set.
SSS_PROBE_PASSES = 4


def _bdim(bounce, k):
    return DIM_BOUNCE_BASE + bounce * DIMS_PER_BOUNCE + k


def _sdim_sss(bounce, k):
    return DIM_SSS_BASE + bounce * DIMS_PER_SSS + k


def _sss_event(scene, hit, mat, beta, alive, ss, ts, sdim, bounce,
               wavelength, n_rays=None, count_rays=False):
    """The BSSRDF interface event and probe-ray relocation (reference
    SeparableBSSRDF::Sample_S / Sample_Sp / Pdf_Sp, bssrdf.cpp:214-309;
    path.cpp:155-180; pbrt_tpu/integrators/path.py:76-244).

    With probability Fr a subsurface lane reflects off the interface: a
    mirror where the interface is smooth, the reflection-only rough-glass
    lobe where it is rough (Fr at a visible-GGX half vector; that lobe
    multiplies by F again, the JAX package's F^2, kept).  Otherwise it
    enters and is relocated to an exit point pi found by SSS_PROBE_PASSES
    closest-hit probes along a chord through a radius drawn from the
    diffusion profile, reservoir-picking among hits of its own material;
    it takes beta *= Sp / Pdf_Sp and the Sw exit lobe (MAT_SSW), so the
    bounce's NEE and sampling run at pi.  A lane whose probe finds no exit
    dies.  sdim(dim): the lanes' sampler dimension.

    Returns (hit, mat, beta, alive, n_rays); n_rays [4] (count_rays) gets
    the probe lanes added to its closest-hit count."""
    t = mat.type
    NS = spec.N_SPECTRAL_SAMPLES
    dev = beta.device
    is_ss = alive & ((t == ir.MAT_SUBSURFACE) | (t == ir.MAT_KDSUBSURFACE))
    # the interface's Fresnel: the macro normal's where it is smooth
    # (FresnelSpecular, subsurface.cpp:64-66), a visible-GGX half vector's
    # where it is rough (the TrowbridgeReitz interface, :68-87)
    rough_if = is_ss & ((mat.rough_u > 0) | (mat.rough_v > 0))
    wo_l0 = geom.world_to_frame(ss, ts, hit.ns, hit.wo)
    wh_l = bsdf.ggx_sample_wh(wo_l0, sdim(_sdim_sss(bounce, 6)),
                              sdim(_sdim_sss(bounce, 7)),
                              torch.clamp(mat.rough_u, min=1e-3),
                              torch.clamp(mat.rough_v, min=1e-3))
    cos_if = torch.where(rough_if, (wo_l0 * wh_l).sum(-1),
                         geom.dot(hit.wo, hit.ns))
    fr = bsdf.fresnel_dielectric(cos_if, 1.0, mat.eta)
    refl = is_ss & (sdim(_sdim_sss(bounce, 0)) < fr)
    trans = is_ss & ~refl
    # reflected lanes: the smooth interface's mirror, the rough one's
    # reflection-only rough glass (MicrofacetReflection with dielectric
    # Fresnel, subsurface.cpp:76-83); a rough interface's transmission
    # keeps the FresnelSpecular-style (1 - Fr) cancellation
    mat = dataclasses.replace(
        mat,
        type=torch.where(refl, torch.where(rough_if, ir.MAT_ROUGHGLASS,
                                           ir.MAT_MIRROR), mat.type),
        kr=torch.where(refl[:, None], 1.0, mat.kr),
        kt=torch.where((refl & rough_if)[:, None], 0.0, mat.kt))

    # ---- the probe (Sample_Sp): projection axis, channel, radius ----
    u_ax = sdim(_sdim_sss(bounce, 1))
    pick_ns = (u_ax < 0.5)[:, None]
    pick_ss = ((u_ax >= 0.5) & (u_ax < 0.75))[:, None]
    vx = torch.where(pick_ns, ss, torch.where(pick_ss, ts, hit.ns))
    vy = torch.where(pick_ns, ts, torch.where(pick_ss, hit.ns, ss))
    vz = torch.where(pick_ns, hit.ns, torch.where(pick_ss, ss, ts))
    ch = torch.clamp((sdim(_sdim_sss(bounce, 2)) * NS).to(torch.int64), 0,
                     NS - 1)
    sigt_ch = torch.gather(mat.sss_sigma_t, 1, ch[:, None])[:, 0]
    rho_ch = torch.gather(mat.sss_rho, 1, ch[:, None])[:, 0]
    tid = torch.clamp(mat.sss_tid, 0, scene.bssrdf_profile.shape[0] - 1)
    u_r = sdim(_sdim_sss(bounce, 3))
    r_opt = bssrdfmod.sr_sample_device(scene.bssrdf_cdf, scene.bssrdf_radius,
                                       scene.bssrdf_rho, tid, rho_ch, u_r)
    r_max_opt = bssrdfmod.sr_sample_device(
        scene.bssrdf_cdf, scene.bssrdf_radius, scene.bssrdf_rho, tid, rho_ch,
        torch.full_like(u_r, 0.999))
    inv_sigt = 1.0 / torch.clamp(sigt_ch, min=1e-9)
    r_w = r_opt * inv_sigt
    r_max = r_max_opt * inv_sigt
    ok_r = trans & (sigt_ch > 1e-9) & (r_w < r_max)
    half_l = torch.sqrt(torch.clamp(r_max * r_max - r_w * r_w, min=0.0))
    phi = 2.0 * np.pi * sdim(_sdim_sss(bounce, 4))
    pstart = (hit.p + r_w[:, None] * (torch.cos(phi)[:, None] * vx
                                      + torch.sin(phi)[:, None] * vy)
              + half_l[:, None] * vz)
    pdir = -vz

    # ---- the chained probe: a reservoir pick among same-material hits;
    # the march step is the JAX package's, sized for its kernel's bf16x2
    # t, kept ----
    P = scene.prim_type.shape[0]
    eps = 1e-4 * torch.clamp(torch.abs(pstart).amax(-1), min=1.0)
    cur_o = pstart
    remaining = torch.where(ok_r, 2.0 * half_l, -1.0)
    dist0 = torch.zeros_like(remaining)
    nfound = torch.zeros_like(ch)
    pick_t = torch.zeros_like(dist0)
    pick_prim = torch.zeros_like(ch)
    u_pick = sdim(_sdim_sss(bounce, 5))
    for k in range(SSS_PROBE_PASSES):
        pray = geom.Ray.make(cur_o, pdir, tmax=remaining,
                             wavelength=wavelength)
        if count_rays:
            n_rays[0] += (remaining > 0).sum()
        tt, prim, found = isect.intersect(scene, pray)
        pm = scene.prim_material[torch.clamp(prim, 0, P - 1).long()]
        match = found & (pm == hit.material)
        nfound = nfound + match.to(nfound.dtype)
        # a golden-ratio shift decorrelates the passes' reservoir draws
        u_k = torch.remainder(u_pick + 0.61803398875 * k, 1.0)
        accept = match & (u_k * nfound.to(torch.float32) < 1.0)
        pick_t = torch.where(accept, dist0 + tt, pick_t)
        pick_prim = torch.where(accept, prim.to(pick_prim.dtype), pick_prim)
        if k + 1 < SSS_PROBE_PASSES:
            step = torch.where(found, tt * (1.0 + 2e-4) + eps, 0.0)
            dist0 = dist0 + step
            cur_o = cur_o + step[:, None] * pdir
            remaining = torch.where(found, remaining - step, -1.0)
    found_any = trans & (nfound > 0)
    probe_ray = geom.Ray.make(pstart, pdir,
                              tmax=torch.clamp(remaining, min=0.0),
                              wavelength=wavelength)
    pih = isect.make_hit(scene, probe_ray, pick_t, pick_prim, found_any)

    # ---- Sp and its pdf at pi (TabulatedBSSRDF::Sr and Pdf_Sp) ----
    d_vec = pih.p - hit.p
    d_w = geom.length(d_vec)
    sig2 = mat.sss_sigma_t * mat.sss_sigma_t                    # [B,31]
    sp = bssrdfmod.sr_eval_device(
        scene.bssrdf_profile, scene.bssrdf_rho, scene.bssrdf_radius,
        tid[:, None], mat.sss_rho, d_w[:, None] * mat.sss_sigma_t) * sig2
    dl = torch.stack([geom.dot(ss, d_vec), geom.dot(ts, d_vec),
                      geom.dot(hit.ns, d_vec)], -1)             # [B,3]
    nl = torch.stack([geom.dot(ss, pih.ng), geom.dot(ts, pih.ng),
                      geom.dot(hit.ns, pih.ng)], -1)
    r_proj = torch.sqrt(torch.clamp(torch.stack(
        [dl[:, 1] ** 2 + dl[:, 2] ** 2,
         dl[:, 2] ** 2 + dl[:, 0] ** 2,
         dl[:, 0] ** 2 + dl[:, 1] ** 2], -1), min=1e-20))       # [B,3]
    # MIS over the 3 projection axes and the NS channels
    # (bssrdf.cpp:283-309)
    pdf_terms = bssrdfmod.sr_pdf_device(
        scene.bssrdf_profile, scene.bssrdf_cdf, scene.bssrdf_rho,
        scene.bssrdf_radius, tid[:, None, None], mat.sss_rho[:, None, :],
        r_proj[:, :, None] * mat.sss_sigma_t[:, None, :]) \
        * sig2[:, None, :]                                      # [B,3,31]
    axis_prob = torch.tensor([0.25, 0.25, 0.5], device=dev)
    pdf_sp = (pdf_terms * torch.abs(nl)[:, :, None]
              * axis_prob[None, :, None]).sum((1, 2)) / NS
    pdf_sp = pdf_sp / torch.clamp(nfound.to(torch.float32), min=1.0)

    ok = found_any & (pdf_sp > 1e-12)
    beta = torch.where(ok[:, None],
                       beta * sp / torch.clamp(pdf_sp, min=1e-12)[:, None],
                       beta)
    alive = alive & ~(trans & ~ok)
    okc = ok[:, None]
    hit = hit.replace(p=torch.where(okc, pih.p, hit.p),
                      ng=torch.where(okc, pih.ng, hit.ng),
                      ns=torch.where(okc, pih.ns, hit.ns),
                      uv=torch.where(okc, pih.uv, hit.uv),
                      prim=torch.where(ok, pih.prim, hit.prim),
                      instance=torch.where(ok, pih.instance, hit.instance),
                      # the Sw lobe does not depend on wo; wo along ns
                      # keeps the shading frame well formed
                      wo=torch.where(okc, pih.ns, hit.wo))
    mat = dataclasses.replace(mat, type=torch.where(ok, ir.MAT_SSW, mat.type))
    return hit, mat, beta, alive, n_rays


def trace_paths(scene: ir.SceneData, ray: geom.Ray, pixel_id, sample_idx,
                cfg: SamplerConfig, max_depth=5, count_rays=False,
                wavelength_mask=None, tex_spread=0.0, ray_diff=None,
                light_strategy="uniform", uniforms=None):
    """Radiance [B,31] for a batch of camera rays.

    count_rays: also return the rays traced, counted as the JAX package
    counts them: True gives live closest-hit lanes + candidate shadow
    lanes, "full" the vector [closest, shadow, camera, path vertices]
    (int64).  wavelength_mask: an optional [B,31] 0/1 mask that confines
    transport to a band of bins (integrators/spectralpath.py).
    tex_spread: the camera's pixel spread (camera_pixel_spread); 0 keeps
    every texture lookup at the finest level.  ray_diff: the camera rays'
    differentials (camera_ray_differentials) or None.  light_strategy:
    "uniform", "power" or "spatial" (lights/distrib.py), or "all".
    uniforms: [B, D] primary samples that stand in for the sampler (the
    module docstring); cfg, pixel_id and sample_idx are then unused."""
    B = ray.o.shape[0]
    dev = ray.o.device

    def sdim(dim):
        if uniforms is not None:
            return uniforms[:, dim % uniforms.shape[1]]
        return sample_dim(cfg, pixel_id, sample_idx, dim)

    L = torch.zeros((B, spec.N_SPECTRAL_SAMPLES), device=dev)
    beta = torch.ones_like(L)
    if wavelength_mask is not None:
        beta = beta * wavelength_mask
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
    hit = isect.intersect_full(scene, ray, presorted=True,
                               ray_diff=ray_diff)
    rd = ray_diff          # followed through specular bounces below
    textured = scene.tex_type.shape[0] > 1
    for bounce in range(max_depth + 1):
        dnorm = geom.normalize(ray.d)
        # ---- emitted radiance at the hit, MIS'd against NEE ----
        le = lights.area_le(scene, hit.light, hit.ng, hit.wo)
        if bounce == 0:
            w_hit = torch.ones(B, device=dev)
        else:
            sel = distrib.selection_pdf(scene, light_strategy, prev_p,
                                        hit.light)
            pdf_light = lights.pdf_li_area(scene, hit.light, prev_p, dnorm,
                                           hit.t, hit.ng) * sel
            w_hit = torch.where(specular, 1.0, sampling.power_heuristic(
                1.0, prev_pdf, 1.0, pdf_light))
        L = L + torch.where((alive & hit.valid)[:, None],
                            beta * le * w_hit[:, None], 0.0)
        # ---- escaped rays: the infinite light (path.cpp:100-103) ----
        if scene.has_infinite:
            env = lights.env_le(scene, dnorm)
            if bounce == 0:
                w_env = torch.ones(B, device=dev)
            else:
                sel_env = distrib.selection_pdf(
                    scene, light_strategy, prev_p,
                    torch.full_like(hit.light, scene.inf_light_idx))
                pdf_env = lights.pdf_li_infinite(scene, dnorm) * sel_env
                w_env = torch.where(specular, 1.0, sampling.power_heuristic(
                    1.0, prev_pdf, 1.0, pdf_env))
            L = L + torch.where((alive & ~hit.valid)[:, None],
                                beta * env * w_env[:, None], 0.0)
        alive = alive & hit.valid
        if count_rays:
            n_rays[3] += alive.sum()
        if bounce == max_depth:
            break

        # the texture footprint: the camera's pixel cone, widened to a
        # diffuse cone after the first bounce (texture.cpp's differentials
        # stand-in); first hits with differentials filter by EWA instead
        uv_w = None
        if tex_spread > 0.0 and textured:
            uv_w = hit.uv_density * hit.t * (
                tex_spread if bounce == 0 else max(tex_spread, 0.2))
        mat = bsdf.gather_materials(
            scene, hit.material, uv=hit.uv, p=hit.p,
            u_mix=sdim(_bdim(bounce, 7)) if scene.has_mix else None,
            uv_width=uv_w, duv=hit.duv, face=hit.face)
        hit = hit.replace(ns=bsdf.bump_shading_normal(scene, hit.material,
                                                      hit))
        ss, ts = bsdf.shading_frame(scene, hit)
        # ---- the BSSRDF probe relocation (bssrdf.cpp Sample_S): relocated
        # lanes run this bounce's NEE and sampling at their exit point ----
        if scene.has_sss:
            hit, mat, beta, alive, n_rays = _sss_event(
                scene, hit, mat, beta, alive, ss, ts, sdim, bounce,
                ray.wavelength, n_rays, count_rays)
            ss, ts = bsdf.shading_frame(scene, hit)
        wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)

        # ---- NEE: one light, power-heuristic MIS; the shadow ray is
        # traced with the next bounce's closest-hit rays ----
        if scene.n_lights > 0 and light_strategy == "all":
            # UniformSampleAllLights (integrator.cpp:54): one sample of
            # every light a bounce, their shadow rays in one batch
            n_l = scene.light_L.shape[0]
            srays, contribs, cands = [], [], []
            for li_ix in range(n_l):
                base = DIM_ALL_BASE + bounce * 2 * n_l + 2 * li_ix
                wi, li, pdf_l, dist, delta_l = lights.sample_li(
                    scene, torch.full((B,), li_ix, dtype=torch.int64,
                                      device=dev),
                    hit.p, hit.ns, sdim(base), sdim(base + 1))
                wi_l = geom.world_to_frame(ss, ts, hit.ns, wi)
                f = bsdf.eval_f(mat, wo_l, wi_l) * \
                    geom.absdot(wi, hit.ns)[:, None]
                ci = (alive & (pdf_l > 1e-12) & ~spec.is_black(li)
                      & ~spec.is_black(f))
                srays.append(isect.spawn_shadow_ray(
                    hit.p, hit.ng, wi, dist, ci, ray.wavelength,
                    time=ray.time))
                w_l = torch.where(delta_l, 1.0, sampling.power_heuristic(
                    1.0, pdf_l, 1.0, bsdf.pdf_f(mat, wo_l, wi_l)))
                contribs.append(beta * f * li * (
                    w_l / torch.clamp(pdf_l, min=1e-12))[:, None])
                cands.append(ci)
                if count_rays:
                    n_rays[1] += ci.sum()
            sray = geom.Ray(*(torch.cat([getattr(r, k) for r in srays])
                              for k in ("o", "d", "tmax", "wavelength",
                                        "time")))
            cand, contrib, l = torch.stack(cands), torch.stack(contribs), None
        elif scene.n_lights > 0:
            l, sel_pdf = distrib.select_light(scene, light_strategy, hit.p,
                                              sdim(_bdim(bounce, 0)))
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
            l = sray = cand = contrib = None

        # ---- BSDF sampling (path.cpp:141-148) ----
        wi_l, f, pdf, is_spec, transmitted, eta_fac = bsdf.sample_f(
            mat, wo_l, sdim(_bdim(bounce, 3)), sdim(_bdim(bounce, 4)),
            sdim(_bdim(bounce, 5)),
            u3=sdim(_bdim(bounce, 8)) if scene.has_hair else None)
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
        if rd is not None:
            rd = _specular_differentials(rd, hit, mat, wi_w, transmitted,
                                         alive & is_spec & hit.valid)
        nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength,
                               time=ray.time)
        # dead lanes: zero-length rays drop out of the intersect queue
        ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))

        # ---- Russian roulette (path.cpp:185-191) ----
        if bounce > 3:
            rr_max = beta.amax(-1) * eta_scale
            # q takes no gradient (the JAX package's stop_gradient): the
            # kill test and the 1/(1-q) reweight are the estimator's
            # sampling, detached as every other sampling decision is
            q = torch.clamp(1.0 - rr_max.detach(), 0.05, 0.99)
            apply_rr = rr_max < RR_THRESHOLD
            alive = alive & ~(apply_rr & (sdim(_bdim(bounce, 6)) < q))
            beta = beta * torch.where(apply_rr & alive, 1.0 / (1.0 - q),
                                      1.0)[:, None]
            ray = ray.replace(tmax=torch.where(alive, ray.tmax, -1.0))

        # ---- combined trace: next closest hit + this bounce's shadow ----
        if count_rays:
            n_rays[0] += (ray.tmax > 0).sum()
        hit, occ = isect.trace_pair(
            scene, ray, sray, ignore_light=isect.nee_ignore_light(scene, l),
            ray_diff=rd)
        if sray is not None and light_strategy == "all":
            occ = occ.reshape(cand.shape)
            L = L + torch.where((cand & ~occ)[..., None], contrib,
                                0.0).sum(0)
        elif sray is not None:
            L = L + torch.where((cand & ~occ)[:, None], contrib, 0.0)

    # NaN/Inf scrub (reference: integrator.cpp:295-316); maximum, not
    # clamp, so that a lane at exactly 0 passes half its gradient, as
    # the JAX package's jnp.maximum does
    L = torch.where(torch.isfinite(L), L, 0.0)
    L = torch.maximum(L, torch.zeros((), device=dev))
    if count_rays == "full":
        return L, n_rays
    if count_rays:
        return L, n_rays[0] + n_rays[1]
    return L


def _specular_differentials(rd, hit, mat, wi_w, transmitted, keep):
    """The ray differentials (rxo, rxd, ryo, ryd) after a bounce
    (SpecularReflect / SpecularTransmit, integrator.cpp:344-429): lanes in
    `keep` (specular) carry them through the bounce; the others get zero
    directions, so their next texture lookup falls back to the cone."""
    ns, wo = hit.ns, hit.wo
    won = geom.dot(wo, ns)
    eta_r = torch.where(won < 0, 1.0 / torch.clamp(mat.eta, min=1e-6),
                        mat.eta)
    wdn = geom.dot(-wo, ns)
    widn = geom.dot(wi_w, ns)
    safe_widn = torch.where(torch.abs(widn) > 1e-6, widn, 1e-6)
    mu = eta_r * wdn - widn
    dmu = eta_r - (eta_r * eta_r * wdn) / safe_widn
    keep = keep[:, None]

    def fin(a):
        return torch.where(torch.isfinite(a), a, 0.0)

    out = []
    for rdir, dpd, dnd in ((rd[1], hit.dpdx, hit.dndx),
                           (rd[3], hit.dpdy, hit.dndy)):
        dwod = -rdir - wo
        dDN = geom.dot(dwod, ns) + geom.dot(wo, dnd)
        refl = wi_w - dwod + 2.0 * (won[:, None] * dnd + dDN[:, None] * ns)
        tran = wi_w + eta_r[:, None] * dwod - (mu[:, None] * dnd
                                               + (dmu * dDN)[:, None] * ns)
        new_d = torch.where(transmitted[:, None], tran, refl)
        out += [torch.where(keep, fin(hit.p + dpd), hit.p),
                torch.where(keep, fin(new_d), 0.0)]
    return tuple(out)


def generate_fn(camera):
    """The ray generator of a camera: the lens stack's or the projective
    cameras' (the JAX package's dispatch._generate_fn)."""
    return (lens.generate_rays if isinstance(camera, lens.LensCamera)
            else projective.generate_rays)


def camera_samples(cfg, W, pid, sidx):
    """The film point (pixel + jitter) [B,2], lens sample [B,2] and time
    sample [B] of pixel ids pid (< W*H) at sample indices sidx."""
    ix = (pid % W).to(torch.float32)
    iy = (pid // W).to(torch.float32)
    pfilm = torch.stack([ix + sample_dim(cfg, pid, sidx, DIM_PIXEL_X),
                         iy + sample_dim(cfg, pid, sidx, DIM_PIXEL_Y)], -1)
    ulens = torch.stack([sample_dim(cfg, pid, sidx, DIM_LENS_U),
                         sample_dim(cfg, pid, sidx, DIM_LENS_V)], -1)
    return pfilm, ulens, sample_dim(cfg, pid, sidx, DIM_TIME)


@span("camera")
def camera_rays_for_pixels(camera, W, H, cfg, pixel_id, sample_idx,
                           generate_rays=None):
    """Camera rays for a chunk of pixel ids (int64 tensor of 32-bit words;
    ids >= W*H are padding) at one sample index, from generate_rays
    (default: the camera's, generate_fn).

    Returns (ray, weight, pfilm, pid, sidx)."""
    if generate_rays is None:
        generate_rays = generate_fn(camera)
    sidx = torch.full_like(pixel_id, int(sample_idx))
    valid = pixel_id < W * H
    pid = torch.where(valid, pixel_id, 0)
    pfilm, ulens, utime = camera_samples(cfg, W, pid, sidx)
    ray, weight = generate_rays(camera, pfilm, ulens, utime, width=W,
                                height=H)
    weight = torch.where(valid, weight, 0.0)
    # padded lanes: zero-length rays drop out of the intersect queue
    ray = ray.replace(tmax=torch.where(valid, ray.tmax, -1.0))
    return ray, weight, pfilm, pid, sidx


def camera_pixel_spread(camera):
    """The angular size of one pixel at the image centre, the texture
    footprint's cone spread; 0 for cameras without a raster_to_camera
    matrix (the lens cameras: the finest mip level)."""
    rtc = getattr(camera, "raster_to_camera", None)
    if rtc is None:
        return 0.0
    rtc = rtc.detach().cpu().double().numpy() if torch.is_tensor(rtc) \
        else np.asarray(rtc, np.float64)

    def proj(x, y):
        p = rtc @ np.array([x, y, 0.0, 1.0])
        return p[:3] / p[3] if abs(p[3]) > 1e-12 else p[:3]

    p0, p1 = proj(0.0, 0.0), proj(1.0, 0.0)
    return float(np.linalg.norm(p1 - p0) / max(np.linalg.norm(p0), 1e-6))


@span("camera")
def camera_ray_differentials(camera, W, H, cfg, pid, sidx, generate_rays,
                             spp):
    """Probe-ray camera differentials (reference camera.cpp:60-95 and the
    1/sqrt(spp) ScaleDifferentials of integrator.cpp:286): the camera ray
    again at the same film sample shifted one pixel in x and in y (the
    same lens and time samples), pulled toward the base ray by
    1/sqrt(spp).  Returns (rxo, rxd, ryo, ryd)."""
    valid = pid < W * H
    pid0 = torch.where(valid, pid, 0)
    base, ulens, utime = camera_samples(cfg, W, pid0, sidx)
    ray0, _ = generate_rays(camera, base, ulens, utime, width=W, height=H)
    dev = base.device
    rx, _ = generate_rays(camera, base + torch.tensor([1.0, 0.0], device=dev),
                          ulens, utime, width=W, height=H)
    ry, _ = generate_rays(camera, base + torch.tensor([0.0, 1.0], device=dev),
                          ulens, utime, width=W, height=H)
    s = 1.0 / np.sqrt(np.float32(max(float(spp), 1.0)))

    def lerp(a, b):
        return a + (b - a) * s

    return (lerp(ray0.o, rx.o), lerp(ray0.d, rx.d),
            lerp(ray0.o, ry.o), lerp(ray0.d, ry.d))


def trace_options(scene, camera, trace_fn):
    """The keywords `render` gives trace_fn beyond its own (as the JAX
    package's render picks them): tex_spread, the camera's pixel spread,
    when trace_fn takes it; and whether to pass camera ray differentials,
    which it does for a trace_fn that takes ray_diff, a projective camera
    and a scene with textures."""
    params = inspect.signature(trace_fn).parameters
    kw = {}
    if "tex_spread" in params:
        kw["tex_spread"] = camera_pixel_spread(camera)
    use_ray_diff = ("ray_diff" in params
                    and getattr(camera, "raster_to_camera", None) is not None
                    and scene.tex_type.shape[0] > 1)
    return kw, use_ray_diff


@span("job")
def render(scene, camera, film, cfg: SamplerConfig, spp, max_depth=5,
           max_rays_per_pass=1 << 18, count_rays=False, trace_fn=None,
           generate_rays=None, trace_kwargs=None, crop_window=None,
           max_sample_luminance=None, progress=None, checkpoint_path=None,
           checkpoint_every=60.0, stats=None, pixel_ids=None):
    """Full render: fixed-shape passes over (sample, pixel chunk); the
    samples of every pass splat into `film` in place.

    trace_fn(scene, ray, pixel_id, sample_idx, cfg, max_depth=...) -> L
    [B,31] traces a pass (default trace_paths), given trace_kwargs (e.g.
    light_strategy) beyond its own; generate_rays makes the camera rays
    (default: the camera's, generate_fn).  Returns the film, or
    (film, rays traced) with count_rays: rays as trace_paths counts them
    with count_rays=True, or None when trace_fn takes no count_rays.

    crop_window (x0, x1, y0, y1) in [0,1]: only the pixels of the crop's
    ceil bounds are rendered, and the film keeps its full size (reference
    croppedPixelBounds, film.cpp:58-66).  max_sample_luminance: each
    sample's spectrum is scaled down to that luminance before the splat
    (film.h:123-163); None is no clamp.  pixel_ids: the pixels to render
    in place of the film's or the crop's (a host integer array; the value
    0xFFFFFFFF is a padding lane), cut into passes of max_rays_per_pass
    in their order (parallel/mesh.py gives each rank its share so).

    progress(done, total) is called after every pass.  checkpoint_path:
    the render resumes from that file's film and completed samples
    (film/checkpoint.py; another render's file starts fresh) and saves
    there after each sample index once checkpoint_every seconds have
    passed since the last save, and after the last; a resumed render
    equals the uninterrupted one.  stats (utils.stats.Stats) receives
    the counters of trace_fn's count_rays="full", where it takes
    count_rays, under the JAX package's names, and the path length."""
    H, W = film.height, film.width
    dev = film.weighted.device
    if pixel_ids is not None:
        pix_list = np.asarray(pixel_ids, np.int64)
    elif crop_window is not None and tuple(crop_window) != (0.0, 1.0, 0.0,
                                                             1.0):
        x0, x1, y0, y1 = crop_window
        gx, gy = np.meshgrid(
            np.arange(int(np.ceil(x0 * W)), int(np.ceil(x1 * W))),
            np.arange(int(np.ceil(y0 * H)), int(np.ceil(y1 * H))))
        pix_list = (gy * W + gx).reshape(-1)
    else:
        pix_list = np.arange(H * W)
    n_pix = len(pix_list)
    chunk = min(n_pix, max_rays_per_pass)
    n_chunks = -(-n_pix // chunk)
    ids = np.full(n_chunks * chunk, 0xFFFFFFFF, np.int64)
    ids[:n_pix] = pix_list
    id_chunks = [torch.as_tensor(ids[i * chunk:(i + 1) * chunk], device=dev)
                 for i in range(n_chunks)]
    if trace_fn is None:
        trace_fn = trace_paths
    if generate_rays is None:
        generate_rays = generate_fn(camera)
    counts = "count_rays" in inspect.signature(trace_fn).parameters
    measure = counts and (count_rays or stats is not None)
    tkw, use_ray_diff = trace_options(scene, camera, trace_fn)
    tkw.update(trace_kwargs or {})
    # [closest, shadow, camera, path vertices], as trace_paths counts them
    n_vec = torch.zeros(4, dtype=torch.int64, device=dev)
    start_spp = 0
    if checkpoint_path is not None:
        # samplers are pure functions of (pixel, sample, dimension), so
        # resuming at start_spp continues exactly the same stream
        from pbrt_tpu_torch.film import checkpoint as ckpt
        fp = ckpt.render_fingerprint(scene, cfg, spp, max_depth, W, H)
        film, start_spp = ckpt.load(checkpoint_path, film, fp)
        start_spp = min(start_spp, spp)
        last_save = time.monotonic()
    done, total = start_spp * n_chunks, spp * n_chunks
    for s in range(start_spp, spp):
        for chunk_ids in id_chunks:
            with span("pass"):
                ray, weight, pfilm, pid, sidx = camera_rays_for_pixels(
                    camera, W, H, cfg, chunk_ids, s, generate_rays)
                kw = dict(tkw)
                if use_ray_diff:
                    kw["ray_diff"] = camera_ray_differentials(
                        camera, W, H, cfg, pid, sidx, generate_rays, spp)
                if measure:
                    L, n = trace_fn(scene, ray, pid, sidx, cfg,
                                    max_depth=max_depth, count_rays="full",
                                    **kw)
                    n_vec += n
                else:
                    L = trace_fn(scene, ray, pid, sidx, cfg,
                                 max_depth=max_depth, **kw)
                if max_sample_luminance is not None:
                    y = spec.luminance(L)
                    L = L * torch.where(
                        y > max_sample_luminance,
                        max_sample_luminance / torch.clamp(y, min=1e-9),
                        1.0)[:, None]
                filmmod.add_samples(film, pfilm, L, weight)
            done += 1
            if progress is not None:
                progress(done, total)
        if checkpoint_path is not None:
            now = time.monotonic()
            if now - last_save >= checkpoint_every or s == spp - 1:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ckpt.save(checkpoint_path, film, s + 1, fp)
                last_save = now
    if measure and stats is not None and done > start_spp * n_chunks:
        nv = n_vec.tolist()
        stats.add("Integrator/Camera rays traced", nv[2])
        stats.add("Intersections/Regular ray intersection tests", nv[0])
        stats.add("Intersections/Shadow ray intersection tests", nv[1])
        stats.add("Integrator/Path vertices shaded", nv[3])
        stats.ratios["Integrator/Path length"] = (float(nv[3]),
                                                  max(float(nv[2]), 1.0))
    if not count_rays:
        return film
    return film, (int(n_vec[0] + n_vec[1]) if counts else None)
