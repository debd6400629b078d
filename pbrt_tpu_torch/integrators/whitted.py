"""The Whitted integrator (port of pbrt_tpu.integrators.whitted;
reference: src/integrators/whitted.cpp): emission, one light sample per
hit with an occlusion test, and recursion along specular reflection and
transmission only.

As in the JAX package, the light is picked uniformly, NEE takes no MIS
weight, and the materials are looked up without bump maps or texture
footprints.  Hair shades in its fiber frame (bsdf.shading_frame); a
subsurface material, which has no probe pass here, shades as its
diffusion limit (the lobe masks' fallback).
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.integrators.path import _bdim
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import sample_dim


def make_trace_whitted():
    def trace(scene, ray, pixel_id, sample_idx, cfg, max_depth=5, **kw):
        B = ray.o.shape[0]
        dev = ray.o.device

        def sdim(dim):
            return sample_dim(cfg, pixel_id, sample_idx, dim)

        L = torch.zeros((B, spec.N_SPECTRAL_SAMPLES), device=dev)
        beta = torch.ones_like(L)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        n_lights = max(scene.n_lights, 1)
        for bounce in range(max_depth + 1):
            hit = isect.intersect_full(scene, ray, presorted=bounce == 0)
            le = lights.area_le(scene, hit.light, hit.ng, hit.wo)
            L = L + torch.where((alive & hit.valid)[:, None], beta * le, 0.0)
            if scene.has_infinite:
                env = lights.env_le(scene, geom.normalize(ray.d))
                L = L + torch.where((alive & ~hit.valid)[:, None],
                                    beta * env, 0.0)
            alive = alive & hit.valid
            if bounce == max_depth:
                break
            mat = bsdf.gather_materials(scene, hit.material, uv=hit.uv,
                                        p=hit.p)
            ss, ts = bsdf.shading_frame(scene, hit)
            wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)
            if scene.n_lights > 0:
                l = torch.clamp((sdim(_bdim(bounce, 0)) * n_lights)
                                .to(torch.int64), max=n_lights - 1)
                wi, li, pdf_l, dist, _ = lights.sample_li(
                    scene, l, hit.p, hit.ns, sdim(_bdim(bounce, 1)),
                    sdim(_bdim(bounce, 2)))
                wi_l = geom.world_to_frame(ss, ts, hit.ns, wi)
                f = bsdf.eval_f(mat, wo_l, wi_l) * \
                    geom.absdot(wi, hit.ns)[:, None]
                cand = (alive & (pdf_l > 1e-12) & ~spec.is_black(li)
                        & ~spec.is_black(f))
                sray = isect.spawn_shadow_ray(hit.p, hit.ng, wi, dist, cand,
                                              ray.wavelength, time=ray.time)
                occ = isect.occluded(
                    scene, sray, ignore_light=isect.nee_ignore_light(scene, l))
                L = L + torch.where((cand & ~occ)[:, None],
                                    beta * f * li / pdf_l[:, None] * n_lights,
                                    0.0)
            # specular continuation only (whitted.cpp:80-92)
            wi_l, f, pdf, is_spec, _, _ = bsdf.sample_f(
                mat, wo_l, sdim(_bdim(bounce, 3)), sdim(_bdim(bounce, 4)),
                sdim(_bdim(bounce, 5)))
            wi_w = geom.frame_to_world(ss, ts, hit.ns, wi_l)
            alive = alive & is_spec & (pdf > 1e-12) & ~spec.is_black(f)
            beta = torch.where(alive[:, None], beta * f * (
                geom.absdot(wi_w, hit.ns)
                / torch.clamp(pdf, min=1e-12))[:, None], beta)
            # the JAX package spawns the continuation at time 0
            nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength)
            ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
        L = torch.where(torch.isfinite(L), L, 0.0)
        return torch.maximum(L, torch.zeros((), device=dev))
    return trace
