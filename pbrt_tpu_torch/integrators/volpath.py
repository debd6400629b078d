"""Volumetric path tracing (port of pbrt_tpu.integrators.volpath;
reference: src/integrators/volpath.cpp).

The wavefront loop of integrators/path.py with a free flight through the
medium on each segment: a lane that scatters in the medium does NEE and
samples its next direction with the Henyey-Greenstein phase function, a
lane that reaches a surface does the BSDF's, both under masks
(volpath.cpp:55-190).  Shadow rays carry the transmittance of the media
they cross (VisibilityTester::Tr, light.cpp:63).

Two forms, as in the JAX package:
- one scene medium (a MakeNamedMedium that no MediumInterface binds):
  `make_trace_volpath_medium`, closed-form homogeneous or delta / ratio
  tracked grid, with an occlusion test and the medium's Tr for shadows;
- media bound to shapes through MediumInterface (SceneData
  has_prim_media): each lane carries its current medium, switched where
  its path crosses a transmissive surface, and a grid lane delta-tracks
  through its own grid; shadow rays take the interface walk
  (ops/intersect.py::intersect_tr_walk).

Each bounce runs a closest-hit `intersect` and then its shadow query
(K1 and K2 each), in the JAX package's order; the camera batch skips the
coherence sort (its scanline order is tile-coherent), as trace_paths
does.  Lights are picked
uniformly (JAX's volpath takes no light strategy).  What the JAX package
does and the reference does not is kept, with its tests: grid tracking
and the shadow walk draw their samples at salts 256 apart a bounce, so
their dimensions overlap from one bounce to the next; the shadow walk
treats a grid as homogeneous when it is given no pixel ids; and the
per-lane grid walks stop after media.LANE_TRACK_STEPS majorant steps.
Surface lanes shade in bsdf.shading_frame (fiber-aligned on hair) and
take the path integrator's BSSRDF probe event (path._sss_event) in a
scene with subsurface materials, as volpath.cpp handles subsurface;
its probe passes are closest-hit intersect calls of their own.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.integrators.path import _bdim, _sss_event
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.media import media as medmod
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import sample_dim

#: each bounce's salt base for the medium's samples, and its stride
SALT_BASE = 0x9000
SALT_STRIDE = 256


def make_trace_volpath_medium(medium: medmod.MediumData):
    """trace_fn(scene, ray, pixel_id, sample_idx, cfg, max_depth=5) -> L
    [B,31] with `medium` as the scene's medium (unless the scene binds
    media to its shapes: then those)."""

    def trace(scene, ray, pixel_id, sample_idx, cfg, max_depth=5,
              rr_threshold=1.0, **kw):
        return trace_volpath(scene, ray, pixel_id, sample_idx, cfg, medium,
                             max_depth=max_depth, rr_threshold=rr_threshold)

    return trace


def _lane_media(scene, cur_med, ray, dnorm, t_seg, pixel_id, sample_idx,
                salt):
    """The per-lane free flight of the MediumInterface form: (t_m,
    in_medium, weight [B,31], g_eff [B])."""
    K = scene.med_sigma_a.shape[0]
    mk = torch.clamp(cur_med, 0, K - 1).long()
    in_any = cur_med >= 0
    lane_sa = torch.where(in_any[:, None], scene.med_sigma_a[mk], 0.0)
    lane_ss = torch.where(in_any[:, None], scene.med_sigma_s[mk], 0.0)
    g_eff = torch.where(in_any, scene.med_g[mk], 0.0)
    is_grid = in_any & scene.med_is_grid[mk]
    t_m, in_medium, w_med = medmod.sample_distance_lanes(
        lane_sa, lane_ss,
        torch.where(is_grid, 0.0, t_seg) if scene.has_grid_media else t_seg,
        pixel_id, sample_idx, salt)
    if scene.has_grid_media:
        # bound grids: per-lane delta tracking (grid.cpp:62-88), weight
        # sigma_s / sigma_t at an event and 1 at escape; a lane outside
        # every grid tracks over an empty segment, so that the loop's
        # early exit does not wait on it
        st_b = (lane_sa + lane_ss).amax(-1)
        t_g, hit_g = medmod.sample_distance_grid_lanes(
            scene.med_density, scene.med_dims, scene.med_w2m[mk],
            scene.med_inv_maxd[mk], st_b, ray.o, dnorm,
            torch.where(is_grid, t_seg, 0.0), mk, pixel_id, sample_idx,
            salt + 8)
        w_g = torch.where(hit_g[:, None],
                          lane_ss / torch.clamp(st_b, min=1e-9)[:, None], 1.0)
        t_m = torch.where(is_grid, t_g, t_m)
        in_medium = torch.where(is_grid, hit_g, in_medium)
        w_med = torch.where(is_grid[:, None], w_g, w_med)
    return t_m, in_medium, w_med, g_eff


def trace_volpath(scene, ray, pixel_id, sample_idx, cfg, medium,
                  max_depth=5, rr_threshold=1.0):
    """Radiance [B,31] of a batch of camera rays through the scene's
    media (module docstring)."""
    B = ray.o.shape[0]
    dev = ray.o.device
    NS = spec.N_SPECTRAL_SAMPLES

    def sdim(dim):
        return sample_dim(cfg, pixel_id, sample_idx, dim)

    L = torch.zeros((B, NS), device=dev)
    beta = torch.ones_like(L)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    specular = torch.ones_like(alive)
    prev_pdf = torch.ones(B, device=dev)
    prev_p = ray.o
    n_lights = max(scene.n_lights, 1)
    per_prim = scene.has_prim_media
    if per_prim:
        cur_med = torch.full((B,), scene.camera_medium, dtype=torch.int32,
                             device=dev)
    for bounce in range(max_depth + 1):
        hit = isect.intersect_full(scene, ray, presorted=bounce == 0)
        dnorm = geom.normalize(ray.d)
        t_seg = torch.where(hit.valid, hit.t,
                            torch.clamp(ray.tmax, max=2 * scene.world_radius))
        t_seg = torch.clamp(t_seg, min=0.0)

        # ---- the medium's free flight over the segment ----
        salt = SALT_BASE + bounce * SALT_STRIDE
        if per_prim:
            t_m, in_medium, w_med, g_eff = _lane_media(
                scene, cur_med, ray, dnorm, t_seg, pixel_id, sample_idx, salt)
        else:
            g_eff = medium.g
            t_m, in_medium, w_med = medmod.sample_distance(
                medium, ray.o, dnorm, t_seg, pixel_id, sample_idx, salt)
        in_medium = in_medium & alive
        beta = beta * torch.where(alive[:, None], w_med, 1.0)

        # ---- emission where the segment reached a surface ----
        le = lights.area_le(scene, hit.light, hit.ng, hit.wo)
        if bounce == 0:
            w_hit = torch.ones(B, device=dev)
        else:
            pdf_light = lights.pdf_li_area(scene, hit.light, prev_p, dnorm,
                                           hit.t, hit.ng) / n_lights
            w_hit = torch.where(specular, 1.0, sampling.power_heuristic(
                1.0, prev_pdf, 1.0, pdf_light))
        L = L + torch.where((alive & ~in_medium & hit.valid)[:, None],
                            beta * le * w_hit[:, None], 0.0)
        if scene.has_infinite:
            env = lights.env_le(scene, dnorm)
            if bounce == 0:
                w_env = torch.ones(B, device=dev)
            else:
                w_env = torch.where(specular, 1.0, sampling.power_heuristic(
                    1.0, prev_pdf, 1.0,
                    lights.pdf_li_infinite(scene, dnorm) / n_lights))
            L = L + torch.where((alive & ~in_medium & ~hit.valid)[:, None],
                                beta * env * w_env[:, None], 0.0)
        alive = alive & (hit.valid | in_medium)
        if bounce == max_depth:
            break

        p_med = ray.o + t_m[:, None] * dnorm
        p_vert = torch.where(in_medium[:, None], p_med, hit.p)

        # ---- NEE from the vertex: the phase function or the BSDF ----
        mat = bsdf.gather_materials(scene, hit.material, uv=hit.uv, p=hit.p)
        ss, ts = bsdf.shading_frame(scene, hit)
        # the BSSRDF probe relocation of surface lanes (path._sss_event)
        if scene.has_sss:
            hit, mat, beta, alive_s, _ = _sss_event(
                scene, hit, mat, beta, alive & ~in_medium & hit.valid, ss,
                ts, sdim, bounce, ray.wavelength)
            alive = torch.where(in_medium, alive, alive_s)
            ss, ts = bsdf.shading_frame(scene, hit)
            p_vert = torch.where(in_medium[:, None], p_med, hit.p)
        wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)
        if scene.n_lights > 0:
            l = torch.clamp((sdim(_bdim(bounce, 0)) * n_lights)
                            .to(torch.int64), max=n_lights - 1)
            wi, li, pdf_l, dist, delta_l = lights.sample_li(
                scene, l, p_vert, hit.ns, sdim(_bdim(bounce, 1)),
                sdim(_bdim(bounce, 2)))
            wi_l = geom.world_to_frame(ss, ts, hit.ns, wi)
            f_surf = bsdf.eval_f(mat, wo_l, wi_l) * \
                geom.absdot(wi, hit.ns)[:, None]
            pdf_b_surf = bsdf.pdf_f(mat, wo_l, wi_l)
            # in the medium: the phase function, whose pdf is its value
            ph = medmod.hg_p(g_eff, geom.dot(-dnorm, wi))
            f = torch.where(in_medium[:, None], ph[:, None].expand(B, NS),
                            f_surf)
            pdf_b = torch.where(in_medium, ph, pdf_b_surf)
            cand = (alive & (pdf_l > 1e-12) & ~spec.is_black(li)
                    & ~spec.is_black(f))
            sp_org = torch.where(in_medium[:, None], p_med, hit.p)
            sp_n = torch.where(in_medium[:, None], wi, hit.ng)
            ignore = isect.nee_ignore_light(scene, l)
            if per_prim:
                # the walk across medium interfaces (Scene::IntersectTr,
                # scene.cpp:57-81): each sub-segment's Tr in the medium
                # that fills it
                scale = torch.clamp(torch.abs(sp_org).amax(-1), min=1.0)
                eps = (1e-4 * scale)[:, None]
                off = torch.where(geom.dot(wi, sp_n)[:, None] >= 0, eps,
                                  -eps) * sp_n
                occ, optical, tr_ratio = isect.intersect_tr_walk(
                    scene, sp_org + off, wi,
                    (dist - geom.dot(off, wi)) * 0.999, cand, cur_med,
                    ray.wavelength, time=ray.time, ignore_light=ignore,
                    pixel_id=pixel_id, sample_idx=sample_idx,
                    dim_salt=salt + 64)
                tr = torch.exp(-optical) * tr_ratio[:, None]
            else:
                sray = isect.spawn_shadow_ray(sp_org, sp_n, wi, dist, cand,
                                              ray.wavelength, time=ray.time)
                occ = isect.occluded(scene, sray, ignore_light=ignore)
                sh_dist = torch.where(torch.isfinite(dist), dist,
                                      2 * scene.world_radius)
                tr = medmod.transmittance(medium, sp_org, wi, sh_dist,
                                          pixel_id, sample_idx, salt + 128)
            w_l = torch.where(delta_l, 1.0, sampling.power_heuristic(
                1.0, pdf_l, 1.0, pdf_b))
            contrib = beta * f * li * tr * (
                w_l / torch.clamp(pdf_l, min=1e-12) * n_lights)[:, None]
            L = L + torch.where((cand & ~occ)[:, None], contrib, 0.0)

        # ---- the next direction ----
        ub1, ub2 = sdim(_bdim(bounce, 4)), sdim(_bdim(bounce, 5))
        wi_l, f_s, pdf_s, is_spec, transmitted, _ = bsdf.sample_f(
            mat, wo_l, sdim(_bdim(bounce, 3)), ub1, ub2)
        wi_surf = geom.frame_to_world(ss, ts, hit.ns, wi_l)
        cos_t = geom.absdot(wi_surf, hit.ns)
        ok_s = (pdf_s > 1e-12) & ~spec.is_black(f_s)
        beta_s = f_s * (cos_t / torch.clamp(pdf_s, min=1e-12))[:, None]
        # a medium vertex samples the phase function about the
        # propagation direction (its pdf is its value: beta is kept)
        wi_med, ph_pdf = medmod.hg_sample(g_eff, -dnorm, ub1, ub2)
        wi_new = torch.where(in_medium[:, None], wi_med, wi_surf)
        alive = alive & (in_medium | ok_s)
        beta = torch.where(alive[:, None], beta * torch.where(
            in_medium[:, None], 1.0, beta_s), beta)
        specular = ~in_medium & is_spec
        prev_pdf = torch.where(in_medium, ph_pdf, pdf_s)
        prev_p = p_vert
        org_n = torch.where(in_medium[:, None], wi_new, hit.ng)
        nray = isect.spawn_ray(p_vert, org_n, wi_new, ray.wavelength,
                               time=ray.time)
        ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
        if per_prim:
            # crossing a transmissive surface takes the primitive's
            # inside or outside medium
            entering = geom.dot(wi_new, hit.ng) < 0
            new_med = torch.where(entering, scene.prim_medium_in[hit.prim],
                                  scene.prim_medium_out[hit.prim])
            crossed = alive & ~in_medium & hit.valid & transmitted
            cur_med = torch.where(crossed, new_med, cur_med)

        # ---- Russian roulette on beta (volpath.cpp:208) ----
        if bounce > 3:
            rr_max = beta.amax(-1)
            q = torch.clamp(1.0 - rr_max.detach(), 0.05, 0.99)
            apply_rr = rr_max < rr_threshold
            alive = alive & ~(apply_rr & (sdim(_bdim(bounce, 6)) < q))
            beta = beta * torch.where(apply_rr & alive, 1.0 / (1.0 - q),
                                      1.0)[:, None]
            ray = ray.replace(tmax=torch.where(alive, ray.tmax, -1.0))

    L = torch.where(torch.isfinite(L), L, 0.0)
    return torch.maximum(L, torch.zeros((), device=dev))


def build_medium_from_job(job, device):
    """The scene medium of a parsed job: the first MakeNamedMedium that no
    MediumInterface binds (those are tracked per lane), or no medium
    (reference dispatch: api.cpp:699-745).  A grid's box is its p0 / p1
    alone, as in the JAX package (the creation CTM is not applied)."""
    skip = set(job.prim_media_names)
    for name, m in job.media.items():
        if name in skip:
            continue
        sig_a, sig_s, g = medmod.medium_coefficients(m["params"])
        grid = medmod.medium_grid(m)
        if grid is not None:
            return medmod.make_grid(sig_a, sig_s, g, grid[0], grid[1],
                                    device=device)
        return medmod.make_homogeneous(sig_a, sig_s, g, device=device)
    return medmod.no_medium(device=device)


def make_trace_volpath(job):
    """volpath's trace_fn for a parsed job, on its scene's device."""
    return make_trace_volpath_medium(
        build_medium_from_job(job, job.scene.device))
