"""Stochastic progressive photon mapping (port of
pbrt_tpu.integrators.sppm; reference: src/integrators/sppm.cpp).

The reference walks photons through a spatial hash grid over the
pixels' visible points with atomic flux adds (sppm.cpp:87-107).  As in
the JAX package the gather is dense: every photon is tested against every
visible point, d2 = (dx*dx + dy*dy) + dz*dz against the point's r2.  On
the card `gather` is one launch of csrc/sppm_gather.cu a call: a thread
keeps its visible point's tau_add [31] and M in registers, tests every
photon staged in shared memory and adds the rows of its hits in photon
order, so no pair's intermediate reaches device memory and two launches
give the same bits.  Its plain twin `gather_plain`, which the CPU runs,
is the JAX package's chunk loop: per 1,024-photon chunk d2 [V, Pc] from
the [V, Pc, 3] differences and the masked product tau_add += mask [V,Pc]
@ beta [Pc,31] (torch.matmul; the caller keeps TF32 off).  The two test
the same pairs with the same expression; only the order of the f32
additions into tau_add differs.

Per-pixel state follows the reference: the radius shrinks as
r' = r sqrt((N + a M) / (N + M)), the flux rescales by r'^2 / r^2
(alpha = 2/3), direct light and emission are accumulated in the camera
pass, and photons deposit only after their first bounce.  An iteration
at depth d makes d + 1 camera closest-hit calls, d NEE any-hit calls and
d photon closest-hit calls (K1 and K2 on the card).  As in the JAX
package, the visible point keeps the diffuse part kd / pi of matte,
plastic, uber, substrate and retroreflective surfaces only.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import rng
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.integrators.lighttracer import sample_le
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import sample_dim
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.utils.stats import span

ALPHA = 2.0 / 3.0
#: photons a gather step tests against every visible point
PHOTON_CHUNK = 1024
#: photon ids start here (above any pixel id of the camera pass)
PHOTON_ID_BASE = 0x50000000
_DIFFUSE = (ir.MAT_MATTE, ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_SUBSTRATE,
            ir.MAT_RETRO)
#: launches of csrc/sppm_gather.cu made by `gather` (gather_plain never
#: counts): an SPPM iteration at depth d makes d - 1
LAUNCHES = {"sppm_gather": 0}


def camera_pass(scene, camera, W, H, cfg, it, max_depth, generate_rays=None):
    """Camera paths to their first diffuse vertex, NEE at each vertex.
    Returns (Ld [V,31], vp_p [V,3], vp_f [V,31] = beta kd / pi, vp_valid
    [V], pfilm [V,2]) for the V = W*H pixels at sample `it`."""
    V = W * H
    dev = scene.device
    pixel_id = torch.arange(V, dtype=torch.int64, device=dev)
    ray, weight, pfilm, pid, sidx = pathmod.camera_rays_for_pixels(
        camera, W, H, cfg, pixel_id, it, generate_rays)

    def sdim(dim):
        return sample_dim(cfg, pid, sidx, dim)

    NS = spec.N_SPECTRAL_SAMPLES
    Ld = torch.zeros((V, NS), device=dev)
    beta = torch.ones((V, NS), device=dev) * weight[:, None]
    alive = weight > 0
    vp_p = torch.zeros((V, 3), device=dev)
    vp_f = torch.zeros((V, NS), device=dev)
    vp_found = torch.zeros(V, dtype=torch.bool, device=dev)
    n_lights = max(scene.n_lights, 1)
    for bounce in range(max_depth + 1):
        hit = isect.intersect_full(scene, ray)
        # every continuation is specular, so emission counts un-MIS'd
        le = lights.area_le(scene, hit.light, hit.ng, hit.wo)
        Ld = Ld + torch.where((alive & hit.valid)[:, None], beta * le, 0.0)
        if scene.has_infinite:
            env = lights.env_le(scene, geom.normalize(ray.d))
            Ld = Ld + torch.where((alive & ~hit.valid)[:, None], beta * env,
                                  0.0)
        alive = alive & hit.valid
        if bounce == max_depth:
            break
        mat = bsdf.gather_materials(scene, hit.material, uv=hit.uv, p=hit.p)
        ss, ts = bsdf.shading_frame(scene, hit)
        wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)
        is_diffuse = torch.zeros_like(alive)
        for mt in _DIFFUSE:
            is_diffuse = is_diffuse | (mat.type == mt)
        # the first diffuse vertex is the pixel's visible point
        record = alive & is_diffuse & ~vp_found
        vp_p = torch.where(record[:, None], hit.p, vp_p)
        vp_f = torch.where(record[:, None], beta * mat.kd * sampling.INV_PI,
                           vp_f)
        vp_found = vp_found | record

        # NEE at every vertex up to the visible point's
        if scene.n_lights > 0:
            l = torch.clamp((sdim(pathmod._bdim(bounce, 0)) * n_lights)
                            .to(torch.int64), max=n_lights - 1)
            wi, li, pdf_l, dist, _ = lights.sample_li(
                scene, l, hit.p, hit.ns, sdim(pathmod._bdim(bounce, 1)),
                sdim(pathmod._bdim(bounce, 2)))
            wi_l = geom.world_to_frame(ss, ts, hit.ns, wi)
            f = bsdf.eval_f(mat, wo_l, wi_l) * \
                geom.absdot(wi, hit.ns)[:, None]
            cand = (alive & (pdf_l > 1e-12) & ~spec.is_black(li)
                    & ~spec.is_black(f))
            sray = isect.spawn_shadow_ray(hit.p, hit.ng, wi, dist, cand,
                                          ray.wavelength, time=ray.time)
            occ = isect.occluded(scene, sray, ignore_light=isect
                                 .nee_ignore_light(scene, l))
            Ld = Ld + torch.where(
                (cand & ~occ)[:, None],
                beta * f * li / torch.clamp(pdf_l, min=1e-12)[:, None]
                * n_lights, 0.0)

        # go on through specular lobes only (the visible point ends it)
        wi_l, f_s, pdf_s, is_spec, _, _ = bsdf.sample_f(
            mat, wo_l, sdim(pathmod._bdim(bounce, 3)),
            sdim(pathmod._bdim(bounce, 4)), sdim(pathmod._bdim(bounce, 5)))
        wi_w = geom.frame_to_world(ss, ts, hit.ns, wi_l)
        cont = alive & is_spec & ~vp_found & (pdf_s > 1e-12)
        beta = torch.where(
            cont[:, None],
            beta * f_s * (geom.absdot(wi_w, hit.ns)
                          / torch.clamp(pdf_s, min=1e-12))[:, None], beta)
        alive = cont
        nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength)
        ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
    return Ld, vp_p, vp_f, vp_found, pfilm


@span("gather")
def gather(vp_p, vp_valid, r2, p, alive, beta, tau_add, M):
    """Deposit photons at p [P,3] (live where `alive`, throughput beta
    [P,31]) on the visible points vp_p [V,3] (valid where vp_valid) within
    their radius (r2 [V] squared): returns tau_add [V,31] and M [V] with
    the deposits and the counts added.  It writes none of its inputs, on
    either device.

    CUDA tensors: one launch of csrc/sppm_gather.cu (f32, contiguous, one
    device; vp_valid and alive bool); a wrong input raises, and so does the
    launch's error.  CPU tensors: gather_plain."""
    if dense._on_cpu(vp_p, vp_valid, r2, p, alive, beta, tau_add, M):
        return gather_plain(vp_p, vp_valid, r2, p, alive, beta, tau_add, M)
    V, P = vp_p.shape[0], p.shape[0]
    NS = spec.N_SPECTRAL_SAMPLES
    f32, b = torch.float32, torch.bool
    for name, x, dtype, shape in (
            ("vp_p", vp_p, f32, (V, 3)), ("vp_valid", vp_valid, b, (V,)),
            ("r2", r2, f32, (V,)), ("p", p, f32, (P, 3)),
            ("alive", alive, b, (P,)), ("beta", beta, f32, (P, NS)),
            ("tau_add", tau_add, f32, (V, NS)), ("M", M, f32, (V,))):
        dense._check(name, x, dtype, shape)
        if x.device != vp_p.device:
            raise ValueError(f"gather: {name} is on {x.device}, vp_p on "
                             f"{vp_p.device}")
    if V == 0 or P == 0:
        return tau_add, M
    from pbrt_tpu_torch.ops import cuda_kernels
    tau_out, M_out = torch.empty_like(tau_add), torch.empty_like(M)
    err = cuda_kernels.library().pbrt_sppm_gather(
        dense._ptr(vp_p), dense._ptr(vp_valid), dense._ptr(r2),
        dense._ptr(p), dense._ptr(alive), dense._ptr(beta),
        dense._ptr(tau_add), dense._ptr(M), V, P, dense._ptr(tau_out),
        dense._ptr(M_out), dense._stream())
    dense._raise_on(err, "sppm_gather")
    LAUNCHES["sppm_gather"] += 1
    return tau_out, M_out


def gather_plain(vp_p, vp_valid, r2, p, alive, beta, tau_add, M):
    """gather's plain twin: dense and pairwise, a photon chunk at a time
    (the JAX package's loop)."""
    dep_beta = torch.where(alive[:, None], beta, 0.0)
    for c0 in range(0, p.shape[0], PHOTON_CHUNK):
        pc = slice(c0, c0 + PHOTON_CHUNK)
        d2 = ((vp_p[:, None, :] - p[None, pc, :]) ** 2).sum(-1)   # [V,Pc]
        w = ((d2 <= r2[:, None]) & vp_valid[:, None]
             & alive[None, pc]).to(torch.float32)
        tau_add = tau_add + w @ dep_beta[pc]
        M = M + w.sum(-1)
    return tau_add, M


def photon_pass(scene, cfg, it, n_photons, max_depth, vp_p, vp_valid,
                radius):
    """Emit n_photons photons (ids PHOTON_ID_BASE + i at sample `it`) and
    deposit their flux on the visible points after their first bounce.
    Returns (tau_add [V,31], M [V] photon counts); render_sppm weights
    tau_add by the visible points' vp_f."""
    dev = vp_p.device
    NS = spec.N_SPECTRAL_SAMPLES
    V = vp_p.shape[0]
    pid = rng.u32(torch.arange(n_photons, dtype=torch.int64, device=dev)
                  + PHOTON_ID_BASE)
    sidx = torch.full_like(pid, int(it))

    def sdim(dim):
        return sample_dim(cfg, pid, sidx, dim)

    nl = max(scene.n_lights, 1)
    l = torch.clamp((sdim(0) * nl).to(torch.int64), max=nl - 1)
    o, d, Le, pdf, n_l = sample_le(scene, l, sdim(1), sdim(2), sdim(3),
                                   sdim(4))
    cos0 = torch.abs(geom.dot(n_l, d))
    beta = Le * (nl * cos0 / torch.clamp(pdf, min=1e-12))[:, None]
    ray = isect.spawn_ray(o, n_l, d, torch.full((n_photons,), 550.0,
                                                device=dev))
    alive = pdf > 1e-12
    tau_add = torch.zeros((V, NS), device=dev)
    M = torch.zeros(V, device=dev)
    r2 = radius * radius
    for bounce in range(max_depth):
        hit = isect.intersect_full(scene, ray)
        alive = alive & hit.valid
        # deposit after the first bounce only: direct light is the camera
        # pass's NEE (sppm.cpp's photon loop, depth > 0)
        if bounce > 0:
            tau_add, M = gather(vp_p, vp_valid, r2, hit.p, alive, beta,
                                tau_add, M)
        if bounce == max_depth - 1:
            break
        mat = bsdf.gather_materials(scene, hit.material, uv=hit.uv, p=hit.p)
        ss, ts = bsdf.shading_frame(scene, hit)
        wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)
        base = 8 + bounce * 4
        wi_l, f_s, pdf_s, _, _, _ = bsdf.sample_f(
            mat, wo_l, sdim(base), sdim(base + 1), sdim(base + 2))
        wi_w = geom.frame_to_world(ss, ts, hit.ns, wi_l)
        ok = (pdf_s > 1e-12) & ~spec.is_black(f_s)
        beta = torch.where(
            (alive & ok)[:, None],
            beta * f_s * (geom.absdot(wi_w, hit.ns)
                          / torch.clamp(pdf_s, min=1e-12))[:, None], beta)
        # photon Russian roulette on the throughput (sppm.cpp:370)
        q = torch.clamp(1.0 - beta.amax(-1), 0.0, 0.95)
        kill = sdim(base + 3) < q
        beta = beta / torch.clamp(1.0 - q, min=0.05)[:, None]
        alive = alive & ok & ~kill
        nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength)
        ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
    return tau_add, M


@span("job")
def render_sppm(scene, camera, W, H, cfg, n_iterations=8,
                initial_radius=None, max_depth=5, generate_rays=None):
    """The whole SPPM render: n_iterations of a camera pass over every
    pixel and V = W*H photons.  initial_radius defaults to the scene's
    world radius times 0.01.  Returns [H,W,31] radiance."""
    V = W * H
    dev = scene.device
    if initial_radius is None:
        initial_radius = float(scene.world_radius) * 0.01
    NS = spec.N_SPECTRAL_SAMPLES
    radius = torch.full((V,), float(initial_radius), device=dev)
    N = torch.zeros(V, device=dev)
    tau = torch.zeros((V, NS), device=dev)
    Ld_sum = torch.zeros((V, NS), device=dev)
    for it in range(n_iterations):
        with span("pass"):
            Ld, vp_p, vp_f, vp_valid, _ = camera_pass(
                scene, camera, W, H, cfg, it, max_depth, generate_rays)
            Ld_sum = Ld_sum + Ld
            tau_add, Mc = photon_pass(scene, cfg, it, V, max_depth, vp_p,
                                      vp_valid, radius)
            # the per-pixel radius and flux update (sppm.cpp:470-489)
            has = Mc > 0
            N_new = N + ALPHA * Mc
            r_new = radius * torch.sqrt(torch.where(
                has, N_new / torch.clamp(N + Mc, min=1e-9), 1.0))
            ratio = torch.where(
                has, (r_new / torch.clamp(radius, min=1e-12)) ** 2, 1.0)
            tau = (tau + vp_f * tau_add) * ratio[:, None]
            radius = torch.where(has, r_new, radius)
            N = torch.where(has, N_new, N)
    n_emitted = n_iterations * V
    L = Ld_sum / n_iterations + tau / (
        n_emitted * np.pi * torch.clamp(radius, min=1e-12)[:, None] ** 2)
    return L.reshape(H, W, NS)
