"""Light (particle) tracing, the adjoint transport direction (port of
pbrt_tpu.integrators.lighttracer; reference: src/integrators/bdpt.cpp's
light subpaths :427-436 and t=1 strategies, Film::AddSplat film.cpp:154).

Photons leave the lights (Light::Sample_Le, light.h:60), scatter through
the scene as a wavefront, and at every vertex connect to the camera: the
perspective importance We times the throughput is splatted to the film's
splat buffer (PerspectiveCamera::We / Sample_Wi, perspective.cpp:180+).
A photon pass at depth d makes d closest-hit and d any-hit intersect
calls (K1 and K2 on the card).

`sample_le` and `camera_we_splat` are shared with bdpt.py.  As in the
JAX package, photons shade without bump maps, texture footprints or the
mix dimension, sample hair without its third dimension, and the camera
is the perspective camera at cam_to_world's origin (its motion is not
followed).  The world-to-camera matrix and the film-plane area are
computed once a render (`camera_frame`), not once a vertex.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.samplers.samplers import sample_dim
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.utils.stats import span


@span("lights")
def sample_le(scene: ir.SceneData, l, u1, u2, u3, u4):
    """Sample an emitted ray from light l [B] (Light::Sample_Le).

    Returns (ray_o, ray_d, Le [B,31], pdf_pos * pdf_dir [B], n_light
    [B,3]).  Point-like lights (point, spot, goniometric, projection, and
    as in the JAX package distant and infinite ones from light_pos) emit
    over the uniform sphere, their spot cone and map folded into Le
    (lights.delta_emit_scale); area lights emit cosine-weighted from a
    uniform point of a mesh (by its triangles' area cdf) or a sphere.
    Kinds the scene does not bind are skipped, as lights.sample_li skips
    them."""
    kinds = set(scene.light_kinds)
    B = u1.shape[0]
    dev = u1.device
    has_mesh, has_sph = lights._has_area(scene)
    has_area = has_mesh or has_sph
    has_other = bool(kinds - {ir.LIGHT_AREA})
    l = torch.clamp(l.long(), 0, scene.light_L.shape[0] - 1)
    L = scene.light_L.index_select(0, l)

    if has_other:
        # point-family: a uniform sphere direction (point.cpp Sample_Le)
        d_pt = sampling.uniform_sample_sphere(u1, u2)
        pdf_pt = torch.full((B,), sampling.INV_4PI, device=dev)
    if has_area:
        inv_area = 1.0 / torch.clamp(scene.light_area[l], min=1e-9)
        if has_sph:
            # an area sphere: a uniform point on it, the normal there
            n_sph = sampling.uniform_sample_sphere(u1, u2)
            p_sph = (scene.light_sph_center[l]
                     + scene.light_sph_radius[l][:, None] * n_sph)
        if has_mesh:
            # a mesh light: a triangle by its area cdf, a uniform point
            T = scene.light_tri_idx.shape[1]
            cdf = scene.light_tri_cdf[l]
            ti = torch.clamp((cdf <= u1[:, None]).sum(-1) - 1, 0, T - 1)
            row = scene.light_tri_packed[l * T + ti]
            c0 = torch.gather(cdf, 1, ti[:, None])[:, 0]
            c1 = torch.gather(cdf, 1, ti[:, None] + 1)[:, 0]
            u1r = torch.clamp((u1 - c0) / torch.clamp(c1 - c0, min=1e-9),
                              0.0, 0.999999)
            bc = sampling.uniform_sample_triangle(u1r, u2)
            p_tri = (row[:, 0:3] + bc[:, 0:1] * row[:, 3:6]
                     + bc[:, 1:2] * row[:, 6:9])
            n_tri = geom.normalize(geom.cross(row[:, 3:6], row[:, 6:9]))
            n_tri = torch.where((row[:, 9] > 0.5)[:, None], -n_tri, n_tri)
        if has_mesh and has_sph:
            is_mesh = (scene.light_quad[l] < 0)[:, None]
            p_area = torch.where(is_mesh, p_tri, p_sph)
            n_area = torch.where(is_mesh, n_tri, n_sph)
        elif has_mesh:
            p_area, n_area = p_tri, n_tri
        else:
            p_area, n_area = p_sph, n_sph
        # a cosine-weighted emission direction about the light's normal
        t1, t2 = geom.coordinate_system(n_area)
        d_loc = sampling.cosine_sample_hemisphere(u3, u4)
        d_area = geom.frame_to_world(t1, t2, n_area, d_loc)
        pdf_area = inv_area * (torch.clamp(d_loc[:, 2], min=1e-9)
                               * sampling.INV_PI)

    if has_area and has_other:
        is_area = (scene.light_type[l] == ir.LIGHT_AREA)
        ia = is_area[:, None]
        o = torch.where(ia, p_area, scene.light_pos[l])
        d = torch.where(ia, d_area, d_pt)
        pdf = torch.where(is_area, pdf_area, pdf_pt)
        n_l = torch.where(ia, n_area, d)
    elif has_area:
        o, d, pdf, n_l = p_area, d_area, pdf_area, n_area
    elif has_other:
        o, d, pdf = scene.light_pos[l], d_pt, pdf_pt
        n_l = d
    else:
        o = torch.zeros((B, 3), device=dev)
        d = torch.zeros((B, 3), device=dev)
        d[:, 2] = 1.0
        pdf = torch.zeros(B, device=dev)
        n_l = d
    # the spot cone's falloff and a goniometric / projection map fold into
    # Le, so that uniform-sphere sampling of delta emitters stays unbiased
    L = L * lights.delta_emit_scale(scene, l, d)[:, None]
    return o, d, L, pdf, n_l


@dataclass
class CameraFrame:
    """What a camera connection needs of a perspective camera, computed
    once a render: the world-to-camera matrix, the film-plane area at
    z = 1 and the camera's position."""
    w2c: torch.Tensor      # [4,4]
    area: torch.Tensor     # []
    pos: torch.Tensor      # [3]


def camera_frame(camera, width, height):
    """The CameraFrame of a projective camera for a width x height film."""
    if getattr(camera, "raster_to_camera", None) is None:
        raise NotImplementedError(
            "a camera connection needs a projective camera: the lens "
            "cameras' importance is not ported")
    r2c = camera.raster_to_camera
    corners = torch.tensor([[0.0, 0.0, 0.0], [float(width), 0.0, 0.0],
                            [0.0, float(height), 0.0]], device=r2c.device)
    cc = tfm.xform_point(r2c, corners)
    cc = cc / cc[:, 2:3]
    area = torch.abs((cc[1, 0] - cc[0, 0]) * (cc[2, 1] - cc[0, 1]))
    # (inverted on the host: a 4x4 needs no device solver)
    w2c = torch.linalg.inv(camera.cam_to_world.cpu()).to(r2c.device)
    return CameraFrame(w2c=w2c, area=area,
                       pos=camera.cam_to_world[:3, 3])


def camera_we_splat(camera, width, height, p, frame=None):
    """Perspective importance at world points p [B,3]: (pfilm [B,2], We
    [B], valid [B]) (PerspectiveCamera::We / Sample_Wi, perspective.cpp:
    180-250); We = 1 / (A cos^4 theta), A the film-plane area at z = 1.
    valid: in front of the camera and inside the film.  frame:
    camera_frame's, computed here when None."""
    if frame is None:
        frame = camera_frame(camera, width, height)
    pc = tfm.xform_point(frame.w2c, p)
    valid = pc[:, 2] > 1e-4
    # camera_to_raster is projective: xform_point divides by w
    pras = tfm.xform_point(camera.camera_to_raster, pc)
    inb = ((pras[:, 0] >= 0) & (pras[:, 0] < width)
           & (pras[:, 1] >= 0) & (pras[:, 1] < height))
    # the cosine to the camera's axis, in camera space
    cos_t = torch.clamp(pc[:, 2] / torch.clamp(geom.length(pc), min=1e-9),
                        min=1e-4)
    we = 1.0 / (frame.area * cos_t ** 4)
    return pras[:, :2], we, valid & inb


def make_trace_lighttracer(camera, width, height):
    """A film-updating photon pass, light_pass(scene, film, pixel_id,
    sample_idx, cfg, max_depth=5) -> film: B = len(pixel_id) photons, one
    a lane, each splatting every vertex's camera connection into
    film.splat."""
    frame = camera_frame(camera, width, height)

    def light_pass(scene, film, pixel_id, sample_idx, cfg, max_depth=5):
        B = pixel_id.shape[0]
        dev = pixel_id.device
        nl = max(scene.n_lights, 1)

        def sdim(dim):
            return sample_dim(cfg, pixel_id, sample_idx, dim)

        l = torch.clamp((sdim(0) * nl).to(torch.int64), max=nl - 1)
        o, d, Le, pdf, n_l = sample_le(scene, l, sdim(1), sdim(2), sdim(3),
                                       sdim(4))
        cos0 = torch.abs(geom.dot(n_l, d))
        beta = Le * (nl * cos0 / torch.clamp(pdf, min=1e-12))[:, None]
        ray = isect.spawn_ray(o, n_l, d, torch.full((B,), 550.0, device=dev))
        alive = pdf > 1e-12
        cam_p = frame.pos[None, :]
        for bounce in range(max_depth):
            hit = isect.intersect_full(scene, ray)
            alive = alive & hit.valid
            mat = bsdf.gather_materials(scene, hit.material, uv=hit.uv,
                                        p=hit.p)
            ss, ts = bsdf.shading_frame(scene, hit)
            wo_l = geom.world_to_frame(ss, ts, hit.ns, hit.wo)

            # ---- connect the vertex to the camera (t = 1) ----
            to_cam = cam_p - hit.p
            dist = geom.length(to_cam)
            wi_c = to_cam / torch.clamp(dist, min=1e-9)[:, None]
            pfilm, we, cam_ok = camera_we_splat(camera, width, height, hit.p,
                                                frame)
            wi_c_l = geom.world_to_frame(ss, ts, hit.ns, wi_c)
            f = bsdf.eval_f(mat, wo_l, wi_c_l) * \
                geom.absdot(wi_c, hit.ns)[:, None]
            cand = alive & cam_ok & ~spec.is_black(f)
            sray = isect.spawn_ray(hit.p, hit.ng, wi_c, ray.wavelength,
                                   tmax=torch.where(cand, dist * 0.999,
                                                    -1.0))
            occ = isect.occluded(scene, sray)
            contrib = beta * f * (we / torch.clamp(dist * dist,
                                                   min=1e-9))[:, None]
            filmmod.add_splats(film, pfilm, torch.where(
                (cand & ~occ)[:, None], contrib, 0.0))

            # ---- continue the photon ----
            base = 8 + bounce * 4
            wi_l, f_s, pdf_s, _, _, _ = bsdf.sample_f(
                mat, wo_l, sdim(base), sdim(base + 1), sdim(base + 2))
            wi_w = geom.frame_to_world(ss, ts, hit.ns, wi_l)
            ok = (pdf_s > 1e-12) & ~spec.is_black(f_s)
            beta = torch.where(
                (alive & ok)[:, None],
                beta * f_s * (geom.absdot(wi_w, hit.ns)
                              / torch.clamp(pdf_s, min=1e-12))[:, None],
                beta)
            alive = alive & ok
            nray = isect.spawn_ray(hit.p, hit.ng, wi_w, ray.wavelength)
            ray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
        return film

    return light_pass


def render_lighttracer(scene, camera, film, cfg, spp, max_depth=5):
    """Render by particle tracing alone, into film.splat in place: spp
    passes of B = W*H photons, photon ids 0 .. B-1 at sample index s.
    Returns (film, splat scale W*H / (B * spp) = 1 / spp), the scale that
    puts the splats in the forward estimator's radiance units (bdpt.cpp
    Render's lightImage)."""
    H, W = film.height, film.width
    light_pass = make_trace_lighttracer(camera, W, H)
    pid = torch.arange(H * W, dtype=torch.int64, device=film.splat.device)
    for s in range(spp):
        light_pass(scene, film, pid, torch.full_like(pid, s), cfg,
                   max_depth)
    return film, 1.0 / spp
