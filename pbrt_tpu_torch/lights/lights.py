"""The light table: sampling, pdfs and emitted radiance (port of
pbrt_tpu.lights.lights; reference: src/core/light.{h,cpp} and
src/lights/*, Shape::Sample / Pdf's solid-angle sampling of spheres and
triangles, shapes/sphere.cpp:232+, shapes/triangle.cpp:470+).

Each lane carries a light index; the kinds are evaluated under lane masks
and folded with `where`.  A kind the scene does not bind (its static
`light_kinds`, and `has_mesh_lights` / `has_sphere_lights` for area
lights) is never evaluated, so it launches nothing; the per-lane light
columns are plain gathers of the scene's light table.

NEE contract (as in the JAX package):
  sample_li(scene, l, p, n, u1, u2) -> (wi, Li, pdf_solid_angle, dist,
                                        is_delta)
  pdf_li_area(scene, l, prev_p, wi, hit_t, hit_ng) -> solid-angle pdf
  pdf_li_infinite(scene, wi) -> the infinite light's solid-angle pdf
  area_le(scene, light_idx, ng, wo) -> emission of a hit area light
  env_le(scene, d) -> the infinite light's radiance for escaped rays
  delta_emit_scale(scene, l, w) -> spot falloff / light-map factor

Env maps: the row and column of a direction are found with a per-lane
search of the sampling tables' cdfs (one gather a step), and the
luminance of the chosen cell is one gather of the scene's [He, We]
`env_lum` table, so no lane gathers a whole row of the map.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.textures.textures import eval_texture
from pbrt_tpu_torch.utils.stats import span

_MAPPED = {ir.LIGHT_GONIO, ir.LIGHT_PROJECTION}
_POINTISH = {ir.LIGHT_POINT, ir.LIGHT_SPOT} | _MAPPED
INF_DIST = 1e30          # the distance of a distant or infinite sample


def _has_area(scene):
    """(mesh lights bound, sphere lights bound)."""
    area = ir.LIGHT_AREA in scene.light_kinds
    return area and scene.has_mesh_lights, area and scene.has_sphere_lights


def _sample_mesh_area(scene, l, p, u1, u2):
    """Uniform-by-area sample on a mesh light (triangle.cpp:470+).

    Returns (wi, pdf, dist, cos_l); cos_l is the emission-side cosine."""
    T = scene.light_tri_idx.shape[1]
    cdf = scene.light_tri_cdf[l]                             # [B,T+1]
    ti = torch.clamp((cdf <= u1[:, None]).sum(-1) - 1, 0, T - 1)
    row = scene.light_tri_packed[l * T + ti]                 # [B,10]
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    c0 = torch.gather(cdf, 1, ti[:, None])[:, 0]
    c1 = torch.gather(cdf, 1, ti[:, None] + 1)[:, 0]
    u1r = torch.clamp((u1 - c0) / torch.clamp(c1 - c0, min=1e-9),
                      0.0, 0.999999)
    bc = sampling.uniform_sample_triangle(u1r, u2)
    q = v0 + bc[:, 0:1] * e1 + bc[:, 1:2] * e2
    n_l = geom.normalize(geom.cross(e1, e2))
    n_l = torch.where((row[:, 9] > 0.5)[:, None], -n_l, n_l)
    to_q = q - p
    dq2 = torch.clamp(geom.length_sq(to_q), min=1e-12)
    dq = torch.sqrt(dq2)
    wi = to_q / dq[:, None]
    cos_l = geom.dot(n_l, -wi)
    area = torch.clamp(scene.light_area[l], min=1e-12)
    pdf = dq2 / torch.clamp(torch.abs(cos_l) * area, min=1e-9)
    return wi, pdf, dq, cos_l


def _cone_cos_max(center, radius, p):
    """(|c - p|^2, cos of the half-angle a sphere subtends from p)."""
    dc2 = torch.clamp(geom.length_sq(center - p), min=1e-12)
    sin2_max = torch.clamp(radius * radius / dc2, 0.0, 1.0)
    return dc2, torch.sqrt(torch.clamp(1.0 - sin2_max, min=1e-14))


def _sample_sphere_area(scene, l, p, u1, u2):
    """Cone sampling toward a sphere light (sphere.cpp:232+).  A point
    inside the sphere gets pdf 0 (the JAX package's rule, where the
    reference samples the sphere's area).  Returns (wi, pdf, dist)."""
    center, radius = scene.light_sph_center[l], scene.light_sph_radius[l]
    to_c = center - p
    dc2, cos_max = _cone_cos_max(center, radius, p)
    dc = torch.sqrt(dc2)
    inside = dc2 <= radius * radius * 1.0001
    wz = geom.normalize(to_c)
    wx, wy = geom.coordinate_system(wz)
    cs = (1.0 - u1) + u1 * cos_max
    sn = torch.sqrt(torch.clamp(1.0 - cs * cs, min=1e-14))
    wi = geom.frame_to_world(wx, wy, wz, geom.spherical_direction(
        sn, cs, 2 * np.pi * u2))
    pdf = sampling.uniform_cone_pdf(cos_max)
    # the distance to the sphere along wi (law of cosines)
    ds = dc * cs - torch.sqrt(torch.clamp(radius * radius - dc2 * sn * sn,
                                          min=1e-14))
    return wi, torch.where(inside, 0.0, pdf), ds


def _mapped_scale(scene, lt, w_l, ldir, params):
    """The goniometric / projection map's factor for emission direction
    w_l (lights/goniometric.cpp, lights/projection.cpp): the mean of the
    map's RGB at the direction's (phi, theta) for goniometric lights, at
    its perspective projection for projection lights (0 outside the
    projection's cone)."""
    tex_id = params[:, 2].to(torch.int64)
    lx, ly = geom.coordinate_system(ldir)
    d_loc = torch.stack([geom.dot(w_l, lx), geom.dot(w_l, ly),
                         geom.dot(w_l, ldir)], -1)
    u_g = geom.spherical_phi(d_loc) * (0.5 / np.pi)
    v_g = geom.spherical_theta(d_loc) / np.pi
    cos_fov = params[:, 3]
    inside_p = d_loc[:, 2] > torch.clamp(cos_fov, min=1e-6)
    tan_half = torch.sqrt(torch.clamp(1.0 - cos_fov * cos_fov, min=1e-9)) \
        / torch.clamp(cos_fov, min=1e-6)
    zsafe = torch.clamp(d_loc[:, 2], min=1e-6)
    th = torch.clamp(tan_half, min=1e-9)
    u_p = 0.5 + 0.5 * (d_loc[:, 0] / zsafe) / th
    v_p = 0.5 + 0.5 * (d_loc[:, 1] / zsafe) / th
    uv_tex = torch.where((lt == ir.LIGHT_GONIO)[:, None],
                         torch.stack([u_g, v_g], -1),
                         torch.stack([u_p, v_p], -1))
    map_rgb = eval_texture(scene.tex_images, scene.tex_type,
                           scene.tex_params, scene.tex_c1, scene.tex_c2,
                           tex_id, uv_tex, w_l, kinds=scene.tex_kinds)
    return torch.where((lt == ir.LIGHT_PROJECTION) & ~inside_p, 0.0,
                       map_rgb.mean(-1))


def _spot_falloff(cos_t, params):
    """The spot light's smoothstep-free falloff (spot.cpp:60-76): 1 inside
    the falloff cone, delta^4 across the edge, 0 outside."""
    cos_total, cos_fall = params[:, 0], params[:, 1]
    delta = torch.clamp((cos_t - cos_total) / torch.clamp(
        cos_fall - cos_total, min=1e-6), 0.0, 1.0)
    return torch.where(cos_t < cos_total, 0.0,
                       torch.where(cos_t > cos_fall, 1.0, delta ** 4))


@span("lights")
def sample_li(scene: ir.SceneData, l, p, n, u1, u2):
    """Sample an incident direction from light l [B] toward points p [B,3].

    Returns (wi [B,3], Li [B,31], pdf [B] w.r.t. solid angle, dist [B],
    is_delta [B] bool).  dist is the distance to the sampled point, 1e30
    for distant and infinite lights; n is unused (the contract's)."""
    kinds = set(scene.light_kinds)
    B = p.shape[0]
    dev = p.device
    NS = spec.N_SPECTRAL_SAMPLES
    has_mesh, has_sph = _has_area(scene)
    if not (kinds - {ir.LIGHT_AREA}) and not (has_mesh or has_sph):
        # no light, or area lights with no geometry bound
        wi = torch.zeros((B, 3), device=dev)
        wi[:, 2] = 1.0
        return (wi, torch.zeros((B, NS), device=dev),
                torch.zeros(B, device=dev), torch.full((B,), INF_DIST,
                                                       device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))
    l = l.long()
    L = scene.light_L.index_select(0, l)    # (bsdf.gather_materials)
    lt = scene.light_type[l] if len(kinds) > 1 else None
    ones = torch.ones(B, device=dev)
    far = torch.full((B,), INF_DIST, device=dev)
    dirs = (scene.light_dir[l]
            if kinds & ({ir.LIGHT_SPOT, ir.LIGHT_DISTANT} | _MAPPED)
            else None)
    params = (scene.light_params[l] if kinds & ({ir.LIGHT_SPOT} | _MAPPED)
              else None)

    def mask(*types):
        if lt is None:
            return None
        m = lt == types[0]
        for t in types[1:]:
            m = m | (lt == t)
        return m

    # each bound kind appends (mask, wi, li, pdf, dist, is_delta); the
    # first is the base, later ones override under their masks
    cases = []
    if kinds & _POINTISH:
        # point-like emitters (lights/point.cpp): Li = I / r^2
        to_l = scene.light_pos[l] - p
        d2 = torch.clamp(geom.length_sq(to_l), min=1e-12)
        dist_pt = torch.sqrt(d2)
        wi_pt = to_l / dist_pt[:, None]
        li_pt = L / d2[:, None]
        if ir.LIGHT_POINT in kinds:
            cases.append((mask(ir.LIGHT_POINT), wi_pt, li_pt, ones, dist_pt,
                          True))
        if ir.LIGHT_SPOT in kinds:
            fall = _spot_falloff(geom.dot(-wi_pt, dirs), params)
            cases.append((mask(ir.LIGHT_SPOT), wi_pt, li_pt * fall[:, None],
                          ones, dist_pt, True))
        if kinds & _MAPPED:
            lt_m = lt if lt is not None else torch.full(
                (B,), next(iter(kinds & _MAPPED)), dtype=torch.int32,
                device=dev)
            scale = _mapped_scale(scene, lt_m, -wi_pt, dirs, params)
            cases.append((mask(ir.LIGHT_GONIO, ir.LIGHT_PROJECTION), wi_pt,
                          li_pt * scale[:, None], ones, dist_pt, True))
    if ir.LIGHT_DISTANT in kinds:
        cases.append((mask(ir.LIGHT_DISTANT), -dirs, L, ones, far, True))
    if has_mesh or has_sph:
        # area: a mesh (uniform by area) or a sphere (cone)
        if has_mesh:
            wi_m, pdf_m, dist_m, cos_l = _sample_mesh_area(scene, l, p, u1,
                                                           u2)
            li_m = torch.where((scene.light_two_sided[l]
                                | (cos_l > 0))[:, None], L, 0.0)
        if has_sph:
            wi_s, pdf_s, dist_s = _sample_sphere_area(scene, l, p, u1, u2)
        if has_mesh and has_sph:
            is_mesh = scene.light_quad[l] < 0
            wi_a = torch.where(is_mesh[:, None], wi_m, wi_s)
            li_a = torch.where(is_mesh[:, None], li_m, L)
            pdf_a = torch.where(is_mesh, pdf_m, pdf_s)
            dist_a = torch.where(is_mesh, dist_m, dist_s)
        elif has_mesh:
            wi_a, li_a, pdf_a, dist_a = wi_m, li_m, pdf_m, dist_m
        else:
            wi_a, li_a, pdf_a, dist_a = wi_s, L, pdf_s, dist_s
        cases.append((mask(ir.LIGHT_AREA), wi_a, li_a, pdf_a, dist_a, False))
    if ir.LIGHT_INFINITE in kinds:
        # infinite (lights/infinite.cpp): the env map's 2D distribution,
        # or the uniform sphere for a constant light
        if scene.env_map.shape[0] > 1 or scene.env_map.shape[1] > 1:
            wi_inf, pdf_inf = sample_env_direction(scene, u1, u2)
        else:
            wi_inf = sampling.uniform_sample_sphere(u1, u2)
            pdf_inf = torch.full_like(u1, sampling.INV_4PI)
        cases.append((mask(ir.LIGHT_INFINITE), wi_inf,
                      _env_radiance(scene, wi_inf), pdf_inf, far, False))

    _, wi, li, pdf, dist, dl0 = cases[0]
    is_delta = torch.full((B,), dl0, dtype=torch.bool, device=dev)
    for m, wi_k, li_k, pdf_k, dist_k, dl_k in cases[1:]:
        wi = torch.where(m[:, None], wi_k, wi)
        li = torch.where(m[:, None], li_k, li)
        pdf = torch.where(m, pdf_k, pdf)
        dist = torch.where(m, dist_k, dist)
        is_delta = torch.where(m, dl_k, is_delta)
    return wi, li, pdf, dist, is_delta


@span("lights")
def pdf_li_area(scene: ir.SceneData, light_idx, prev_p, wi, hit_t, hit_ng):
    """Solid-angle pdf that NEE at prev_p samples direction wi hitting an
    area light at distance hit_t with normal hit_ng (shape.cpp:136): mesh
    lights dist^2 / (|cos| area), sphere lights the cone's pdf."""
    has_mesh, has_sph = _has_area(scene)
    if not (has_mesh or has_sph):
        return torch.zeros_like(hit_t)
    l = torch.clamp(light_idx, 0, scene.light_L.shape[0] - 1).long()
    if has_mesh:
        cos_l = torch.abs(geom.dot(hit_ng, -wi))
        area = torch.clamp(scene.light_area[l], min=1e-12)
        pdf_mesh = hit_t * hit_t / torch.clamp(cos_l * area, min=1e-9)
    if has_sph:
        _, cos_max = _cone_cos_max(scene.light_sph_center[l],
                                   scene.light_sph_radius[l], prev_p)
        pdf_sph = sampling.uniform_cone_pdf(cos_max)
    if has_mesh and has_sph:
        return torch.where(scene.light_quad[l] < 0, pdf_mesh, pdf_sph)
    return pdf_mesh if has_mesh else pdf_sph


def _row_search(cdf_flat, stride, row, u, n):
    """Per lane, the number of entries of cdf row `row` (of `stride`
    entries in the flattened cdf_flat) among the first n that are <= u:
    a binary search of ceil(log2(n + 1)) gathers, equal to counting over
    the row since the row is non-decreasing."""
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, n)
    base = row * stride
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (lo + hi) // 2
        active = lo < hi
        le = cdf_flat[base + torch.clamp(mid, max=n - 1)] <= u
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    return lo


def sample_env_direction(scene: ir.SceneData, u1, u2):
    """Importance-sample the env map by its 2D cdf tables
    (InfiniteAreaLight::Sample_Li, infinite.cpp:109+).  Returns (wi [B,3],
    solid-angle pdf [B])."""
    He, We = scene.env_map.shape[:2]
    marg, cond_int = scene.env_marg_cdf, scene.env_cond_int
    # the row (theta) from the marginal cdf
    iv = torch.clamp(torch.searchsorted(marg, u2, right=True) - 1, 0, He - 1)
    m0, m1 = marg[iv], marg[iv + 1]
    dv = torch.where(m1 > m0, (u2 - m0) / torch.clamp(m1 - m0, min=1e-12),
                     0.0)
    v = (iv.to(u2.dtype) + dv) / He
    marg_int = torch.clamp(torch.mean(cond_int), min=1e-12)
    row_int = cond_int[iv]
    pdf_v = row_int / marg_int
    # the column (phi) from the row's conditional cdf
    cdf_flat = scene.env_cond_cdf.reshape(-1)
    iu = torch.clamp(_row_search(cdf_flat, We + 1, iv, u1, We + 1) - 1,
                     0, We - 1)
    c0 = cdf_flat[iv * (We + 1) + iu]
    c1 = cdf_flat[iv * (We + 1) + iu + 1]
    du = torch.where(c1 > c0, (u1 - c0) / torch.clamp(c1 - c0, min=1e-12),
                     0.0)
    u = (iu.to(u1.dtype) + du) / We
    theta_w = (iv.to(u1.dtype) + 0.5) / He * np.pi
    f_uv = scene.env_lum[iv, iu] * torch.sin(theta_w) + 1e-12
    pdf_u = f_uv / torch.clamp(row_int, min=1e-12)
    # (u, v) -> a direction in light space, then in the world
    phi = u * 2 * np.pi
    theta = v * np.pi
    sin_t = torch.sin(theta)
    dl = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                      torch.cos(theta)], -1)
    wi = dl @ scene.env_to_world[:3, :3].T
    pdf = (pdf_u * pdf_v) / torch.clamp(2 * np.pi * np.pi * sin_t, min=1e-9)
    return geom.normalize(wi), torch.where(sin_t > 1e-6, pdf, 0.0)


def _env_cell(scene, d):
    """The env map's (row, column) of world directions d, and the light-
    space sin(theta)."""
    dl = d @ scene.env_to_light[:3, :3].T
    He, We = scene.env_map.shape[:2]
    theta = geom.spherical_theta(dl)
    x = torch.clamp((geom.spherical_phi(dl) * (0.5 / np.pi) * We)
                    .to(torch.int64), 0, We - 1)
    y = torch.clamp((theta / np.pi * He).to(torch.int64), 0, He - 1)
    return y, x, theta


@span("lights")
def pdf_li_infinite(scene: ir.SceneData, wi):
    """Solid-angle pdf of the infinite light's sampler for directions wi
    (InfiniteAreaLight::Pdf_Li, infinite.cpp:136+)."""
    if scene.env_map.shape[0] <= 1 and scene.env_map.shape[1] <= 1:
        return torch.full(wi.shape[:-1], sampling.INV_4PI, device=wi.device)
    iv, iu, theta = _env_cell(scene, wi)
    sin_t = torch.sin(theta)
    f_uv = scene.env_lum[iv, iu] * sin_t + 1e-12
    cond_int = scene.env_cond_int
    pdf_v = cond_int[iv] / torch.clamp(torch.mean(cond_int), min=1e-12)
    pdf_u = f_uv / torch.clamp(cond_int[iv], min=1e-12)
    return torch.where(sin_t > 1e-6,
                       pdf_u * pdf_v / (2 * np.pi * np.pi * sin_t), 0.0)


@span("lights")
def area_le(scene: ir.SceneData, light_idx, ng, wo):
    """Emitted radiance of an area-light prim toward wo (diffuse.h:55-76)."""
    if ir.LIGHT_AREA not in scene.light_kinds:
        return torch.zeros(ng.shape[:-1] + (spec.N_SPECTRAL_SAMPLES,),
                           device=ng.device)
    l = torch.clamp(light_idx, 0, scene.light_L.shape[0] - 1).long()
    facing = scene.light_two_sided[l] | (geom.dot(ng, wo) > 0)
    has = light_idx >= 0
    if len(scene.light_kinds) > 1:
        has = has & (scene.light_type[l] == ir.LIGHT_AREA)
    return torch.where((has & facing)[:, None],
                       scene.light_L.index_select(0, l), 0.0)


def delta_emit_scale(scene: ir.SceneData, l, w):
    """The direction-dependent emission scale of delta emitters toward
    world direction w: the spot cone's falloff (spot.cpp:60-76) and the
    goniometric / projection map; 1 for point and area lights."""
    kinds = set(scene.light_kinds)
    B = w.shape[0]
    scale = torch.ones(B, device=w.device)
    if not kinds & ({ir.LIGHT_SPOT} | _MAPPED):
        return scale
    l = l.long()
    lt, ldir, params = (scene.light_type[l], scene.light_dir[l],
                        scene.light_params[l])
    if ir.LIGHT_SPOT in kinds:
        scale = torch.where(lt == ir.LIGHT_SPOT,
                            _spot_falloff(geom.dot(w, ldir), params), scale)
    if kinds & _MAPPED:
        scale = torch.where((lt == ir.LIGHT_GONIO)
                            | (lt == ir.LIGHT_PROJECTION),
                            _mapped_scale(scene, lt, w, ldir, params), scale)
    return scale


def _env_radiance(scene: ir.SceneData, d):
    """The env map at world directions d (equirect, in light space); a
    constant light's 1x1 map too."""
    y, x, _ = _env_cell(scene, d)
    He, We, NS = scene.env_map.shape
    return scene.env_map.reshape(He * We, NS).index_select(0, y * We + x)


@span("lights")
def env_le(scene: ir.SceneData, d):
    """Radiance of the infinite light for escaped rays (infinite.h Le)."""
    if not scene.has_infinite:
        return torch.zeros(d.shape[:-1] + (spec.N_SPECTRAL_SAMPLES,),
                           device=d.device)
    return _env_radiance(scene, d)
