"""Vectorized spectral BSDFs with mask-based type dispatch (port of
pbrt_tpu.materials.bsdf; reference: src/core/reflection.{h,cpp},
src/core/microfacet.{h,cpp}, src/materials/*).

Each lane carries a gathered material record; each family is a
closed-form eval/sample/pdf computed under a lane mask.  Shading frame:
z = shading normal, wo/wi point away from the surface, eval returns f
without the cosine.  Spectra are [..., 31].

Ported families: matte, plastic, mirror, glass, metal, uber (with
opacity), substrate, translucent, the fork's retroreflective, disney,
rough glass, mix (resolved to one of its two materials per lane) and the
"none" interface; GGX or Beckmann microfacets per material; textured Kd /
Ks and bump maps; hair (materials/hair.py, in a frame whose x axis is the
fiber, `shading_frame`); fourier (a baked lattice, materials/fourier.py);
and the subsurface materials.  A subsurface lane that the path
integrator's probe pass relocates (integrators/path.py _sss_event)
becomes a mirror or rough-glass interface reflection or the Sw exit lobe
MAT_SSW; one that reaches the dispatch unrelocated (whitted, ao,
directlighting's fallback) shades as the diffusion limit, a plastic of
the table's effective albedo.  The scene's static `mat_families` tuple
(MaterialParams.families) and the has_hair / has_fourier / has_sss flags
gate each family's lobes: an absent family launches nothing, as the JAX
package compiles it away.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import rng as _rng
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.materials import fourier as fouriermod
from pbrt_tpu_torch.materials import hair as hairmod
from pbrt_tpu_torch.materials.bssrdf import fresnel_moment1_torch
from pbrt_tpu_torch.scene import ir
from pbrt_tpu_torch.textures.textures import eval_texture
from pbrt_tpu_torch.utils.stats import span

INV_PI = sampling.INV_PI
PI = sampling.PI
SQRT_PI_INV = float(1.0 / np.sqrt(np.pi))


@dataclass
class MaterialParams:
    """Per-ray gathered material record."""
    type: torch.Tensor       # [B] MAT_* (MAT_NONE where no material)
    kd: torch.Tensor         # [B,31]
    ks: torch.Tensor
    kr: torch.Tensor
    kt: torch.Tensor
    rough_u: torch.Tensor    # [B] alpha (already remapped)
    rough_v: torch.Tensor
    eta: torch.Tensor        # [B]
    sigma: torch.Tensor      # [B] Oren-Nayar sigma (degrees)
    # [B,31] conductor eta and k; None: no metal in the scene
    eta_spec: torch.Tensor = None
    k_spec: torch.Tensor = None
    # [B,31] (uber; 1 elsewhere); None: no uber in the scene
    opacity: torch.Tensor = None
    # [B] bool Beckmann selector; None: an all-GGX scene (has_beckmann)
    beckmann: torch.Tensor = None
    # [B,8] disney lobe weights; None: no disney material (has_disney)
    disney: torch.Tensor = None
    # [B] the hair fiber's offset h in [-1, 1] (2 v - 1 across a curve's
    # width); None: no hair (has_hair)
    hair_h: torch.Tensor = None
    # the scene's fourier lattices and marginals and each lane's lattice;
    # None: no fourier material (has_fourier)
    fourier_grid: torch.Tensor = None   # [F,NM,NM,NP,3]
    fourier_id: torch.Tensor = None     # [B]
    fourier_a0: torch.Tensor = None     # [F,NMi,NMo]
    fourier_lum: torch.Tensor = None    # [F,NMi,NMo,NP]
    # subsurface (None: no BSSRDF table, has_sss): the Sw lobe's
    # normalisation c = 1 - 2 FresnelMoment1(1 / eta) (bssrdf.h:221), the
    # profile table and the per-channel medium of the probe pass
    sss_c: torch.Tensor = None          # [B]
    sss_tid: torch.Tensor = None        # [B]
    sss_sigma_t: torch.Tensor = None    # [B,31]
    sss_rho: torch.Tensor = None        # [B,31]
    # static tuple of the MAT_* families present (None: all)
    families: tuple = None

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


def _present(families, *types):
    """Static: is any of these material families in the scene?"""
    return families is None or any(t in families for t in types)


def roughness_to_alpha(rough):
    """pbrt's RoughnessToAlpha (microfacet.h:83)."""
    x = torch.log(torch.clamp(rough, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def _texture(scene, idx, uv, p, **kw):
    return eval_texture(scene.tex_images, scene.tex_type, scene.tex_params,
                        scene.tex_c1, scene.tex_c2, idx, uv, p,
                        kinds=scene.tex_kinds, **kw)


@span("shading")
def bump_shading_normal(scene: ir.SceneData, material_idx, hit):
    """The shading normal perturbed by the material's bump map (reference:
    Material::Bump, material.cpp:50+): finite differences of the bound
    float texture in uv, and in world space along the shading frame for
    the noise families, at a step of 1e-3 of the scene's radius."""
    if scene.tex_type.shape[0] <= 1 or not scene.has_bump:
        return hit.ns
    m = torch.clamp(material_idx, 0, scene.mat_type.shape[0] - 1).long()
    btex = scene.mat_bump_tex[m]
    eps = 2e-3
    ss, ts = geom.coordinate_system(hit.ns)
    eps_w = 1e-3 * scene.world_radius

    def h(uv, p):
        return _texture(scene, btex, uv, p).mean(-1)

    h0 = h(hit.uv, hit.p)
    du = (h(hit.uv + torch.tensor([eps, 0.0], device=hit.uv.device),
            hit.p + eps_w * ss) - h0) / eps
    dv = (h(hit.uv + torch.tensor([0.0, eps], device=hit.uv.device),
            hit.p + eps_w * ts) - h0) / eps
    scale = 0.02  # displacement scale in shading units
    ns2 = geom.normalize(hit.ns - scale * (du[:, None] * ss
                                           + dv[:, None] * ts))
    ns2 = torch.where(geom.dot(ns2, hit.ng)[:, None] < 0, -ns2, ns2)
    return torch.where((btex >= 0)[:, None], ns2, hit.ns)


def hair_shading_frame(scene: ir.SceneData, hit, ss, ts):
    """(ss, ts) with the x axis along the fiber on hair lanes: dpdu of the
    hit triangle's uv parameterisation (curves run u along the fiber),
    made tangent to ns.  The hair BSDF's frame is x the fiber, (y, z) the
    normal plane (hair.h; the reference's dpdu-aligned BSDF frame)."""
    m = torch.clamp(hit.material, 0, scene.mat_type.shape[0] - 1).long()
    is_hair = (scene.mat_type[m] == ir.MAT_HAIR) & (hit.material >= 0)
    prim = torch.clamp(hit.prim, 0, scene.tri_v0.shape[0] - 1).long()
    uv = scene.tri_uv[prim]                       # [B,3,2]
    e1 = scene.tri_e1[prim]
    e2 = scene.tri_e2[prim]
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    dpdu = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv[:, None]
    tang = dpdu - geom.dot(dpdu, hit.ns)[:, None] * hit.ns
    ln = geom.length(tang)
    ok = ok & (ln > 1e-9)
    tang = tang / torch.clamp(ln, min=1e-9)[:, None]
    use = (is_hair & ok)[:, None]
    return (torch.where(use, tang, ss),
            torch.where(use, geom.cross(hit.ns, tang), ts))


@span("shading")
def shading_frame(scene: ir.SceneData, hit):
    """(ss, ts) about hit.ns, fiber-aligned on hair lanes when the scene
    has hair (the reference's dpdu-aligned frame,
    SurfaceInteraction::ComputeScatteringFunctions)."""
    ss, ts = geom.coordinate_system(hit.ns)
    if scene.has_hair:
        ss, ts = hair_shading_frame(scene, hit, ss, ts)
    return ss, ts


def resolve_mix(scene: ir.SceneData, material_idx, u_mix=None, p=None):
    """MAT_MIX lanes resolved to one of their two named materials, `a`
    with probability `amount` (materials/mixmat.cpp blends the lobe sets;
    one-sample selection is the unbiased wavefront analog).  Without
    u_mix, a hash of the position p dithers (0.5 without p)."""
    if not scene.has_mix:
        return material_idx
    m = torch.clamp(material_idx, 0, scene.mat_type.shape[0] - 1).long()
    is_mix = (scene.mat_type[m] == ir.MAT_MIX) & (material_idx >= 0)
    if u_mix is None:
        if p is None:
            u_mix = torch.full(m.shape, 0.5, device=m.device)
        else:
            bits = torch.abs(p * 8192.0).to(torch.int64)
            u_mix = _rng.uniform_float(_rng.hash_combine(
                bits[..., 0], bits[..., 1], bits[..., 2]))
    resolved = torch.where(u_mix < scene.mat_mix_amt[m], scene.mat_mix_a[m],
                           scene.mat_mix_b[m])
    return torch.where(is_mix, resolved, material_idx)


@span("shading")
def gather_materials(scene: ir.SceneData, material_idx, uv=None, p=None,
                     u_mix=None, uv_width=None, duv=None,
                     face=None) -> MaterialParams:
    """Per-lane material records by plain indexing of the material table;
    mix lanes resolved (resolve_mix), texture-bound Kd / Ks evaluated at
    the hit's uv and world point when uv is given and the scene has
    textures (uv_width, duv: the footprint, textures.eval_texture; face:
    the hits' face index, which ptex textures read), and uber's opacity
    applied to every lobe.  The hair, fourier and subsurface fields are
    filled only in a scene that has them."""
    material_idx = resolve_mix(scene, material_idx, u_mix, p)
    m = torch.clamp(material_idx, 0, scene.mat_type.shape[0] - 1).long()
    rough_u, rough_v = scene.mat_rough_u[m], scene.mat_rough_v[m]
    remap = scene.mat_remap_rough[m]
    au = torch.where(remap, roughness_to_alpha(rough_u), rough_u)
    av = torch.where(remap, roughness_to_alpha(rough_v), rough_v)
    # rough == 0 stays 0 (the perfect-specular marker)
    au = torch.where(rough_u > 0, torch.clamp(au, min=1e-3), 0.0)
    av = torch.where(rough_v > 0, torch.clamp(av, min=1e-3), 0.0)
    # index_select, not indexing: its backward accumulates by index_add,
    # where indexing's backward serializes the many lanes that share a
    # material (the gradient step's backward, PERF.md)
    kd, ks = (scene.mat_kd.index_select(0, m),
              scene.mat_ks.index_select(0, m))
    if uv is not None and scene.tex_type.shape[0] > 1:
        pw = p if p is not None else torch.zeros(uv.shape[:-1] + (3,),
                                                 device=uv.device)
        for slot in ("kd", "ks"):
            tex_idx = getattr(scene, f"mat_{slot}_tex")[m]
            s = spec.from_rgb(_texture(
                scene, tex_idx, uv, pw, uv_width=uv_width, duv=duv,
                face=face if scene.has_ptex else None), "reflectance")
            s = torch.where((tex_idx >= 0)[:, None], s,
                            kd if slot == "kd" else ks)
            if slot == "kd":
                kd = s
            else:
                ks = s
    fam = scene.mat_families
    kr, kt = (scene.mat_kr.index_select(0, m),
              scene.mat_kt.index_select(0, m))
    op = None
    if _present(fam, ir.MAT_UBER):
        # uber's opacity scales every surface lobe (uber.cpp:40-58); it is
        # 1 for every other material, so the product changes nothing else
        op = scene.mat_opacity[m]
        kd, ks, kr, kt = kd * op, ks * op, kr * op, kt * op
    metal = _present(fam, ir.MAT_METAL)
    eta = scene.mat_eta[m]
    extra = {}
    if scene.has_hair and uv is not None:
        extra["hair_h"] = torch.clamp(2.0 * uv[..., 1] - 1.0, -0.995, 0.995)
    if scene.has_fourier:
        extra.update(fourier_grid=scene.fourier_grid,
                     fourier_id=scene.mat_fourier_id[m],
                     fourier_a0=scene.fourier_a0,
                     fourier_lum=scene.fourier_lum)
    if scene.has_sss:
        extra.update(
            sss_c=torch.clamp(1.0 - 2.0 * fresnel_moment1_torch(
                1.0 / torch.clamp(eta, min=1e-3)), min=1e-4),
            sss_tid=scene.mat_bssrdf_id[m],
            sss_sigma_t=scene.mat_sss_sigma_t[m],
            sss_rho=scene.mat_sss_rho[m])
    return MaterialParams(
        type=torch.where(material_idx >= 0, scene.mat_type[m], ir.MAT_NONE),
        kd=kd, ks=ks, kr=kr, kt=kt, rough_u=au, rough_v=av,
        eta=eta, sigma=scene.mat_sigma[m],
        eta_spec=scene.mat_eta_spec[m] if metal else None,
        k_spec=scene.mat_k_spec[m] if metal else None, opacity=op,
        beckmann=scene.mat_beckmann[m] if scene.has_beckmann else None,
        disney=scene.mat_disney[m] if scene.has_disney else None,
        families=fam, **extra)


# ---------------------------------------------------------------------------
# local-frame helpers (reflection.h:50-115) and Fresnel
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; handles entering/exiting by sign."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=1e-14))
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=1e-14))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-9)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-9)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """Spectral conductor Fresnel (reflection.cpp FrConductor); eta, k
    [..., 31]."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4 * eta2 * k2, min=1e-14))
    t1 = a2b2 + ci2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=1e-14))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-9)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-9)
    return 0.5 * (rp + rs)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz / GGX microfacet distribution (microfacet.{h,cpp})
# ---------------------------------------------------------------------------

def ggx_d(wh, ax, ay):
    cos2 = wh[..., 2] ** 2
    e = (wh[..., 0] ** 2 / torch.clamp(ax * ax, min=1e-12)
         + wh[..., 1] ** 2 / torch.clamp(ay * ay, min=1e-12)) + cos2
    return 1.0 / torch.clamp(PI * ax * ay * e * e, min=1e-12)


def _ggx_lambda(w, ax, ay):
    """Smith Lambda for GGX (microfacet.cpp:80)."""
    c2 = w[..., 2] ** 2
    abs_tan2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    s2 = torch.clamp(1.0 - c2, min=0.0)
    inv_s = 1.0 / torch.sqrt(torch.clamp(s2, min=1e-20))
    cos_phi = torch.where(s2 > 1e-20, w[..., 0] * inv_s, 1.0)
    sin_phi = torch.where(s2 > 1e-20, w[..., 1] * inv_s, 0.0)
    alpha2 = cos_phi ** 2 * ax * ax + sin_phi ** 2 * ay * ay
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha2 * abs_tan2))


def ggx_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(wo, ax, ay) + _ggx_lambda(wi, ax, ay))


def ggx_g1(w, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(w, ax, ay))


def ggx_sample_wh(wo, u1, u2, ax, ay):
    """Sample the visible GGX NDF (Heitz 2018; TrowbridgeReitzSample,
    microfacet.cpp:244)."""
    flip = wo[..., 2] < 0
    w = torch.where(flip[..., None], -wo, wo)
    vh = geom.normalize(torch.stack(
        [ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where((lensq > 1e-20)[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=wo.device))
    t2 = geom.cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-14)) \
        + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-14))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * vh
    wh = geom.normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1],
         torch.clamp(nh[..., 2], min=1e-6)], -1))
    return torch.where(flip[..., None], -wh, wh)


def ggx_pdf_wh(wo, wh, ax, ay):
    """Visible-NDF pdf: D * G1 * |wo.wh| / |cos wo|."""
    return (ggx_d(wh, ax, ay) * ggx_g1(wo, ax, ay)
            * torch.abs(geom.dot(wo, wh))
            / torch.clamp(abs_cos_theta(wo), min=1e-9))


# ---------------------------------------------------------------------------
# Beckmann distribution (microfacet.h:80, microfacet.cpp), selected per
# material by the scene-file extension parameter "string distribution"
# ---------------------------------------------------------------------------

def beckmann_d(wh, ax, ay):
    c2 = wh[..., 2] ** 2
    tan2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    s2 = torch.clamp(1.0 - c2, min=1e-20)
    cos2phi = wh[..., 0] ** 2 / s2
    sin2phi = wh[..., 1] ** 2 / s2
    e = torch.exp(-tan2 * (cos2phi / torch.clamp(ax * ax, min=1e-12)
                           + sin2phi / torch.clamp(ay * ay, min=1e-12)))
    return e / torch.clamp(PI * ax * ay * c2 * c2, min=1e-12)


def _beckmann_lambda(w, ax, ay):
    c2 = w[..., 2] ** 2
    abs_tan = torch.sqrt(torch.clamp(1.0 - c2, min=0.0)
                         / torch.clamp(c2, min=1e-12))
    s2 = torch.clamp(1.0 - c2, min=1e-20)
    cos2phi = w[..., 0] ** 2 / s2
    sin2phi = w[..., 1] ** 2 / s2
    alpha = torch.sqrt(cos2phi * ax * ax + sin2phi * ay * ay + 1e-20)
    a = 1.0 / torch.clamp(alpha * abs_tan, min=1e-12)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / \
        torch.clamp(3.535 * a + 2.181 * a * a, min=1e-12)
    return torch.where(a >= 1.6, 0.0, lam)


def beckmann_sample_11(cos_theta_i, u1, u2):
    """BeckmannSample11 (microfacet.cpp:107-180): visible-NDF slopes by a
    fixed 10-step Newton inversion of the erf-based CDF."""
    ct = torch.clamp(cos_theta_i, min=-0.9999)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=1e-14))
    tant = st / torch.clamp(ct, min=1e-7)
    cot = 1.0 / torch.clamp(tant, min=1e-12)
    a0 = torch.erf(cot)
    sx = torch.clamp(u1, min=1e-6)
    theta = torch.arccos(torch.clamp(ct, -1.0, 1.0))
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    b = a0 - (1.0 + a0) * torch.pow(1.0 - sx, fit)
    norm = 1.0 / torch.clamp(
        1.0 + a0 + SQRT_PI_INV * tant * torch.exp(-cot * cot), min=1e-12)
    b = torch.clamp(b, -1 + 1e-6, 1 - 1e-6)
    for _ in range(10):
        inv_erf = torch.erfinv(torch.clamp(b, -0.99999, 0.99999))
        value = norm * (1.0 + b + SQRT_PI_INV * tant
                        * torch.exp(-inv_erf * inv_erf)) - sx
        derivative = norm * (1.0 - inv_erf * tant)
        step = value / torch.where(torch.abs(derivative) > 1e-9,
                                   derivative, 1e-9)
        b = torch.clamp(b - step, -1.0 + 1e-6, 1.0 - 1e-6)
    slope_x = torch.erfinv(torch.clamp(b, -0.99999, 0.99999))
    slope_y = torch.erfinv(torch.clamp(2.0 * torch.clamp(u2, min=1e-6) - 1.0,
                                       -0.99999, 0.99999))
    # normal incidence
    r = torch.sqrt(torch.clamp(-torch.log(torch.clamp(1.0 - u1, min=1e-12)),
                               min=1e-14))
    phi = 2.0 * PI * u2
    near = cos_theta_i > 0.9999
    slope_x = torch.where(near, r * torch.cos(phi), slope_x)
    slope_y = torch.where(near, r * torch.sin(phi), slope_y)
    return slope_x, slope_y


def beckmann_sample_wh(wo, u1, u2, ax, ay):
    """Visible-NDF Sample_wh (microfacet.cpp BeckmannSample)."""
    flip = wo[..., 2] < 0
    w = torch.where(flip[..., None], -wo, wo)
    ws = geom.normalize(torch.stack(
        [ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    sx, sy = beckmann_sample_11(ws[..., 2], u1, u2)
    s2 = torch.clamp(1.0 - ws[..., 2] ** 2, min=1e-20)
    inv_s = 1.0 / torch.sqrt(s2)
    cos_phi = torch.where(s2 > 1e-20, ws[..., 0] * inv_s, 1.0)
    sin_phi = torch.where(s2 > 1e-20, ws[..., 1] * inv_s, 0.0)
    tmp = cos_phi * sx - sin_phi * sy
    sy = sin_phi * sx + cos_phi * sy
    sx = ax * tmp
    sy = ay * sy
    wh = geom.normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], -1))
    return torch.where(flip[..., None], -wh, wh)


# generic microfacet dispatch: beck ([B] bool or None) picks Beckmann per
# lane; None is the all-GGX path (scene.has_beckmann false)

def mf_d(wh, ax, ay, beck=None):
    if beck is None:
        return ggx_d(wh, ax, ay)
    return torch.where(beck, beckmann_d(wh, ax, ay), ggx_d(wh, ax, ay))


def _mf_lambda(w, ax, ay, beck=None):
    if beck is None:
        return _ggx_lambda(w, ax, ay)
    return torch.where(beck, _beckmann_lambda(w, ax, ay),
                       _ggx_lambda(w, ax, ay))


def mf_g(wo, wi, ax, ay, beck=None):
    return 1.0 / (1.0 + _mf_lambda(wo, ax, ay, beck)
                  + _mf_lambda(wi, ax, ay, beck))


def mf_g1(w, ax, ay, beck=None):
    return 1.0 / (1.0 + _mf_lambda(w, ax, ay, beck))


def mf_sample_wh(wo, u1, u2, ax, ay, beck=None):
    if beck is None:
        return ggx_sample_wh(wo, u1, u2, ax, ay)
    return torch.where(beck[..., None],
                       beckmann_sample_wh(wo, u1, u2, ax, ay),
                       ggx_sample_wh(wo, u1, u2, ax, ay))


def mf_pdf_wh(wo, wh, ax, ay, beck=None):
    """Visible-NDF pdf (microfacet.h Pdf: D * G1 * |wo.wh| / |cos wo|)."""
    return (mf_d(wh, ax, ay, beck) * mf_g1(wo, ax, ay, beck)
            * torch.abs(geom.dot(wo, wh))
            / torch.clamp(abs_cos_theta(wo), min=1e-9))


# ---------------------------------------------------------------------------
# lobes
# ---------------------------------------------------------------------------

def lambertian_f(kd):
    return kd * INV_PI


def oren_nayar_f(kd, sigma_deg, wo, wi):
    """Oren-Nayar (reflection.cpp:117)."""
    s2 = torch.deg2rad(sigma_deg) ** 2
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    Bc = 0.45 * s2 / (s2 + 0.09)
    sin_to = torch.sqrt(torch.clamp(1.0 - wo[..., 2] ** 2, min=1e-14))
    sin_ti = torch.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=1e-14))
    cos_dphi = ((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
                / (torch.clamp(sin_ti, min=1e-9)
                   * torch.clamp(sin_to, min=1e-9)))
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          torch.clamp(cos_dphi, min=0.0), 0.0)
    abs_ci = torch.abs(wi[..., 2])
    abs_co = torch.abs(wo[..., 2])
    big = torch.maximum(abs_ci, abs_co) + 1e-9
    small = torch.minimum(abs_ci, abs_co)
    sin_a = torch.sqrt(torch.clamp(1.0 - small * small, min=1e-14))
    tan_b = torch.sqrt(torch.clamp(1.0 - big * big, min=1e-14)) / big
    return kd * INV_PI * (A + Bc * max_cos * sin_a * tan_b)[..., None]


def _safe_half(wo, wi):
    """Half vector with a unit-z fallback when wo ~= -wi."""
    wh = wo + wi
    wh_len = torch.sqrt(geom.length_sq(wh) + 1e-12)
    ok = wh_len > 1e-5
    whn = torch.where(ok[..., None],
                      wh / torch.clamp(wh_len, min=1e-6)[..., None],
                      torch.tensor([0.0, 0.0, 1.0], device=wo.device))
    return whn, ok


def microfacet_reflection_f(ks, wo, wi, ax, ay, F, beck=None):
    """Torrance-Sparrow (reflection.cpp:408): D G F / (4 cos_o cos_i)."""
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh, wh_ok = _safe_half(wo, wi)
    ok = (co > 1e-6) & (ci > 1e-6) & wh_ok & same_hemisphere(wo, wi)
    dg = mf_d(wh, ax, ay, beck) * mf_g(wo, wi, ax, ay, beck)
    f = ks * F * (dg / torch.clamp(4 * co * ci, min=1e-9))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def microfacet_reflection_pdf(wo, wi, ax, ay, beck=None):
    wh, wh_ok = _safe_half(wo, wi)
    pdf = mf_pdf_wh(wo, wh, ax, ay, beck) / torch.clamp(
        4 * torch.abs(geom.dot(wo, wh)), min=1e-9)
    return torch.where(same_hemisphere(wo, wi) & wh_ok, pdf, 0.0)


def _pow5(x):
    return x * x * x * x * x


def fresnel_blend_f(rd, rs, wo, wi, ax, ay):
    """Ashikhmin-Shirley FresnelBlend (reflection.cpp:480, substrate)."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    diffuse = ((28.0 / (23.0 * PI)) * rd * (1.0 - rs)
               * ((1.0 - _pow5(1.0 - 0.5 * ci))
                  * (1.0 - _pow5(1.0 - 0.5 * co)))[..., None])
    wh, ok = _safe_half(wo, wi)
    d = ggx_d(wh, ax, ay)
    dot_iw = torch.abs(geom.dot(wi, wh))
    schlick = rs + _pow5(1.0 - dot_iw)[..., None] * (1.0 - rs)
    spec_ = (d / torch.clamp(4 * dot_iw * torch.maximum(ci, co), min=1e-9)
             )[..., None] * schlick
    out = diffuse + torch.where(ok[..., None], spec_, 0.0)
    return torch.where(same_hemisphere(wo, wi)[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# Disney principled BSDF (materials/disney.cpp): diffuse + retro + sheen,
# anisotropic GGX specular with DisneyFresnel, GTR1 clearcoat, and
# microfacet transmission for specTrans
# ---------------------------------------------------------------------------

def _disney_unpack(params):
    dz = params.disney
    if dz is None:
        dz = torch.zeros(params.type.shape + (8,), dtype=params.kd.dtype,
                         device=params.kd.device)
    return tuple(dz[..., i] for i in range(7))


def _gtr1_d(cos_h, alpha):
    """GTR1 NDF (disney.cpp GTR1), the clearcoat lobe's."""
    a2 = torch.clamp(alpha * alpha, 1e-6, 1.0 - 1e-4)
    c2 = cos_h * cos_h
    return (a2 - 1.0) / (PI * torch.log(a2) * (1.0 + (a2 - 1.0) * c2))


def _smith_ggx_sep(cos_t, alpha):
    """Separable smithG_GGX of disney.cpp's clearcoat."""
    a2 = alpha * alpha
    c2 = cos_t * cos_t
    return 1.0 / (torch.abs(cos_t) + torch.sqrt(torch.clamp(
        a2 + c2 - a2 * c2, min=1e-12)))


def _disney_weights(params):
    """Per-lane lobe selection probabilities [B,4]: cosine (diffuse +
    retro + sheen), GGX specular, GTR1 clearcoat, microfacet
    transmission.  pdf_f integrates the same mixture."""
    metallic, _, _, _, cc, _, strans = _disney_unpack(params)
    w_diff = (1.0 - metallic) * (1.0 - strans) + 1e-4
    w_spec = torch.ones_like(metallic)
    w_cc = 0.5 * torch.clamp(cc, 0.0, 1.0)
    w_trans = (1.0 - metallic) * strans
    tot = w_diff + w_spec + w_cc + w_trans
    return torch.stack([w_diff, w_spec, w_cc, w_trans], -1) / tot[..., None]


def _disney_f_refl(params, wo, wi):
    """The reflective Disney lobes f(wo, wi) [B,31] (the caller masks to
    the same hemisphere)."""
    (metallic, spec_tint, sheen, sheen_tint, cc, cc_gloss,
     strans) = _disney_unpack(params)
    base = params.kd
    lum = torch.clamp(spec.luminance(base), min=1e-4)
    ctint = base / lum[..., None]
    co = torch.clamp(abs_cos_theta(wo), min=1e-6)
    ci = torch.clamp(abs_cos_theta(wi), min=1e-6)
    wh, wh_ok = _safe_half(wo, wi)
    cosd = torch.abs(geom.dot(wi, wh))
    ax, ay = params.rough_u, params.rough_v
    rough = torch.clamp((ax * ay) ** 0.25, 1e-3, 1.0)  # undo the alpha remap
    Fo = _pow5(torch.clamp(1.0 - co, 0.0, 1.0))
    Fi = _pow5(torch.clamp(1.0 - ci, 0.0, 1.0))
    Fd = _pow5(torch.clamp(1.0 - cosd, 0.0, 1.0))
    diffuse_w = (1.0 - metallic) * (1.0 - strans)
    # DisneyDiffuse + DisneyRetro (Burley 2012, split as disney.cpp does)
    f_diff = base * (INV_PI * (1.0 - 0.5 * Fo) * (1.0 - 0.5 * Fi))[..., None]
    RR = 2.0 * rough * cosd * cosd
    f_retro = base * (INV_PI * RR * (Fo + Fi + Fo * Fi * (RR - 1.0))
                      )[..., None]
    csheen = (1.0 - sheen_tint)[..., None] + sheen_tint[..., None] * ctint
    f_sheen = sheen[..., None] * csheen * Fd[..., None]
    f = diffuse_w[..., None] * (f_diff + f_retro + f_sheen)
    # specular GGX with DisneyFresnel (Schlick toward Cspec0)
    r0 = ((params.eta - 1.0) / (params.eta + 1.0)) ** 2
    cspec0 = ((1.0 - metallic)[..., None] * r0[..., None]
              * ((1.0 - spec_tint)[..., None]
                 + spec_tint[..., None] * ctint)
              + metallic[..., None] * base)
    F = cspec0 + Fd[..., None] * (1.0 - cspec0)
    d = ggx_d(wh, ax, ay)
    g = ggx_g(wo, wi, ax, ay)
    f = f + torch.where(wh_ok[..., None],
                        (d * g / (4.0 * co * ci))[..., None] * F, 0.0)
    # clearcoat: GTR1 and a fixed-0.25 separable Smith (disney.cpp)
    acc = 0.1 * (1.0 - cc_gloss) + 0.001 * cc_gloss
    dr = _gtr1_d(wh[..., 2], acc)
    gr = _smith_ggx_sep(cos_theta(wo), 0.25) * _smith_ggx_sep(
        cos_theta(wi), 0.25)
    fr = 0.04 + 0.96 * Fd
    f_cc = cc * dr * gr * fr * 0.25
    return f + torch.where(wh_ok, f_cc, 0.0)[..., None]


def _disney_pdf(params, wo, wi):
    """The mixture pdf of _disney_weights' sampling."""
    w = _disney_weights(params)
    refl = same_hemisphere(wo, wi)
    pdf_cos = torch.where(refl, abs_cos_theta(wi) * INV_PI, 0.0)
    ax, ay = params.rough_u, params.rough_v
    pdf_spec = torch.where(refl, microfacet_reflection_pdf(wo, wi, ax, ay),
                           0.0)
    cc_gloss = _disney_unpack(params)[5]
    wh, wh_ok = _safe_half(wo, wi)
    acc = 0.1 * (1.0 - cc_gloss) + 0.001 * cc_gloss
    dwo = torch.clamp(torch.abs(geom.dot(wo, wh)), min=1e-6)
    pdf_cc = torch.where(refl & wh_ok,
                         torch.abs(_gtr1_d(wh[..., 2], acc))
                         * torch.abs(wh[..., 2]) / (4.0 * dwo), 0.0)
    _, pdf_rt = _rough_transmission(params, wo, wi)
    return (w[..., 0] * pdf_cos + w[..., 1] * pdf_spec
            + w[..., 2] * pdf_cc + w[..., 3] * pdf_rt)


def _retro_d(cos_r, alpha):
    """Retro lobe density, peaked at wi == wo (a behavioural model of the
    fork's RetroReflection lobes, materials/retroreflective.cpp:80-174):
    GGX-shaped in the angle to wo."""
    a2 = torch.clamp(alpha * alpha, min=1e-6)
    c = torch.clamp(cos_r, -1.0, 1.0)
    return a2 / (PI * ((c * c) * (a2 - 1.0) + 1.0) ** 2)


def _rough_transmission(params, wo, wi):
    """MicrofacetTransmission f and pdf (reflection.cpp:451; microfacet.h
    Pdf with the dwh/dwi change of variables), for opposite
    hemispheres."""
    ax = torch.clamp(params.rough_u, min=1e-4)
    ay = torch.clamp(params.rough_v, min=1e-4)
    co = cos_theta(wo)
    ci = cos_theta(wi)
    eta = torch.where(co > 0, params.eta, 1.0 / params.eta)
    whr = wo + wi * eta[..., None]
    whl = torch.sqrt(geom.length_sq(whr) + 1e-12)
    wh_ok2 = whl > 1e-6
    wh = torch.where(wh_ok2[..., None],
                     whr / torch.clamp(whl, min=1e-6)[..., None],
                     torch.tensor([0.0, 0.0, 1.0], device=wo.device))
    wh = torch.where(wh[..., 2:3] < 0, -wh, wh)
    dwo = geom.dot(wo, wh)
    dwi = geom.dot(wi, wh)
    ok = ((dwo * dwi < 0) & (torch.abs(co) > 1e-6) & (torch.abs(ci) > 1e-6)
          & wh_ok2)
    F = fresnel_dielectric(dwo, 1.0, params.eta)
    sqrt_denom = dwo + eta * dwi
    d = ggx_d(wh, ax, ay)
    g = ggx_g(wo, wi, ax, ay)
    factor = 1.0 / eta      # radiance transport scaling
    f_val = ((1.0 - F) * torch.abs(
        d * g * eta * eta * torch.abs(dwi) * torch.abs(dwo) * factor * factor
        / torch.clamp(torch.abs(ci * co) * sqrt_denom * sqrt_denom,
                      min=1e-9)))
    f = params.kt * torch.where(ok, f_val, 0.0)[..., None]
    dwh_dwi = torch.abs(eta * eta * dwi) / torch.clamp(
        sqrt_denom * sqrt_denom, min=1e-9)
    pdf = torch.where(ok, ggx_pdf_wh(wo, wh, ax, ay) * dwh_dwi, 0.0)
    return f, pdf


# ---------------------------------------------------------------------------
# type dispatch: eval / pdf / sample
# ---------------------------------------------------------------------------

def _add(acc, x):
    return x if acc is None else acc + x


class _Masks:
    """Per-lane family masks of a batch, made only for present families
    (an absent family's mask is never needed: its lobes are gated off)."""

    def __init__(self, t, families):
        self.t, self.fam = t, families
        self._eq = {}

    def __call__(self, *types):
        """Lanes of any present family in `types`; None if none is."""
        out = None
        for ty in types:
            if _present(self.fam, ty):
                if ty not in self._eq:
                    self._eq[ty] = self.t == ty
                out = self._eq[ty] if out is None else out | self._eq[ty]
        return out

    def has_diff(self):
        # subsurface lanes that reach the dispatch unrelocated take the
        # diffusion limit: a plastic whose kd is the table's effective
        # albedo (parser/api.py)
        return self(ir.MAT_MATTE, ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_RETRO,
                    *_SSS)

    def has_ggx_diel(self):
        return self(ir.MAT_PLASTIC, ir.MAT_UBER, *_SSS)

    def is_delta(self):
        """mirror, glass and the "none" interface (every missed lane is
        "none", so it is always tested)."""
        none = self.t == ir.MAT_NONE
        d = self(ir.MAT_MIRROR, ir.MAT_GLASS)
        return none if d is None else d | none

    def n_lobes(self):
        """The lobe count a one-sample choice divides by (>= 1)."""
        n = None
        for mask, w in ((self.has_diff(), 1), (self.has_ggx_diel(), 1),
                        (self(ir.MAT_METAL), 1), (self(ir.MAT_SUBSTRATE), 1),
                        (self(ir.MAT_ROUGHGLASS), 2),
                        (self(ir.MAT_TRANSLUCENT), 2),
                        (self(ir.MAT_RETRO), 1)):
            if mask is not None:
                n = _add(n, mask.float() if w == 1 else w * mask.float())
        if n is None:
            return 1.0
        return torch.clamp(n, min=1.0)


_SSS = (ir.MAT_SUBSURFACE, ir.MAT_KDSUBSURFACE)


def _hair_args(params):
    """hair.py's material arguments from the record's reused slots: kd
    sigma_a, rough_u / rough_v beta_m / beta_n, sigma alpha in degrees."""
    return dict(eta=params.eta, beta_m=params.rough_u,
                beta_n=params.rough_v, alpha=params.sigma * (PI / 180.0))


@span("shading")
def eval_f(params: MaterialParams, wo, wi):
    """f(wo, wi) of the non-delta lobes, local frame; [B,31]."""
    t = params.type
    fam = params.families
    mk = _Masks(t, fam)
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    valid = (co > 1e-6) & (ci > 1e-6) & ~mk.is_delta()
    refl = same_hemisphere(wo, wi)
    ax, ay = params.rough_u, params.rough_v
    f = None
    # diffuse (lambert / oren-nayar)
    has_diff = mk.has_diff()
    if has_diff is not None:
        f_diff = torch.where((params.sigma > 1e-6)[..., None],
                             oren_nayar_f(params.kd, params.sigma, wo, wi),
                             lambertian_f(params.kd))
        f = torch.where((has_diff & refl)[..., None], f_diff, 0.0)
    if _present(fam, ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_ROUGHGLASS,
                ir.MAT_METAL, ir.MAT_DISNEY, *_SSS):
        wh, _ = _safe_half(wo, wi)
    # dielectric-coat microfacet (plastic / uber / rough-glass reflection)
    if _present(fam, ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_ROUGHGLASS,
                ir.MAT_DISNEY, *_SSS):
        F_diel = fresnel_dielectric(geom.dot(wi, wh), 1.0,
                                    params.eta)[..., None]
    has_ggx_diel = mk.has_ggx_diel()
    if has_ggx_diel is not None:
        f_spec_d = microfacet_reflection_f(params.ks, wo, wi, ax, ay,
                                           F_diel, params.beckmann)
        f = _add(f, torch.where((has_ggx_diel & (ax > 0))[..., None],
                                f_spec_d, 0.0))
    is_rglass = mk(ir.MAT_ROUGHGLASS)
    if is_rglass is not None:
        f_rg_refl = microfacet_reflection_f(params.kr, wo, wi, ax, ay,
                                            F_diel, params.beckmann)
        f = _add(f, torch.where((is_rglass & refl)[..., None], f_rg_refl,
                                0.0))
    # rough-glass transmission (also the disney specTrans lobe)
    if _present(fam, ir.MAT_ROUGHGLASS, ir.MAT_DISNEY):
        f_rg_t, _ = _rough_transmission(params, wo, wi)
    if is_rglass is not None:
        f = _add(f, torch.where((is_rglass & ~refl)[..., None], f_rg_t, 0.0))
    # conductor microfacet (metal); ks holds the scale (1 by default)
    is_metal = mk(ir.MAT_METAL)
    if is_metal is not None:
        F_cond = fresnel_conductor(geom.dot(wi, wh), params.eta_spec,
                                   params.k_spec)
        f_metal = microfacet_reflection_f(params.ks, wo, wi, ax, ay,
                                          F_cond, params.beckmann)
        f = _add(f, torch.where((is_metal & (ax > 0))[..., None], f_metal,
                                0.0))
    is_substrate = mk(ir.MAT_SUBSTRATE)
    if is_substrate is not None:
        f = _add(f, torch.where(is_substrate[..., None], fresnel_blend_f(
            params.kd, params.ks, wo, wi, ax, ay), 0.0))
    # translucent: lambertian reflection and transmission scaled by the
    # reflect / transmit spectra (materials/translucent.cpp)
    is_transl = mk(ir.MAT_TRANSLUCENT)
    if is_transl is not None:
        f = _add(f, torch.where((is_transl & refl)[..., None],
                                params.kr * params.kd * INV_PI, 0.0))
        f = _add(f, torch.where((is_transl & ~refl)[..., None],
                                params.kt * params.kd * INV_PI, 0.0))
    # the fork's retroreflective lobe, peaked at wi == wo
    is_retro = mk(ir.MAT_RETRO)
    if is_retro is not None:
        f_ret = params.ks * _retro_d(geom.dot(wi, wo),
                                     torch.clamp(ax, min=1e-3))[..., None]
        f = _add(f, torch.where((is_retro & refl)[..., None], f_ret, 0.0))
    if params.disney is not None:
        is_disney = t == ir.MAT_DISNEY
        f = _add(f, torch.where((is_disney & refl)[..., None],
                                _disney_f_refl(params, wo, wi), 0.0))
        dz = _disney_unpack(params)
        # specTrans transmission: kt already holds sqrt(baseColor)
        f = _add(f, torch.where((is_disney & ~refl)[..., None],
                                f_rg_t * ((1.0 - dz[0]) * dz[6])[..., None],
                                0.0))
    if f is None:
        f = torch.zeros_like(params.kd)
    # hair (materials/hair.cpp through materials/hair.py), in its frame
    if params.hair_h is not None:
        f = torch.where((t == ir.MAT_HAIR)[..., None], hairmod.hair_eval(
            wo, wi, params.hair_h, params.kd, **_hair_args(params)), f)
    # the Sw exit lobe at a probe's exit point: Fresnel transmission
    # scaled to unit albedo, cosine-shaped (SeparableBSSRDF::Sw,
    # bssrdf.h:221).  The reference's radiance-mode eta^2 in the adapter
    # cancels the 1/eta^2 its FresnelSpecular entry applied (path.cpp:155,
    # reflection.h:351); the probe event applies no entry factor, so the
    # pair is folded to its net 1 here, as in the JAX package
    if params.sss_c is not None:
        fr_wi = fresnel_dielectric(cos_theta(wi), 1.0, params.eta)
        f = torch.where(((t == ir.MAT_SSW) & refl)[..., None],
                        ((1.0 - fr_wi) / (params.sss_c * PI))[..., None], f)
    # fourier: the baked lattice, one lookup a lattice (F is small)
    if params.fourier_id is not None:
        is_four = t == ir.MAT_FOURIER
        for gi in range(params.fourier_grid.shape[0]):
            rgb = fouriermod.eval_grid(params.fourier_grid[gi], wo, wi)
            f = torch.where((is_four & (params.fourier_id == gi))[..., None],
                            spec.from_rgb(torch.clamp(rgb, min=0.0),
                                          "reflectance"), f)
    return torch.where(valid[..., None], f, 0.0)


@span("shading")
def pdf_f(params: MaterialParams, wo, wi):
    t = params.type
    fam = params.families
    mk = _Masks(t, fam)
    refl = same_hemisphere(wo, wi)
    pdf_diff = torch.where(refl, abs_cos_theta(wi) * INV_PI, 0.0)
    ax, ay = params.rough_u, params.rough_v
    has_diff = mk.has_diff()
    pdf = None if has_diff is None else torch.where(has_diff, pdf_diff, 0.0)
    if _present(fam, ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_METAL,
                ir.MAT_SUBSTRATE, ir.MAT_ROUGHGLASS, *_SSS):
        pdf_ggx = microfacet_reflection_pdf(wo, wi, ax, ay, params.beckmann)
        glossy = mk(ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_METAL, *_SSS)
        if glossy is not None:
            pdf = _add(pdf, torch.where(glossy & (ax > 0), pdf_ggx, 0.0))
        is_substrate = mk(ir.MAT_SUBSTRATE)
        if is_substrate is not None:
            pdf = _add(pdf, torch.where(is_substrate,
                                        0.5 * (pdf_diff + pdf_ggx), 0.0))
    is_rglass = mk(ir.MAT_ROUGHGLASS)
    if is_rglass is not None:
        _, pdf_rg_t = _rough_transmission(params, wo, wi)
        pdf = _add(pdf, torch.where(
            is_rglass, torch.where(refl, pdf_ggx, 0.0) + pdf_rg_t, 0.0))
    is_transl = mk(ir.MAT_TRANSLUCENT)
    if is_transl is not None:
        pdf = _add(pdf, torch.where(is_transl, 2.0 * 0.5 * (
            abs_cos_theta(wi) * INV_PI), 0.0))      # either hemisphere
    is_retro = mk(ir.MAT_RETRO)
    if is_retro is not None:
        cos_r = geom.dot(wi, wo)
        pdf = _add(pdf, torch.where(is_retro, torch.where(
            refl, _retro_d(cos_r, torch.clamp(ax, min=1e-3))
            * torch.abs(cos_r), 0.0), 0.0))
    pdf = (torch.zeros_like(pdf_diff) if pdf is None
           else pdf / mk.n_lobes())
    # disney: its own lobe mixture, outside the n_lobes scheme
    if params.disney is not None:
        pdf = torch.where(t == ir.MAT_DISNEY, _disney_pdf(params, wo, wi),
                          pdf)
    if params.hair_h is not None:
        pdf = torch.where(t == ir.MAT_HAIR, hairmod.hair_pdf(
            wo, wi, params.hair_h, params.kd, **_hair_args(params)), pdf)
    if params.fourier_id is not None:
        # the density of the Catmull-Rom sampler (fourier.py pdf_grid_cr)
        for gi in range(params.fourier_grid.shape[0]):
            pdf = torch.where(
                (t == ir.MAT_FOURIER) & (params.fourier_id == gi),
                fouriermod.pdf_grid_cr(params.fourier_a0[gi],
                                       params.fourier_lum[gi], wo, wi), pdf)
    if params.sss_c is not None:
        # the Sw exit lobe: one-sided cosine (SeparableBSSRDFAdapter keeps
        # BxDF's default cosine sampling)
        pdf = torch.where(t == ir.MAT_SSW, pdf_diff, pdf)
    # uber opacity: the surface lobes are picked with probability 1 - p_tr
    is_uber = mk(ir.MAT_UBER)
    if is_uber is not None:
        transp = torch.clamp(1.0 - params.opacity, 0.0, 1.0).mean(-1)
        pdf = torch.where(is_uber, pdf * (1.0 - transp), pdf)
    return torch.where(mk.is_delta(), 0.0, pdf)


@span("shading")
def sample_f(params: MaterialParams, wo, u_lobe, u1, u2, u3=None):
    """Sample wi; returns (wi, f, pdf, is_specular, transmitted, eta_fac).

    u3: the hair azimuth's uniform; without it a hash of u1 and u2 stands
    in (the JAX package's fallback).

    eta_fac: multiplicative update of the path's etaScale (Russian-roulette
    radiance correction, reference path.cpp:150-156)."""
    t = params.type
    fam = params.families
    mk = _Masks(t, fam)
    ax, ay = params.rough_u, params.rough_v
    sgn = torch.sign(wo[..., 2:3])

    # uber opacity: a specular eta = 1 transmission with T = 1 - opacity
    # (uber.cpp:40-58), sampled so transparent lanes pass straight on
    is_uber = mk(ir.MAT_UBER)
    if is_uber is not None:
        transp = torch.clamp(1.0 - params.opacity, 0.0, 1.0)
        p_tr = torch.where(is_uber, transp.mean(-1), 0.0)
        pick_pass = u_lobe < p_tr
        u_lobe = torch.where(
            p_tr > 0, torch.clamp((u_lobe - p_tr)
                                  / torch.clamp(1.0 - p_tr, min=1e-6),
                                  0.0, 1.0 - 1e-7), u_lobe)

    need_ggx = _present(fam, ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_METAL,
                        ir.MAT_SUBSTRATE, ir.MAT_ROUGHGLASS, ir.MAT_DISNEY,
                        *_SSS)
    need_rt = _present(fam, ir.MAT_ROUGHGLASS, ir.MAT_DISNEY)
    ones = torch.ones_like(sgn)
    wi_diff = sampling.cosine_sample_hemisphere(u1, u2) * torch.cat(
        [ones, ones, sgn], -1)
    wi = wi_diff
    if need_ggx:
        wh = mf_sample_wh(wo, u1, u2, torch.clamp(ax, min=1e-4),
                          torch.clamp(ay, min=1e-4), params.beckmann)
        wi_ggx = geom.reflect(wo, wh)
        # one lobe uniformly among the material's (BSDF::Sample_f)
        two_lobe = mk(ir.MAT_PLASTIC, ir.MAT_UBER, ir.MAT_SUBSTRATE, *_SSS)
        pick_spec = None if two_lobe is None else two_lobe & (u_lobe >= 0.5)
        is_metal = mk(ir.MAT_METAL)
        if is_metal is not None:
            pick_spec = (is_metal if pick_spec is None
                         else pick_spec | is_metal)
        if pick_spec is not None:
            wi = torch.where(pick_spec[..., None], wi_ggx, wi_diff)
    if need_rt:
        # rough-glass transmission: refract wo about the sampled wh
        eta_rg = torch.where(cos_theta(wo) > 0, 1.0 / params.eta,
                             params.eta)
        can_rt, wi_rt = geom.refract(wo, torch.where(
            geom.dot(wo, wh)[..., None] >= 0, wh, -wh), eta_rg)
    is_rglass = mk(ir.MAT_ROUGHGLASS)
    if is_rglass is not None:
        wi_rg = torch.where((u_lobe < 0.5)[..., None], wi_ggx,
                            torch.where(can_rt[..., None], wi_rt, wi_ggx))
        wi = torch.where(is_rglass[..., None], wi_rg, wi)
    is_transl = mk(ir.MAT_TRANSLUCENT)
    if is_transl is not None:
        # the transmission half flips the hemisphere
        wi_tr = torch.where((u_lobe < 0.5)[..., None], wi_diff,
                            wi_diff * torch.tensor([1.0, 1.0, -1.0],
                                                   device=wo.device))
        wi = torch.where(is_transl[..., None], wi_tr, wi)
    is_retro = mk(ir.MAT_RETRO)
    if is_retro is not None:
        # the retro lobe: a GGX-shaped spread around +wo
        a2 = torch.clamp(ax, min=1e-3) ** 2
        cos_rr = torch.sqrt(torch.clamp(
            (1.0 - u1) / torch.clamp(u1 * (a2 - 1.0) + 1.0, min=1e-9),
            min=0.0))
        sin_rr = torch.sqrt(torch.clamp(1.0 - cos_rr * cos_rr, min=1e-14))
        phi_r = 2 * PI * u2
        b1v, b2v = geom.coordinate_system(wo)
        wi_retro = geom.normalize(
            (sin_rr * torch.cos(phi_r))[..., None] * b1v
            + (sin_rr * torch.sin(phi_r))[..., None] * b2v
            + cos_rr[..., None] * wo)
        wi = torch.where(is_retro[..., None], torch.where(
            (u_lobe < 0.5)[..., None], wi_diff, wi_retro), wi)
    # disney: the mixture over (cosine, GGX, GTR1 clearcoat, specTrans)
    # with the probabilities _disney_pdf integrates
    is_disney = None
    if params.disney is not None:
        is_disney = t == ir.MAT_DISNEY
        dw = _disney_weights(params)
        dc1 = dw[..., 0]
        dc2 = dc1 + dw[..., 1]
        dc3 = dc2 + dw[..., 2]
        cc_gloss = _disney_unpack(params)[5]
        acc = 0.1 * (1.0 - cc_gloss) + 0.001 * cc_gloss
        a2c = torch.clamp(acc * acc, 1e-6, 1.0 - 1e-4)
        ch2 = torch.clamp((1.0 - a2c ** (1.0 - u1)) / (1.0 - a2c), 0.0, 1.0)
        ch = torch.sqrt(ch2)
        shc = torch.sqrt(torch.clamp(1.0 - ch2, min=1e-14))
        phic = 2 * PI * u2
        wh_cc = torch.cat([(shc * torch.cos(phic))[..., None],
                           (shc * torch.sin(phic))[..., None],
                           ch[..., None] * sgn], -1)
        wi_cc = geom.reflect(wo, wh_cc)
        wi_dis = torch.where(
            (u_lobe < dc1)[..., None], wi_diff,
            torch.where((u_lobe < dc2)[..., None], wi_ggx,
                        torch.where((u_lobe < dc3)[..., None], wi_cc,
                                    torch.where(can_rt[..., None], wi_rt,
                                                wi_ggx))))
        wi = torch.where(is_disney[..., None], wi_dis, wi)
    # hair: the Chiang model's importance sampling (hair.cpp:389)
    is_hair = None
    if params.hair_h is not None:
        is_hair = t == ir.MAT_HAIR
        if u3 is None:
            u3 = _rng.uniform_float(_rng.hash_combine(
                (u1 * 16777216.0).to(torch.int64),
                (u2 * 16777216.0).to(torch.int64)))
        wi_hair, _, _ = hairmod.hair_sample(
            wo, params.hair_h, params.kd,
            torch.stack([u_lobe, u1, u2, u3], -1), **_hair_args(params))
        wi = torch.where(is_hair[..., None], wi_hair, wi)
    # fourier: invert the baked marginals (FourierBSDF::Sample_f,
    # reflection.cpp:491-573); pdf_f has the matching density
    is_four = None
    if params.fourier_id is not None:
        is_four = t == ir.MAT_FOURIER
        wi_four = wi_diff
        for gi in range(params.fourier_grid.shape[0]):
            wi_four = torch.where(
                (params.fourier_id == gi)[..., None],
                fouriermod.sample_grid_cr(params.fourier_a0[gi],
                                          params.fourier_lum[gi], wo,
                                          u_lobe, u1, u2), wi_four)
        wi = torch.where(is_four[..., None], wi_four, wi)

    # delta lobes
    is_none = t == ir.MAT_NONE
    entering = cos_theta(wo) > 0
    is_mirror = mk(ir.MAT_MIRROR)
    is_glass = mk(ir.MAT_GLASS)
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    if is_mirror is not None:
        wi = torch.where(is_mirror[..., None], wi_mirror, wi)
    if is_glass is not None:
        # smooth glass: Fresnel-weighted reflect / transmit
        F = fresnel_dielectric(cos_theta(wo), 1.0, params.eta)
        eta_ratio = torch.where(entering, 1.0 / params.eta, params.eta)
        zero = torch.zeros_like(sgn)
        can_refract, wi_t = geom.refract(wo, torch.cat([zero, zero, sgn], -1),
                                         eta_ratio)
        do_reflect = (u_lobe < F) | ~can_refract
        wi = torch.where(is_glass[..., None], torch.where(
            do_reflect[..., None], wi_mirror, wi_t), wi)
    # the "none" interface: straight through
    wi = torch.where(is_none[..., None], -wo, wi)
    wi = geom.normalize(wi)

    f = eval_f(params, wo, wi)
    pdf = pdf_f(params, wo, wi)

    # delta overrides
    abs_ci = torch.clamp(abs_cos_theta(wi), min=1e-9)[..., None]
    if is_mirror is not None:
        f = torch.where(is_mirror[..., None], params.kr / abs_ci, f)
        pdf = torch.where(is_mirror, 1.0, pdf)
    if is_glass is not None:
        f_glass = torch.where(
            do_reflect[..., None], F[..., None] / abs_ci * params.kr,
            ((1.0 - F) * eta_ratio * eta_ratio)[..., None] / abs_ci
            * params.kt)
        pdf_glass = torch.where(do_reflect, torch.where(can_refract, F, 1.0),
                                1.0 - F)
        f = torch.where(is_glass[..., None], f_glass, f)
        pdf = torch.where(is_glass, pdf_glass, pdf)
    f = torch.where(is_none[..., None], 1.0 / abs_ci, f)
    pdf = torch.where(is_none, 1.0, pdf)
    is_delta = mk.is_delta()

    # uber pass-through, after every other lobe; the (1 - p_tr) factor of
    # the surface lobes is in pdf_f
    if is_uber is not None:
        wi = torch.where(pick_pass[..., None], geom.normalize(-wo), wi)
        abs_ci = torch.clamp(abs_cos_theta(wi), min=1e-9)
        f = torch.where(pick_pass[..., None],
                        transp / (abs_ci[..., None]
                                  * torch.clamp(p_tr, min=1e-6)[..., None]),
                        f)
        pdf = torch.where(pick_pass, 1.0, pdf)
        is_delta = is_delta | pick_pass

    # transmitted lanes; etaScale: eta^2 entering, 1/eta^2 exiting
    # (path.cpp:150-156) for the dielectrics
    crossed = None
    transmitted = None
    if is_glass is not None:
        transmitted = is_glass & ~do_reflect
    through = _or(_or(mk(ir.MAT_ROUGHGLASS, ir.MAT_DISNEY,
                         ir.MAT_TRANSLUCENT), is_hair), is_four)
    if through is not None:
        crossed = through & ~same_hemisphere(wo, wi)
        transmitted = _or(transmitted, crossed)
    if is_uber is not None:
        transmitted = _or(transmitted, pick_pass)
    if transmitted is None:
        transmitted = torch.zeros_like(is_none)
    dielectric = _or(is_glass, mk(ir.MAT_ROUGHGLASS, ir.MAT_DISNEY))
    if dielectric is None:
        eta_fac = torch.ones_like(u_lobe)
    else:
        eta_fac = torch.where(transmitted & dielectric,
                              torch.where(entering, params.eta ** 2,
                                          1.0 / params.eta ** 2), 1.0)
    return wi, f, pdf, is_delta, transmitted, eta_fac


def _or(a, b):
    if a is None:
        return b
    return a if b is None else a | b
