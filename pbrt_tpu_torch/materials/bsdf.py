"""Vectorized spectral BSDFs with mask-based type dispatch (port of the
MATTE, PLASTIC, MIRROR and GLASS families of pbrt_tpu.materials.bsdf).

Each lane carries a gathered material record; each family is a
closed-form eval/sample/pdf computed under a lane mask.  Shading frame:
z = shading normal, wo/wi point away from the surface, eval returns f
without the cosine.  Spectra are [..., 31].  Other material families are
not ported: the scene builder rejects them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.scene import ir

INV_PI = sampling.INV_PI
PI = sampling.PI


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

    def to(self, device):
        return MaterialParams(*(getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)))


def roughness_to_alpha(rough):
    """pbrt's RoughnessToAlpha (microfacet.h:83)."""
    x = torch.log(torch.clamp(rough, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def gather_materials(scene: ir.SceneData, material_idx) -> MaterialParams:
    """Per-lane material records by plain indexing of the material table."""
    m = torch.clamp(material_idx, 0, scene.mat_type.shape[0] - 1).long()
    rough_u, rough_v = scene.mat_rough_u[m], scene.mat_rough_v[m]
    remap = scene.mat_remap_rough[m]
    au = torch.where(remap, roughness_to_alpha(rough_u), rough_u)
    av = torch.where(remap, roughness_to_alpha(rough_v), rough_v)
    # rough == 0 stays 0 (the perfect-specular marker)
    au = torch.where(rough_u > 0, torch.clamp(au, min=1e-3), 0.0)
    av = torch.where(rough_v > 0, torch.clamp(av, min=1e-3), 0.0)
    return MaterialParams(
        type=torch.where(material_idx >= 0, scene.mat_type[m], ir.MAT_NONE),
        kd=scene.mat_kd[m], ks=scene.mat_ks[m], kr=scene.mat_kr[m],
        kt=scene.mat_kt[m], rough_u=au, rough_v=av, eta=scene.mat_eta[m],
        sigma=scene.mat_sigma[m])


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
    """Sample the visible GGX NDF (Heitz 2018; TrowbridgeReitzSample)."""
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
# lobes
# ---------------------------------------------------------------------------

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


def microfacet_reflection_f(ks, wo, wi, ax, ay, F):
    """Torrance-Sparrow (reflection.cpp:408): D G F / (4 cos_o cos_i)."""
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh, wh_ok = _safe_half(wo, wi)
    ok = (co > 1e-6) & (ci > 1e-6) & wh_ok & same_hemisphere(wo, wi)
    dg = ggx_d(wh, ax, ay) * ggx_g(wo, wi, ax, ay)
    f = ks * F * (dg / torch.clamp(4 * co * ci, min=1e-9))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def microfacet_reflection_pdf(wo, wi, ax, ay):
    wh, wh_ok = _safe_half(wo, wi)
    pdf = ggx_pdf_wh(wo, wh, ax, ay) / torch.clamp(
        4 * torch.abs(geom.dot(wo, wh)), min=1e-9)
    return torch.where(same_hemisphere(wo, wi) & wh_ok, pdf, 0.0)


def _masks(t):
    has_diff = (t == ir.MAT_MATTE) | (t == ir.MAT_PLASTIC)
    is_plastic = t == ir.MAT_PLASTIC
    is_delta = (t == ir.MAT_MIRROR) | (t == ir.MAT_GLASS) | (t == ir.MAT_NONE)
    n_lobes = torch.clamp(has_diff.float() + is_plastic.float(), min=1.0)
    return has_diff, is_plastic, is_delta, n_lobes


def eval_f(params: MaterialParams, wo, wi):
    """f(wo, wi) of the non-delta lobes, local frame; [B,31]."""
    t = params.type
    has_diff, is_plastic, is_delta, _ = _masks(t)
    valid = ((abs_cos_theta(wo) > 1e-6) & (abs_cos_theta(wi) > 1e-6)
             & ~is_delta)
    f_diff = torch.where((params.sigma > 1e-6)[..., None],
                         oren_nayar_f(params.kd, params.sigma, wo, wi),
                         params.kd * INV_PI)
    f = torch.where((has_diff & same_hemisphere(wo, wi))[..., None],
                    f_diff, 0.0)
    ax, ay = params.rough_u, params.rough_v
    wh, _ = _safe_half(wo, wi)
    F = fresnel_dielectric(geom.dot(wi, wh), 1.0, params.eta)[..., None]
    f_spec = microfacet_reflection_f(params.ks, wo, wi, ax, ay, F)
    f = f + torch.where((is_plastic & (ax > 0))[..., None], f_spec, 0.0)
    return torch.where(valid[..., None], f, 0.0)


def pdf_f(params: MaterialParams, wo, wi):
    has_diff, is_plastic, is_delta, n_lobes = _masks(params.type)
    pdf_diff = torch.where(same_hemisphere(wo, wi),
                           abs_cos_theta(wi) * INV_PI, 0.0)
    ax, ay = params.rough_u, params.rough_v
    pdf = torch.where(has_diff, pdf_diff, 0.0)
    pdf = pdf + torch.where(is_plastic & (ax > 0),
                            microfacet_reflection_pdf(wo, wi, ax, ay), 0.0)
    return torch.where(is_delta, 0.0, pdf / n_lobes)


def sample_f(params: MaterialParams, wo, u_lobe, u1, u2):
    """Sample wi; returns (wi, f, pdf, is_specular, transmitted, eta_fac).

    eta_fac: multiplicative update of the path's etaScale (Russian-roulette
    radiance correction, reference path.cpp:150-156)."""
    t = params.type
    has_diff, is_plastic, is_delta, _ = _masks(t)
    is_mirror = t == ir.MAT_MIRROR
    is_glass = t == ir.MAT_GLASS
    is_none = t == ir.MAT_NONE
    ax, ay = params.rough_u, params.rough_v
    sgn = torch.sign(wo[..., 2:3])
    ones = torch.ones_like(sgn)
    wi_diff = sampling.cosine_sample_hemisphere(u1, u2) * torch.cat(
        [ones, ones, sgn], -1)
    wh = ggx_sample_wh(wo, u1, u2, torch.clamp(ax, min=1e-4),
                       torch.clamp(ay, min=1e-4))
    # plastic: uniform choice between its diffuse and glossy lobes
    pick_spec = is_plastic & (u_lobe >= 0.5)
    wi = torch.where(pick_spec[..., None], geom.reflect(wo, wh), wi_diff)
    entering = wo[..., 2] > 0
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    wi = torch.where(is_mirror[..., None], wi_mirror, wi)
    # smooth glass: Fresnel-weighted reflect / transmit
    F = fresnel_dielectric(wo[..., 2], 1.0, params.eta)
    eta_ratio = torch.where(entering, 1.0 / params.eta, params.eta)
    n_up = torch.cat([torch.zeros_like(sgn), torch.zeros_like(sgn), sgn], -1)
    can_refract, wi_t = geom.refract(wo, n_up, eta_ratio)
    do_reflect = (u_lobe < F) | ~can_refract
    wi = torch.where(is_glass[..., None],
                     torch.where(do_reflect[..., None], wi_mirror, wi_t), wi)
    # no material (an interface): pass straight through
    wi = torch.where(is_none[..., None], -wo, wi)
    wi = geom.normalize(wi)

    f = eval_f(params, wo, wi)
    pdf = pdf_f(params, wo, wi)
    abs_ci = torch.clamp(abs_cos_theta(wi), min=1e-9)[..., None]
    f = torch.where(is_mirror[..., None], params.kr / abs_ci, f)
    pdf = torch.where(is_mirror, 1.0, pdf)
    f_glass = torch.where(
        do_reflect[..., None], F[..., None] / abs_ci * params.kr,
        ((1.0 - F) * eta_ratio * eta_ratio)[..., None] / abs_ci * params.kt)
    pdf_glass = torch.where(do_reflect, torch.where(can_refract, F, 1.0),
                            1.0 - F)
    f = torch.where(is_glass[..., None], f_glass, f)
    pdf = torch.where(is_glass, pdf_glass, pdf)
    f = torch.where(is_none[..., None], 1.0 / abs_ci, f)
    pdf = torch.where(is_none, 1.0, pdf)

    transmitted = is_glass & ~do_reflect
    eta_fac = torch.where(transmitted,
                          torch.where(entering, params.eta ** 2,
                                      1.0 / params.eta ** 2), 1.0)
    return wi, f, pdf, is_delta, transmitted, eta_fac
