"""Reference-exact path integrator, the matched-RNG parity mode (port of
pbrt_tpu.integrators.refpath).

Replays pbrt-v3's PathIntegrator sample for sample, so that a render at
equal spp with the reference-exact Sobol' stream agrees with the
reference binary pixel by pixel:

- Estimator structure: emitted light counts only at specular and camera
  vertices; each vertex runs EstimateDirect's two estimators, a
  light-sampled shadow ray and a BSDF-sampled probe ray traced to the
  chosen light (integrator.cpp:108-216).  Per bounce it traces three
  rays: the continuation (closest hit), the probe (closest hit) and the
  shadow ray (any hit), as one batch through `intersect`.
- Dimension stream: pbrt's GlobalSampler consumes Sobol' dimensions in
  sequence; a specular vertex takes 2 and a diffuse one 7 (+1 for Russian
  roulette after bounce 3), so the dimension is counted per lane.
- Sample mappings: BSDF::Sample_f's component choice and u remap,
  TrowbridgeReitzSample11, CosineSampleHemisphere, UniformSampleTriangle
  and FrDielectric, as the reference writes them.
- Lights: one DiffuseAreaLight per triangle of an area-lit mesh and one
  per area-lit sphere (api.cpp:1609), chosen uniformly; a sphere is
  sampled by its cone from outside and by its area from inside
  (sphere.cpp:232+).  The infinite light is counted on escaped camera and
  specular rays only; NEE does not sample it (the JAX package's list).

Supported: matte (sigma 0), plastic, mirror and smooth glass
(SUPPORTED_MATS, the JAX package's), with textured Kd / Ks looked up at
the finest level and mix materials resolved per lane by a hash of the hit
point; triangle and sphere area lights, and the infinite light's
emission; the perspective camera; no media.  A scene with another
material family raises (the JAX package renders its lanes black).

Ray offsets: the default ("scaled") offsets a spawned origin by
REF_EPS_SCALE times |p| along the geometric normal, the construction the
JAX package measured best on its parity scenes; offset="pbrt" is the
reference's own (the barycentric hit point, a gamma(7) error box and
OffsetRayOrigin's rounding away, geometry.h:1449-1465).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.cameras import projective
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.core import lds
from pbrt_tpu_torch.core import rng as _rng
from pbrt_tpu_torch.core import sampling
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.integrators import path as pathmod
from pbrt_tpu_torch.lights import lights as lightsmod
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.scene import ir

PI = sampling.PI
INV_PI = sampling.INV_PI

# spawn offset relative to |p| (the JAX package's value, measured on its
# intersector: the 99.97% point of |p32 - p64| / |p| over the killeroo
# parity crop, scripts/measure_fp_envelope.py)
REF_EPS_SCALE = 1.5e-6
OFFSET_MODES = ("scaled", "pbrt")
SUPPORTED_MATS = (ir.MAT_MATTE, ir.MAT_PLASTIC, ir.MAT_MIRROR, ir.MAT_GLASS)
_GAMMA7 = float(7 * 2.0 ** -24 / (1 - 7 * 2.0 ** -24))
_NEG_MIN_SUBNORMAL = int(np.float32(-1e-45).view(np.int32))


def _next_float_up(x):
    """pbrt NextFloatUp (pbrt.h:210): one ulp toward +inf."""
    b = x.view(torch.int32)
    bu = torch.where(x >= 0, b + 1, b - 1)
    bu = torch.where(x == 0.0, 1, bu)                  # +-0 -> smallest +
    return bu.view(torch.float32)


def _next_float_down(x):
    b = x.view(torch.int32)
    bd = torch.where(x > 0, b - 1, b + 1)
    bd = torch.where(x == 0.0, _NEG_MIN_SUBNORMAL, bd)
    return bd.view(torch.float32)


def offset_ray_origin(p, p_err, n, w):
    """pbrt OffsetRayOrigin (geometry.h:1449): offset along the geometric
    normal by the hit's error box, each component rounded away."""
    offset = geom.dot(torch.abs(n), p_err)[:, None] * n
    offset = torch.where(geom.dot(w, n)[:, None] < 0, -offset, offset)
    po = p + offset
    return torch.where(offset > 0, _next_float_up(po),
                       torch.where(offset < 0, _next_float_down(po), po))


# ---------------------------------------------------------------------------
# the reference-exact sampler stream
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RefSampler:
    """The pbrt SobolSampler twin (sobol.h/.cpp, scramble 0)."""
    width: int
    height: int
    m: int                 # log2(RoundUpPow2(max(W, H)))  (sobol.h:61)

    @staticmethod
    def make(width, height):
        m = 0
        while (1 << m) < max(width, height):
            m += 1
        return RefSampler(width, height, m)

    def index(self, pixel_id, sample_idx):
        """The global Sobol' index of (pixel, sample): int64 tensors."""
        return lds.sobol_global_index(sample_idx, pixel_id % self.width,
                                      pixel_id // self.width, self.m)

    def dim(self, index, d):
        """SampleDimension for d >= 2 (sobol.cpp:48); d an int or an int64
        tensor of per-lane dimension counters."""
        return lds.sobol_sample_pbrt(index, d)

    def film_xy(self, index, pixel_id):
        """Dims 0/1 remapped to the in-pixel offset (sobol.cpp:53-57)."""
        px = (pixel_id % self.width).to(torch.float32)
        py = (pixel_id // self.width).to(torch.float32)
        res = float(1 << self.m)
        jx = torch.clamp(lds.sobol_sample_pbrt(index, 0) * res - px,
                         0.0, _rng.ONE_MINUS_EPS)
        jy = torch.clamp(lds.sobol_sample_pbrt(index, 1) * res - py,
                         0.0, _rng.ONE_MINUS_EPS)
        return jx, jy


# ---------------------------------------------------------------------------
# the flattened pbrt light list (one light per area-lit triangle)
# ---------------------------------------------------------------------------

@dataclass
class RefLights:
    p0: torch.Tensor         # [K,3]
    e1: torch.Tensor         # [K,3]
    e2: torch.Tensor         # [K,3]
    n: torch.Tensor          # [K,3] oriented unit normal (flip applied)
    area: torch.Tensor       # [K]
    L: torch.Tensor          # [K,31]
    two_sided: torch.Tensor  # [K] bool
    prim: torch.Tensor       # [K] scene prim id (BVH order)
    sphere: torch.Tensor     # [K] bool: a sphere, not a triangle
    center: torch.Tensor     # [K,3] sphere centre (world; 0 for triangles)
    radius: torch.Tensor     # [K] sphere radius (world; 0 for triangles)
    nsign: torch.Tensor      # [K] sphere normal sign (ReverseOrientation)
    # any sphere entry: without one the sphere code is not run
    has_spheres: bool = False

    @property
    def count(self):
        return self.prim.shape[0]


def build_ref_lights(scene: ir.SceneData) -> RefLights:
    """Flatten the scene's area lights into pbrt's one-light-per-shape
    list, on the scene's device.

    Walks the light records in order, as pbrt creates its lights in
    scene-file order (api.cpp:1609): a sphere light gives one entry
    (Sphere::Area = 4 pi r^2), a mesh light one per triangle, and
    degenerate triangles none."""
    dev = scene.tri_v0.device
    lt = scene.light_tri_idx.cpu().numpy()
    lq = scene.light_quad.cpu().numpy()
    qprim = scene.quad_prim.cpu().numpy()
    tv0, te1, te2 = (x.cpu().numpy() for x in (scene.tri_v0, scene.tri_e1,
                                                scene.tri_e2))
    flips = scene.prim_flip_normal.cpu().numpy()
    lL = scene.light_L.cpu().numpy()
    two = scene.light_two_sided.cpu().numpy()
    sphc = scene.light_sph_center.cpu().numpy()
    sphr = scene.light_sph_radius.cpu().numpy()
    z3 = np.zeros(3, np.float32)
    rows = []
    for li in range(lt.shape[0]):
        if lq[li] >= 0:
            prim = int(qprim[lq[li]])
            r = float(sphr[li])
            rows.append((z3, z3, z3, z3, 4.0 * PI * r * r, lL[li],
                         bool(two[li]), prim, True, sphc[li], r,
                         -1.0 if flips[prim] else 1.0))
            continue
        for prim in lt[li][lt[li] >= 0]:
            v0, e1, e2 = tv0[prim], te1[prim], te2[prim]
            n = np.cross(e1, e2)
            nl = np.linalg.norm(n)
            if nl < 1e-20:
                continue
            n = n / nl
            if flips[prim]:
                n = -n
            rows.append((v0, e1, e2, n, 0.5 * nl, lL[li], bool(two[li]),
                         int(prim), False, z3, 0.0, 1.0))
    if not rows:
        raise ValueError("refpath: scene has no area lights")

    def col(i, dtype=np.float32):
        return torch.as_tensor(np.asarray([r[i] for r in rows], dtype),
                               device=dev)

    return RefLights(p0=col(0), e1=col(1), e2=col(2), n=col(3), area=col(4),
                     L=col(5), two_sided=col(6, bool), prim=col(7, np.int64),
                     sphere=col(8, bool), center=col(9), radius=col(10),
                     nsign=col(11), has_spheres=any(r[8] for r in rows))


# ---------------------------------------------------------------------------
# the reference-exact BSDF layer (matte / plastic / mirror / smooth glass)
# ---------------------------------------------------------------------------

def fr_dielectric(cos_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:66), entering or exiting by sign."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    si = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    st = ei / et * si
    ct = torch.sqrt(torch.clamp(1.0 - st * st, min=0.0))
    rpar = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    rper = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    return torch.where(st >= 1, 1.0, 0.5 * (rpar * rpar + rper * rper))


def tr_sample_11(cos_theta, u1, u2):
    """TrowbridgeReitzSample11 (microfacet.cpp:187)."""
    ct = torch.clamp(cos_theta, min=1e-7)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    tant = st / ct
    a = 1.0 / torch.clamp(tant, min=1e-12)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a * a)))
    A = 2.0 * u1 / torch.clamp(g1, min=1e-12) - 1.0
    tmp = 1.0 / torch.clamp(A * A - 1.0, min=-1e30)
    tmp = torch.where(torch.abs(A * A - 1.0) < 1e-12, 1e10, tmp)
    tmp = torch.clamp(tmp, max=1e10)
    Bt = tant
    D = torch.sqrt(torch.clamp(Bt * Bt * tmp * tmp - (A * A - Bt * Bt) * tmp,
                               min=0.0))
    sx1 = Bt * tmp - D
    sx2 = Bt * tmp + D
    slope_x = torch.where((A < 0) | (sx2 > 1.0 / torch.clamp(tant, min=1e-12)),
                          sx1, sx2)
    S = torch.where(u2 > 0.5, 1.0, -1.0)
    u2p = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2p * (u2p * (u2p * 0.27385 - 0.73369) + 0.46341)) / \
        (u2p * (u2p * (u2p * 0.093073 + 0.309420) - 1.0) + 0.597999)
    slope_y = S * z * torch.sqrt(1.0 + slope_x * slope_x)
    # normal incidence
    r = torch.sqrt(torch.clamp(u1 / torch.clamp(1.0 - u1, min=1e-12),
                               min=0.0))
    phi = 6.28318530718 * u2
    near = cos_theta > 0.9999
    slope_x = torch.where(near, r * torch.cos(phi), slope_x)
    slope_y = torch.where(near, r * torch.sin(phi), slope_y)
    return slope_x, slope_y


def tr_sample_wh(wo, ax, ay, u1, u2):
    """TrowbridgeReitzDistribution::Sample_wh, visible-area branch
    (microfacet.cpp:244)."""
    flip = wo[..., 2] < 0
    w = torch.where(flip[..., None], -wo, wo)
    ws = geom.normalize(torch.stack(
        [ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    sx, sy = tr_sample_11(ws[..., 2], u1, u2)
    s2 = torch.clamp(1.0 - ws[..., 2] ** 2, min=0.0)
    inv_s = 1.0 / torch.sqrt(torch.clamp(s2, min=1e-20))
    cos_phi = torch.where(s2 > 1e-20, ws[..., 0] * inv_s, 1.0)
    sin_phi = torch.where(s2 > 1e-20, ws[..., 1] * inv_s, 0.0)
    sx, sy = cos_phi * sx - sin_phi * sy, sin_phi * sx + cos_phi * sy
    wh = geom.normalize(torch.stack([-ax * sx, -ay * sy,
                                     torch.ones_like(sx)], -1))
    return torch.where(flip[..., None], -wh, wh)


def _same_hemi(a, b):
    return a[..., 2] * b[..., 2] > 0


def _lobes_on(mat):
    """(kd on, ks on): black-reflectance lobes are never created
    (matte.cpp:49 and its kin)."""
    return (mat.kd > 0).any(-1), (mat.ks > 0).any(-1)


def _nonspec_counts(mat):
    """NumComponents(BSDF_ALL & ~BSDF_SPECULAR) per lane (path.cpp:122)."""
    kd_on, ks_on = _lobes_on(mat)
    t = mat.type
    n = torch.zeros_like(t)
    n = torch.where(t == ir.MAT_MATTE, kd_on.to(n.dtype), n)
    return torch.where(t == ir.MAT_PLASTIC,
                       kd_on.to(n.dtype) + ks_on.to(n.dtype), n)


def ref_f(mat, wo, wi, reflect_geo):
    """BSDF::f over the non-specular lobes (reflection.cpp:576), each lobe
    kept by the geometric-normal reflect / transmit test."""
    t = mat.type
    f = torch.zeros(wo.shape[:-1] + (spec.N_SPECTRAL_SAMPLES,),
                    device=wo.device)
    use_lam = ((t == ir.MAT_MATTE) | (t == ir.MAT_PLASTIC)) & reflect_geo
    f = torch.where(use_lam[..., None], f + mat.kd * INV_PI, f)
    # plastic's glossy lobe (MicrofacetReflection, FresnelDielectric 1.5)
    is_pl = (t == ir.MAT_PLASTIC) & reflect_geo
    ax, ay = mat.rough_u, mat.rough_v
    co = torch.abs(wo[..., 2])
    ci = torch.abs(wi[..., 2])
    wh = wo + wi
    wh_len = geom.length(wh)
    ok = (co > 1e-9) & (ci > 1e-9) & (wh_len > 1e-9)
    whn = wh / torch.clamp(wh_len, min=1e-9)[..., None]
    # the fork's vintage takes Fresnel at the raw Dot(wi, wh), with no
    # Faceforward (reflection.cpp:233), as FresnelDielectric(1.5, 1.0)
    # (plastic.cpp:58's argument order)
    Fr = fr_dielectric(geom.dot(wi, whn), 1.5, 1.0)
    d = bsdf.ggx_d(whn, ax, ay)
    g = bsdf.ggx_g(wo, wi, ax, ay)
    spec_f = mat.ks * (d * g * Fr
                       / torch.clamp(4.0 * ci * co, min=1e-12))[..., None]
    return torch.where((is_pl & ok)[..., None], f + spec_f, f)


def ref_pdf(mat, wo, wi):
    """BSDF::Pdf over the non-specular lobes, averaged over them."""
    t = mat.type
    lam_pdf = torch.where(_same_hemi(wo, wi), torch.abs(wi[..., 2]) * INV_PI,
                          0.0)
    kd_on, ks_on = _lobes_on(mat)
    n = _nonspec_counts(mat)
    pdf = torch.zeros_like(lam_pdf)
    pdf = torch.where(kd_on & ((t == ir.MAT_MATTE) | (t == ir.MAT_PLASTIC)),
                      pdf + lam_pdf, pdf)
    mf_pdf = bsdf.microfacet_reflection_pdf(wo, wi, mat.rough_u, mat.rough_v)
    pdf = torch.where(ks_on & (t == ir.MAT_PLASTIC), pdf + mf_pdf, pdf)
    return torch.where(n > 0, pdf / torch.clamp(n.to(pdf.dtype), min=1.0),
                       0.0)


def ref_sample_nonspec(mat, wo, u1, u2):
    """BSDF::Sample_f with flags ALL & ~SPECULAR (EstimateDirect's
    scattering estimator).  Returns (wi, f, pdf, valid)."""
    t = mat.type
    kd_on, ks_on = _lobes_on(mat)
    n = _nonspec_counts(mat)
    nf = torch.clamp(n.to(torch.float32), min=1.0)
    # component choice and u remap (reflection.cpp:560-570)
    comp = torch.minimum((u1 * nf).to(n.dtype), n - 1)
    u1r = torch.clamp(u1 * nf - comp.to(torch.float32),
                      max=_rng.ONE_MINUS_EPS)
    # BxDF order: matte [lambert]; plastic [lambert, microfacet], only
    # the glossy lobe when kd is black
    pick_gloss = (t == ir.MAT_PLASTIC) & (((comp == 1) & kd_on) | ~kd_on) \
        & ks_on
    wi_lam = sampling.cosine_sample_hemisphere(u1r, u2)
    wi_lam = torch.where((wo[..., 2] < 0)[..., None],
                         wi_lam * wi_lam.new_tensor([1.0, 1.0, -1.0]), wi_lam)
    wh = tr_sample_wh(wo, mat.rough_u, mat.rough_v, u1r, u2)
    wi_mf = 2.0 * geom.dot(wo, wh)[..., None] * wh - wo
    mf_ok = (geom.dot(wo, wh) > 0) & _same_hemi(wo, wi_mf) \
        & (torch.abs(wo[..., 2]) > 0)
    wi = torch.where(pick_gloss[..., None], wi_mf, wi_lam)
    valid = torch.where(pick_gloss, mf_ok, True) & (n > 0)
    pdf = ref_pdf(mat, wo, wi)
    # shading and geometric normals agree on the parity set
    f = ref_f(mat, wo, wi, _same_hemi(wo, wi))
    return wi, f, pdf, valid & (pdf > 0)


def ref_sample_all(mat, wo, u1, u2, ng_dot_wo):
    """BSDF::Sample_f with flags BSDF_ALL (the path's continuation).

    Returns (wi, f, pdf, specular, eta_scale_factor, valid)."""
    t = mat.type
    # materials without specular lobes share the ~SPECULAR sampler
    wi_ns, f_ns, pdf_ns, ok_ns = ref_sample_nonspec(mat, wo, u1, u2)
    # mirror: SpecularReflection with FresnelNoOp (mirror.cpp:47)
    wi_mr = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    f_mr = mat.kr / torch.clamp(torch.abs(wi_mr[..., 2]), min=1e-9)[..., None]
    kr_on = (mat.kr > 0).any(-1)
    # smooth glass: FresnelSpecular (reflection.cpp:351)
    Fr = fr_dielectric(wo[..., 2], 1.0, mat.eta)
    refl = u1 < Fr
    entering = wo[..., 2] > 0
    ei = torch.where(entering, 1.0, mat.eta)
    et = torch.where(entering, mat.eta, 1.0)
    eta_rel = ei / et
    nz = torch.where(entering, 1.0, -1.0)
    cos_i = torch.abs(wo[..., 2])
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi_gl_t = torch.stack([-eta_rel * wo[..., 0], -eta_rel * wo[..., 1],
                           -cos_t * nz], -1)
    f_gl_r = mat.kr * (Fr / torch.clamp(cos_i, min=1e-9))[..., None]
    # radiance transport scale (etaI/etaT)^2 (reflection.cpp:376)
    f_gl_t = mat.kt * ((1.0 - Fr) * (ei / et) ** 2
                       / torch.clamp(cos_t, min=1e-9))[..., None]
    wi_gl = torch.where(refl[..., None], wi_mr, wi_gl_t)
    f_gl = torch.where(refl[..., None], f_gl_r, f_gl_t)
    pdf_gl = torch.where(refl, Fr, 1.0 - Fr)

    is_mr = t == ir.MAT_MIRROR
    is_gl = t == ir.MAT_GLASS
    wi = torch.where(is_mr[..., None], wi_mr,
                     torch.where(is_gl[..., None], wi_gl, wi_ns))
    f = torch.where(is_mr[..., None], f_mr,
                    torch.where(is_gl[..., None], f_gl, f_ns))
    pdf = torch.where(is_mr, 1.0, torch.where(is_gl, pdf_gl, pdf_ns))
    valid = torch.where(is_mr, kr_on, torch.where(is_gl, pdf_gl > 0, ok_ns))
    spec_trans = is_gl & ~refl
    # etaScale update (path.cpp:151-156), by the geometric wo.n sign
    eta2 = mat.eta * mat.eta
    eta_fac = torch.where(spec_trans,
                          torch.where(ng_dot_wo > 0, eta2, 1.0 / eta2), 1.0)
    return wi, f, pdf, is_mr | is_gl, eta_fac, valid


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _pbrt_coordinate_system(v1):
    """pbrt's branching CoordinateSystem (geometry.h:232): the sphere's
    cone sample measures phi in this frame, so the branchless one of
    core.geometry would not give the reference's directions."""
    use_x = torch.abs(v1[:, 0]) > torch.abs(v1[:, 1])
    z = torch.zeros_like(v1[:, 0])
    inv = 1.0 / torch.sqrt(torch.clamp(torch.where(
        use_x, v1[:, 0] ** 2 + v1[:, 2] ** 2,
        v1[:, 1] ** 2 + v1[:, 2] ** 2), min=1e-30))
    v2 = torch.where(use_x[:, None],
                     torch.stack([-v1[:, 2], z, v1[:, 0]], -1),
                     torch.stack([z, v1[:, 2], -v1[:, 1]], -1)) * inv[:, None]
    return v2, geom.cross(v1, v2)


def _sphere_sample_li(c, r, nsign, p_ref, u1, u2):
    """Sphere::Sample(ref, u) (sphere.cpp:232+): the cone toward the
    sphere from outside, a uniform area sample inside.  Returns (point
    [B,3], normal [B,3], solid-angle pdf [B])."""
    to_c = c - p_ref
    dc2 = torch.clamp(geom.length_sq(to_c), min=1e-20)
    inside = dc2 <= r * r
    dc = torch.sqrt(dc2)
    # outside: the uniform cone (sphere.cpp:255-291)
    wc = to_c / dc[:, None]
    wcx, wcy = _pbrt_coordinate_system(wc)
    cosmax = torch.sqrt(torch.clamp(1.0 - r * r / dc2, min=0.0))
    cost = (1.0 - u1) + u1 * cosmax
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = u2 * 2.0 * PI
    ds = dc * cost - torch.sqrt(torch.clamp(r * r - dc2 * sint * sint,
                                            min=0.0))
    cosa = (dc2 + r * r - ds * ds) / torch.clamp(2.0 * dc * r, min=1e-20)
    sina = torch.sqrt(torch.clamp(1.0 - cosa * cosa, min=0.0))
    n_cone = ((sina * torch.cos(phi))[:, None] * -wcx
              + (sina * torch.sin(phi))[:, None] * -wcy
              + cosa[:, None] * -wc)
    p_cone = c + r[:, None] * n_cone
    pdf_cone = 1.0 / torch.clamp(2.0 * PI * (1.0 - cosmax), min=1e-20)
    # inside: uniform by area, converted to solid angle (:239-253)
    zz = 1.0 - 2.0 * u1
    rr = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    ph = 2.0 * PI * u2
    n_in = torch.stack([rr * torch.cos(ph), rr * torch.sin(ph), zz], -1)
    p_in = c + r[:, None] * n_in
    wi_in = p_in - p_ref
    d2_in = torch.clamp(geom.length_sq(wi_in), min=1e-20)
    wi_in_n = wi_in / torch.sqrt(d2_in)[:, None]
    pdf_in = d2_in / torch.clamp(torch.abs(geom.dot(n_in, -wi_in_n))
                                 * (4.0 * PI * r * r), min=1e-20)
    n = torch.where(inside[:, None], n_in, n_cone) * nsign[:, None]
    return (torch.where(inside[:, None], p_in, p_cone), n,
            torch.where(inside, pdf_in, pdf_cone))


def _pdf_li(lt: RefLights, k, p_ref, wi):
    """Light Pdf_Li for the BSDF-sampled estimator (integrator.cpp:174):
    Triangle::Pdf(ref, wi) (shape.cpp:136), the ray against the chosen
    triangle alone, dist^2 / (|cos| area); Sphere::Pdf (sphere.cpp:299),
    the cone's pdf from outside, the area pdf of the ray's hit converted
    to solid angle from inside.  Returns (pdf, hit)."""
    t, _, _, hit = isect.ray_triangle(
        p_ref, wi, lt.p0[k][:, None], lt.e1[k][:, None], lt.e2[k][:, None],
        torch.full(p_ref.shape[:1], 1e30, device=p_ref.device))
    t, hit = t[:, 0], hit[:, 0]
    cos_l = torch.abs(geom.dot(lt.n[k], -wi))
    pdf_tri = torch.where(hit & (cos_l > 1e-12), t * t / torch.clamp(
        cos_l * lt.area[k], min=1e-12), 0.0)
    if not lt.has_spheres:
        return pdf_tri, hit
    c, r = lt.center[k], lt.radius[k]
    dc2 = torch.clamp(geom.length_sq(c - p_ref), min=1e-20)
    inside = dc2 <= r * r
    cosmax = torch.sqrt(torch.clamp(1.0 - r * r / dc2, min=0.0))
    pdf_cone = 1.0 / torch.clamp(2.0 * PI * (1.0 - cosmax), min=1e-20)
    # inside: Shape::Pdf(ref, wi), the ray's hit converted from area
    oc = p_ref - c
    bq = 2.0 * geom.dot(oc, wi)
    disc = bq * bq - 4.0 * (geom.length_sq(oc) - r * r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = 0.5 * (-bq - sq), 0.5 * (-bq + sq)
    ts = torch.where(t0 > 1e-5, t0, t1)
    s_hit = (disc >= 0) & (ts > 1e-5)
    cos_s = torch.abs(geom.dot(oc + ts[:, None] * wi, -wi)) / torch.clamp(
        r, min=1e-20)
    pdf_in = torch.where(s_hit, ts * ts / torch.clamp(
        cos_s * (4.0 * PI * r * r), min=1e-20), 0.0)
    is_sph = lt.sphere[k]
    return (torch.where(is_sph, torch.where(inside, pdf_in, pdf_cone),
                        pdf_tri), torch.where(is_sph, s_hit, hit))


def _shading_frame(scene: ir.SceneData, hit: isect.Hit):
    """pbrt's shading geometry at the hit (triangle.cpp:297-380,
    SurfaceInteraction::SetShadingGeometry, the BSDF frame of
    reflection.h:158).

    Returns (ss, ts, ns, ng, p_err): the BSDF tangent frame, the shading
    normal, the geometric normal turned toward the shading normal where
    the mesh has vertex normals (pbrt's orientationIsAuthoritative
    branch), and the hit's error box (gamma(7) for triangles,
    triangle.cpp:320-326; gamma(5) |p| for spheres)."""
    pid = hit.prim
    e1, e2, v0 = scene.tri_e1[pid], scene.tri_e2[pid], scene.tri_v0[pid]
    n0, n1, n2 = scene.tri_ns[pid].unbind(1)
    uv0, uv1, uv2 = scene.tri_uv[pid].unbind(1)
    flip = scene.prim_flip_normal[pid]
    # barycentrics of the hit (hit.uv is the texture uv): from the point,
    # hit.p = v0 + b1 e1 + b2 e2
    ngu = geom.cross(e1, e2)
    nn2 = torch.clamp(geom.length_sq(ngu), min=1e-30)
    d0 = hit.p - v0
    b1 = geom.dot(geom.cross(d0, e2), ngu) / nn2
    b2 = geom.dot(geom.cross(e1, d0), ngu) / nn2
    b0 = 1.0 - b1 - b2
    ng = ngu / torch.sqrt(nn2)[:, None]
    # shading normal: interpolated vertex normals where present
    ns_i = b0[:, None] * n0 + b1[:, None] * n1 + b2[:, None] * n2
    has_ns = geom.length_sq(ns_i) > 0
    ns = torch.where(has_ns[:, None], geom.normalize(
        torch.where(has_ns[:, None], ns_i, ng)), ng)
    # dpdu from the uv parameterization (dp02 = p0-p2, dp12 = p1-p2)
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = -e2
    dp12 = e1 - e2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degen = torch.abs(det) < 1e-8
    inv = 1.0 / torch.where(degen, 1.0, det)
    dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv[:, None]
    fb1, _ = geom.coordinate_system(ns)
    ss0 = torch.where(degen[:, None], fb1, geom.normalize(dpdu))
    # with vertex normals, SetShadingGeometry: ts = Normalize(ss x ns),
    # ss = ts x ns (triangle.cpp:373-378); without, ss = Normalize(dpdu)
    ts0 = geom.cross(ss0, ns)
    ts_ok = geom.length_sq(ts0) > 0
    ts_n = geom.normalize(torch.where(ts_ok[:, None], ts0, fb1))
    ss_sg = torch.where(ts_ok[:, None], geom.cross(ts_n, ns), fb1)
    ss = torch.where(has_ns[:, None], ss_sg, ss0)
    ns = torch.where((flip & has_ns)[:, None], -ns, ns)
    # orientationIsAuthoritative: n = Faceforward(n, shading.n) only with
    # shading normals; otherwise the prim's flip already turned it
    ng = torch.where((flip & ~has_ns)[:, None], -ng, ng)
    ng = torch.where((has_ns & (geom.dot(ng, ns) < 0))[:, None], -ng, ng)
    # sphere lanes: the hit record's normals and the Duff frame
    is_tri = (scene.prim_type[pid] == ir.PRIM_TRIANGLE)[:, None]
    qb1, _ = geom.coordinate_system(hit.ns)
    ss = torch.where(is_tri, ss, qb1)
    ns = torch.where(is_tri, ns, hit.ns)
    ng = torch.where(is_tri, ng, hit.ng)
    ts = geom.cross(ns, ss)                    # the BSDF frame's ts = ns x ss
    b0c = torch.clamp(b0, 0.0, 1.0)[:, None]
    b1c = torch.clamp(b1, 0.0, 1.0)[:, None]
    b2c = torch.clamp(b2, 0.0, 1.0)[:, None]
    p_err = _GAMMA7 * (torch.abs(b0c * v0) + torch.abs(b1c * (v0 + e1))
                       + torch.abs(b2c * (v0 + e2)))
    p_err = torch.where(is_tri, p_err, (5 * _GAMMA7 / 7) * torch.abs(hit.p))
    return ss, ts, ns, ng, p_err


def sampling_power(pf, pg):
    """PowerHeuristic(1, pf, 1, pg) (sampling.h:171)."""
    f2 = pf * pf
    return torch.where(pf > 0, f2 / torch.clamp(f2 + pg * pg, min=1e-30),
                       0.0)


def _concat_rays(*rays):
    return geom.Ray(*(torch.cat([getattr(r, f) for r in rays])
                      for f in ("o", "d", "tmax", "wavelength", "time")))


def trace_ref(scene: ir.SceneData, lt: RefLights, sampler: RefSampler,
              ray: geom.Ray, pixel_id, sample_idx, max_depth=5,
              offset="scaled"):
    """pbrt-v3 PathIntegrator::Li on a batch of camera rays, the
    matched-RNG stream; returns L [B,31].

    pixel_id, sample_idx: int64 tensors [B]; offset: "scaled" or "pbrt"
    (module docstring)."""
    if offset not in OFFSET_MODES:
        raise ValueError(f"offset {offset!r} is not one of {OFFSET_MODES}")
    other = set(scene.mat_families) - set(SUPPORTED_MATS) - {ir.MAT_MIX}
    if other:
        raise NotImplementedError(
            f"refpath: material families {sorted(other)} (only matte, "
            "plastic, mirror and glass, and mixes of them)")
    pbrt_off = offset == "pbrt"
    B = ray.o.shape[0]
    dev = ray.o.device
    K = lt.count
    idx = sampler.index(pixel_id, sample_idx)
    dim = torch.full((B,), 5, dtype=torch.int64, device=dev)  # camera: 0-4
    L = torch.zeros((B, spec.N_SPECTRAL_SAMPLES), device=dev)
    beta = torch.ones_like(L)
    alive = ray.tmax > 0
    specular = torch.ones(B, dtype=torch.bool, device=dev)
    eta_scale = torch.ones(B, device=dev)
    wl, tm = ray.wavelength, ray.time

    def spawn(p, p_err, ngg, w):
        if pbrt_off:
            return geom.Ray.make(offset_ray_origin(p, p_err, ngg, w), w,
                                 wavelength=wl, time=tm)
        return isect.spawn_ray(p, ngg, w, wl, time=tm,
                               eps_scale=REF_EPS_SCALE)

    t0, prim0, found0 = isect.intersect(scene, ray, presorted=True)
    hit = isect.make_hit(scene, ray, t0, prim0, found0, exact_p=pbrt_off)
    for bounce in range(max_depth + 1):
        # ---- Le at specular and camera vertices (path.cpp:91-100) ----
        le = lightsmod.area_le(scene, hit.light, hit.ng, hit.wo)
        L = L + torch.where((alive & hit.valid & specular)[:, None],
                            beta * le, 0.0)
        if scene.has_infinite:
            env = lightsmod.env_le(scene, geom.normalize(ray.d))
            L = L + torch.where((alive & ~hit.valid & specular)[:, None],
                                beta * env, 0.0)
        alive = alive & hit.valid
        if bounce == max_depth:
            break

        mat = bsdf.gather_materials(scene, hit.material, uv=hit.uv,
                                    p=hit.p)
        ss, ts, nss, ngg, p_err = _shading_frame(scene, hit)
        wo_l = geom.world_to_frame(ss, ts, nss, hit.wo)
        do_nee = alive & (_nonspec_counts(mat) > 0)

        # ---- EstimateDirect (integrator.cpp:108) ----
        u_sel = sampler.dim(idx, dim)
        ul1 = sampler.dim(idx, dim + 1)
        ul2 = sampler.dim(idx, dim + 2)
        us1 = sampler.dim(idx, dim + 3)
        us2 = sampler.dim(idx, dim + 4)
        # uniform choice over the flattened per-shape light list
        k = torch.clamp((u_sel * K).to(torch.int64), max=K - 1)
        lp0, le1, le2, ln = lt.p0[k], lt.e1[k], lt.e2[k], lt.n[k]
        lL, ltwo = lt.L[k], lt.two_sided[k]
        # Triangle::Sample (triangle.cpp:470): UniformSampleTriangle
        su = torch.sqrt(torch.clamp(ul1, min=0.0))
        b0 = 1.0 - su
        b1 = ul2 * su
        p_l = lp0 + b1[:, None] * le1 + (1.0 - b0 - b1)[:, None] * le2
        n_l = ln
        if lt.has_spheres:
            # Sphere::Sample(ref, u) (sphere.cpp:232+)
            is_sph, lc, lsg = lt.sphere[k], lt.center[k], lt.nsign[k]
            p_sph, n_sph, pdf_sph = _sphere_sample_li(lc, lt.radius[k], lsg,
                                                      hit.p, ul1, ul2)
            p_l = torch.where(is_sph[:, None], p_sph, p_l)
            n_l = torch.where(is_sph[:, None], n_sph, ln)
        to_l = p_l - hit.p
        dist2 = torch.clamp(geom.length_sq(to_l), min=1e-20)
        dist = torch.sqrt(dist2)
        wi_L = to_l / dist[:, None]
        cos_l = geom.dot(n_l, -wi_L)
        li = torch.where((ltwo | (cos_l > 0))[:, None], lL, 0.0)
        # Shape::Sample(ref)'s solid-angle pdf (shape.cpp:58); a sphere
        # carries its own
        pdf_light = dist2 / torch.clamp(torch.abs(cos_l) * lt.area[k],
                                        min=1e-12)
        if lt.has_spheres:
            pdf_light = torch.where(is_sph, pdf_sph, pdf_light)
        wi_Ll = geom.world_to_frame(ss, ts, nss, wi_L)
        reflect_geo = (geom.dot(wi_L, ngg) * geom.dot(hit.wo, ngg)) > 0
        f_l = ref_f(mat, wo_l, wi_Ll, reflect_geo) \
            * geom.absdot(wi_L, nss)[:, None]
        pdf_scat_l = ref_pdf(mat, wo_l, wi_Ll)
        cand_l = do_nee & (pdf_light > 0) & ~spec.is_black(li) \
            & ~spec.is_black(f_l)
        if pbrt_off:
            # SpawnRayTo(p_light) from the offset origin; the direction is
            # normalized and tmax = dist (1 - ShadowEpsilon), the same
            # segment as pbrt's parametric ray
            o_s = offset_ray_origin(hit.p, p_err, ngg, to_l)
            seg = p_l - o_s
            seg_len = torch.clamp(geom.length(seg), min=1e-20)
            sray = geom.Ray.make(
                o_s, seg / seg_len[:, None],
                tmax=torch.where(cand_l, seg_len * (1.0 - 1e-4), -1.0),
                wavelength=wl, time=tm)
        else:
            sray = isect.spawn_shadow_ray(hit.p, ngg, wi_L, dist, cand_l, wl,
                                          time=tm, eps_scale=REF_EPS_SCALE,
                                          shave=1.0 - 1e-4)
        w_l = sampling_power(pdf_light, pdf_scat_l)
        contrib_l = beta * f_l * li * (
            w_l / torch.clamp(pdf_light, min=1e-20))[:, None] * float(K)

        # scattering estimator: sample the BSDF (~SPECULAR), probe the light
        wi_S_l, f_s, pdf_scat, ok_s = ref_sample_nonspec(mat, wo_l, us1, us2)
        wi_S = geom.frame_to_world(ss, ts, nss, wi_S_l)
        f_s = f_s * geom.absdot(wi_S, nss)[:, None]
        pdf_light_s, _ = _pdf_li(lt, k, hit.p, wi_S)
        cand_s = do_nee & ok_s & ~spec.is_black(f_s) & (pdf_light_s > 0)
        w_s = sampling_power(pdf_scat, pdf_light_s)
        pray = spawn(hit.p, p_err, ngg, wi_S)
        pray = pray.replace(tmax=torch.where(cand_s, pray.tmax, -1.0))
        contrib_s = beta * f_s * lL * (
            w_s / torch.clamp(pdf_scat, min=1e-20))[:, None] * float(K)

        # ---- the path's continuation, Sample_f (path.cpp:131) ----
        dim_b = dim + torch.where(do_nee, 5, 0)
        ub1 = sampler.dim(idx, dim_b)
        ub2 = sampler.dim(idx, dim_b + 1)
        ng_dot_wo = geom.dot(hit.wo, ngg)
        wi_c_l, f_c, pdf_c, is_spec, eta_fac, ok_c = ref_sample_all(
            mat, wo_l, ub1, ub2, ng_dot_wo)
        wi_c = geom.frame_to_world(ss, ts, nss, wi_c_l)
        alive = alive & ok_c & ~spec.is_black(f_c)
        beta_new = beta * f_c * (geom.absdot(wi_c, nss)
                                 / torch.clamp(pdf_c, min=1e-20))[:, None]
        beta = torch.where(alive[:, None], beta_new, beta)
        eta_scale = eta_scale * torch.where(alive, eta_fac, 1.0)
        specular = is_spec
        nray = spawn(hit.p, p_err, ngg, wi_c)
        nray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))
        dim = dim + torch.where(do_nee, 7, 2)

        # ---- Russian roulette (path.cpp:185-191) ----
        if bounce > 3:
            rr_beta_max = beta.amax(-1) * eta_scale
            consider = alive & (rr_beta_max < pathmod.RR_THRESHOLD)
            u_rr = sampler.dim(idx, dim)
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            alive = alive & ~(consider & (u_rr < q))
            beta = torch.where((consider & alive)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-9)[:, None],
                               beta)
            dim = dim + consider.to(dim.dtype)
            nray = nray.replace(tmax=torch.where(alive, nray.tmax, -1.0))

        # ---- continuation, probe and shadow rays as one batch ----
        amask = torch.zeros(3 * B, dtype=torch.bool, device=dev)
        amask[2 * B:] = True
        t3, prim3, found3 = isect.intersect(
            scene, _concat_rays(nray, pray, sray), anyhit_mask=amask)
        hit = isect.make_hit(scene, nray, t3[:B], prim3[:B], found3[:B],
                             exact_p=pbrt_off)
        # the light estimator lands where the shadow ray is unoccluded
        L = L + torch.where((cand_l & ~found3[2 * B:])[:, None], contrib_l,
                            0.0)
        # the scattering estimator lands where the probe's closest hit is
        # the chosen light's shape (integrator.cpp:205-210) and its Le
        # faces the probe (diffuse.h:66); a sphere's normal is taken at
        # the probe's hit point
        facing = geom.dot(ln, -wi_S) > 0
        if lt.has_spheres:
            p_probe = pray.o + t3[B:2 * B][:, None] * wi_S
            n_probe = geom.normalize(p_probe - lc) * lsg[:, None]
            facing = torch.where(is_sph, geom.dot(n_probe, -wi_S) > 0,
                                 facing)
        orient_s = ltwo | facing
        probe_ok = cand_s & found3[B:2 * B] & (prim3[B:2 * B] == lt.prim[k]) \
            & orient_s
        L = L + torch.where(probe_ok[:, None], contrib_s, 0.0)

    return torch.clamp(torch.where(torch.isfinite(L), L, 0.0), min=0.0)


def camera_rays_ref(camera, W, H, sampler: RefSampler, pixel_id,
                    sample_idx):
    """Camera rays with pbrt's dimension layout: the film jitter from the
    remapped dims 0/1, time dim 2, lens dims 3/4 (sampler.cpp
    GetCameraSample).  pixel_id: int64 tensor, ids >= W*H are padding.

    Returns (ray, weight, pfilm, pid, sidx)."""
    sidx = torch.full_like(pixel_id, int(sample_idx))
    valid = pixel_id < W * H
    pid = torch.where(valid, pixel_id, 0)
    idx = sampler.index(pid, sidx)
    jx, jy = sampler.film_xy(idx, pid)
    pfilm = torch.stack([(pid % W).to(torch.float32) + jx,
                         (pid // W).to(torch.float32) + jy], -1)
    utime = sampler.dim(idx, 2)
    ulens = torch.stack([sampler.dim(idx, 3), sampler.dim(idx, 4)], -1)
    ray, weight = projective.generate_rays(camera, pfilm, ulens, utime,
                                           width=W, height=H)
    weight = torch.where(valid, weight, 0.0)
    ray = ray.replace(tmax=torch.where(valid, ray.tmax, -1.0))
    return ray, weight, pfilm, pid, sidx


def render_ref(scene, camera, film, W, H, spp, max_depth=5,
               max_rays_per_pass=1 << 17, offset="scaled"):
    """Matched-RNG render: every (sample, pixel chunk) pass splats into
    `film` in place, on the film's device.  Returns the film."""
    sampler = RefSampler.make(W, H)
    lt = build_ref_lights(scene)
    dev = film.weighted.device
    n_pix = W * H
    chunk = min(n_pix, max_rays_per_pass)
    n_chunks = -(-n_pix // chunk)
    ids = np.full(n_chunks * chunk, 0xFFFFFFFF, np.int64)
    ids[:n_pix] = np.arange(n_pix)
    id_chunks = [torch.as_tensor(ids[i * chunk:(i + 1) * chunk], device=dev)
                 for i in range(n_chunks)]
    for s in range(spp):
        for pixel_ids in id_chunks:
            ray, weight, pfilm, pid, sidx = camera_rays_ref(
                camera, W, H, sampler, pixel_ids, s)
            L = trace_ref(scene, lt, sampler, ray, pid, sidx,
                          max_depth=max_depth, offset=offset)
            filmmod.add_samples(film, pfilm, L, weight)
    return film
