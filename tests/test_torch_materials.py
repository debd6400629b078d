"""The port's surface BSDFs (every ported family, GGX and Beckmann, uber
opacity, mix resolution), conductor Fresnel, metal data, textured
material gathers and bump maps against pbrt_tpu on the same inputs (CPU).

pbrt_tpu's side is jitted once per case, with the case's family as the
static `families` tuple, as its scenes compile only their families.

Tolerances:
- Closed forms in f32 agree to 1e-4 relative, with an absolute floor of
  2e-6 of the batch's largest value: both packages' libm (sqrt, pow, exp,
  log, erf) differ by ulps, and near total internal reflection the
  rough-transmission lobes scale by (1 - F), which cancels (lanes with
  1 - F ~ 1e-3 move by ~1e-2 relative, ~5e-7 of the batch's largest f).
- Beckmann sampling (beckmann_sample_wh) is ill-conditioned on some
  lanes, and there the two packages' f32 results differ by an amount
  that depends on the CPU that runs them: the rotation by
  wo's azimuth divides by sqrt(1 - cos^2), which cancels at near-normal
  incidence (an ulp of cos is a relative error of ~eps / (1 - cos^2) in
  the sine), and the slopes come from erfinv, whose derivative
  exp(x^2) sqrt(pi) / 2 grows in the tails, after a Newton inversion
  that stops within a rounding of its f32 fixed point.  On one AMD EPYC
  CPU one lane of 4,096 (cos 0.99997) had the packages 9.6e-4 apart in
  the direction and 2.6e-3 relative in f, where another CPU had measured
  under 5e-4 and 1e-3.  So each package's Beckmann-lobe direction is
  held to an f64 evaluation of the same formula (_beckmann_wh64), lane
  by lane, within BECK_ULPS = 8 f32 roundings of each ill-conditioned
  intermediate carried by its f64 derivative
  (test_torch_core.rounding_bound; measured: within 0.33 of the bound,
  whose median is 2.7e-6), and the f and pdf of a sample are held to the
  other package's eval_f and pdf_f at the same direction, at the closed
  forms' 1e-4 (measured 3.9e-6).  Diffuse-lobe lanes keep 1e-4.
- Disney's clearcoat at clearcoatgloss 1 is GTR1 with alpha 0.001, whose
  1 + (alpha^2 - 1) cos^2 cancels to ~alpha^2 + theta^2 from terms near
  1: an ulp of the half vector's z moves D by ~2.4e-7 / theta^2
  relative.  Sampled lanes whose half vector lies within 2e-2 rad of the
  normal (counted, < 15%; the lobe samples there) are held to 0.25
  relative (measured up to 0.12), the other sampled Disney lanes to 2e-4.
- Discrete choices (lobe, reflect or refract) compare a uniform with a
  computed threshold and may flip only where the uniform lands within
  rounding of it: the lanes that agree are >= 99.9%.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.special import erf as _erf, erfinv as _erfinv

from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.materials import metal_data as jmetal
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.scene import ir as jir
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.materials import metal_data as tmetal
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.scene import ir as tir
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_core import rounding_bound

N = 4096
DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS_SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                          "cornell_materials.pbrt")

# one material of each ported family (type, MaterialSpec fields)
FAMILIES = {
    "none": (-1, {}),
    "matte": (0, dict(kd=0.5, sigma=20.0)),
    "plastic": (1, dict(kd=0.3, ks=0.4, rough_u=0.1, rough_v=0.1)),
    "mirror": (2, dict(kr=0.9)),
    "glass": (3, dict(kr=1.0, kt=1.0, eta=1.5)),
    "metal": (4, dict(ks=1.0, rough_u=0.05, rough_v=0.08, metal=True)),
    "uber": (5, dict(kd=0.3, ks=0.3, kr=0.1, kt=0.1, rough_u=0.1,
                     rough_v=0.1, opacity=0.5)),
    "substrate": (6, dict(kd=0.3, ks=0.4, rough_u=0.1, rough_v=0.2)),
    "translucent": (7, dict(kd=0.5, ks=0.25, kr=0.5, kt=0.4, rough_u=0.1,
                            rough_v=0.1)),
    "retroreflective": (8, dict(kd=0.3, ks=0.6, rough_u=0.2, rough_v=0.2)),
    "disney": (9, dict(kd=0.6, kt=0.7, rough_u=0.09, rough_v=0.09,
                       eta=1.5, remap=False,
                       disney=(0.3, 0.2, 0.5, 0.5, 0.8, 1.0, 0.4, 0.0))),
    "roughglass": (13, dict(kr=1.0, kt=1.0, eta=1.5, rough_u=0.15,
                            rough_v=0.15)),
}
MICROFACET = ("plastic", "metal", "uber", "roughglass")
CASES = [(f, "ggx") for f in FAMILIES] + [(f, "beckmann") for f in MICROFACET]


def _spectrum(v):
    return np.full(31, v, np.float32)


def _build(irmod, metal):
    """Both packages' SceneBuilder with one material of every family and
    a mix of plastic and matte; one triangle."""
    b = irmod.SceneBuilder()
    for name, (t, kw) in FAMILIES.items():
        kw = dict(kw)
        m = irmod.MaterialSpec(type=t, name=name)
        for k in ("kd", "ks", "kr", "kt", "opacity"):
            if k in kw:
                setattr(m, k, _spectrum(kw.pop(k)))
        if kw.pop("metal", False):
            m.eta_spec, m.k_spec = metal.conductor_eta_k("Cu")
        m.remap_roughness = kw.pop("remap", True)
        for k, v in kw.items():
            setattr(m, k, v)
        b.add_material(m)
    for dist in ("ggx", "beckmann"):
        b.add_material(irmod.MaterialSpec(
            type=1, kd=_spectrum(0.3), ks=_spectrum(0.4), rough_u=0.1,
            rough_v=0.1, distribution=dist, name=f"plastic_{dist}"))
    b.add_material(irmod.MaterialSpec(type=12, mix_a=2, mix_b=1,
                                      mix_amt=0.3, name="mix"))
    b.add_triangle_mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                 np.float32), np.array([[0, 1, 2]]), 0)
    return b.build(device=DEV) if irmod is tir else b.build()


@pytest.fixture(scope="module")
def scenes():
    return _build(jir, jmetal), _build(tir, tmetal)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def dirs():
    rs = np.random.RandomState(81)
    return _unit(rs, N), _unit(rs, N), rs.rand(3, N).astype(np.float32)


def _params(scenes, family, dist):
    """Both packages' records for N lanes of `family`, its family the only
    one compiled, Beckmann on every lane or GGX."""
    js, ts = scenes
    mid = list(FAMILIES).index(family)
    t = FAMILIES[family][0]
    idx = np.full(N, mid, np.int32)
    jm = jbsdf.gather_materials(js, jnp.asarray(idx))
    tm = tbsdf.gather_materials(ts, torch.from_numpy(idx))
    beck = dist == "beckmann"
    jm = jm.replace(families=(t,), beckmann=jnp.ones(N, bool) if beck
                    else None, disney=jm.disney if t == 9 else None)
    tm = dataclasses.replace(
        tm, families=(t,), beckmann=torch.ones(N, dtype=torch.bool)
        if beck else None, disney=tm.disney if t == 9 else None)
    return jm, tm


def _close(a, b, rtol=1e-4, scale=2e-6, mask=None):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    atol = scale * max(float(np.abs(b).max()), 1e-30)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


SQRT_PI_INV = 1.0 / np.sqrt(np.pi)
# the intermediates of Beckmann's sampled microfacet normal whose f32
# rounding moves it (beckmann_sample_wh, beckmann_sample_11)
BECK_SITES = ("ws_x", "ws_y", "ws_z", "st", "norm", "target", "b", "sx",
              "y_arg", "sy", "s2", "cos_phi", "sin_phi", "wh_x", "wh_y")
# f32 roundings a site may be off by in either package (libm's erf,
# erfinv, exp, pow and sqrt are within a few ulps; the Newton solve stops
# within a rounding of its f32 fixed point)
BECK_ULPS = 8


def _beckmann_wh64(wo, u1, u2, ax, ay, pert):
    """pbrt_tpu's beckmann_sample_wh in float64, each named intermediate
    scaled by 1 + pert[name] (test_torch_core.rounding_bound)."""
    def r(x, name):
        return x * (1.0 + pert.get(name, 0.0))

    flip = wo[:, 2] < 0
    w = np.where(flip[:, None], -wo, wo)
    ws = np.stack([ax * w[:, 0], ay * w[:, 1], w[:, 2]], -1)
    ws = ws / np.linalg.norm(ws, axis=-1, keepdims=True)
    wsx, wsy, ct0 = r(ws[:, 0], "ws_x"), r(ws[:, 1], "ws_y"), \
        r(ws[:, 2], "ws_z")
    ct = np.maximum(ct0, -0.9999)
    st = r(np.sqrt(np.maximum(1e-14, 1.0 - ct * ct)), "st")
    tant = st / np.maximum(ct, 1e-7)
    cot = 1.0 / np.maximum(tant, 1e-12)
    a0 = _erf(cot)
    sx = r(np.maximum(u1, 1e-6), "target")
    theta = np.arccos(np.clip(ct, -1.0, 1.0))
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    b = a0 - (1.0 + a0) * np.power(1.0 - sx, fit)
    norm = r(1.0 / np.maximum(
        1.0 + a0 + SQRT_PI_INV * tant * np.exp(-cot * cot), 1e-12), "norm")
    b = np.clip(b, -1 + 1e-6, 1 - 1e-6)
    for _ in range(10):
        ie = _erfinv(np.clip(b, -0.99999, 0.99999))
        value = norm * (1.0 + b + SQRT_PI_INV * tant * np.exp(-ie * ie)) - sx
        der = norm * (1.0 - ie * tant)
        b = np.clip(b - value / np.where(np.abs(der) > 1e-9, der, 1e-9),
                    -1.0 + 1e-6, 1.0 - 1e-6)
    slope_x = r(_erfinv(np.clip(r(b, "b"), -0.99999, 0.99999)), "sx")
    slope_y = r(_erfinv(np.clip(r(2.0 * np.maximum(u2, 1e-6) - 1.0,
                                  "y_arg"), -0.99999, 0.99999)), "sy")
    rr = np.sqrt(np.maximum(-np.log(np.maximum(1.0 - u1, 1e-12)), 1e-14))
    phi = 2.0 * np.pi * u2
    near = ct0 > 0.9999
    slope_x = np.where(near, rr * np.cos(phi), slope_x)
    slope_y = np.where(near, rr * np.sin(phi), slope_y)
    s2 = r(np.maximum(1.0 - ct0 ** 2, 1e-20), "s2")
    inv_s = 1.0 / np.sqrt(s2)
    cos_phi = r(np.where(s2 > 1e-20, wsx * inv_s, 1.0), "cos_phi")
    sin_phi = r(np.where(s2 > 1e-20, wsy * inv_s, 0.0), "sin_phi")
    hx = r(ax * (cos_phi * slope_x - sin_phi * slope_y), "wh_x")
    hy = r(ay * (sin_phi * slope_x + cos_phi * slope_y), "wh_y")
    wh = np.stack([-hx, -hy, np.ones_like(hx)], -1)
    wh = wh / np.linalg.norm(wh, axis=-1, keepdims=True)
    return np.where(flip[:, None], -wh, wh)


def _beckmann_dirs64(wo, u, ax, ay, eta):
    """The Beckmann lobes' sampled directions in float64 with their
    per-element rounding bounds: {"reflect": (wi, bound), "refract": ...}
    (sample_f reflects wo about the sampled normal, or refracts it
    through the normal turned toward wo)."""
    wo = wo.astype(np.float64)
    u1, u2 = (x.astype(np.float64) for x in u[1:])
    ax, ay, eta = (np.asarray(x, np.float64) for x in (ax, ay, eta))
    eta_r = np.where(wo[:, 2] > 0, 1.0 / eta, eta)

    def reflect(pert):
        wh = _beckmann_wh64(wo, u1, u2, ax, ay, pert)
        return -wo + 2.0 * np.sum(wo * wh, -1, keepdims=True) * wh

    def refract(pert):
        wh = _beckmann_wh64(wo, u1, u2, ax, ay, pert)
        cos_i = np.sum(wo * wh, -1, keepdims=True)
        wh = np.where(cos_i >= 0, wh, -wh)
        cos_i = np.abs(cos_i)
        sin2_t = eta_r[:, None] ** 2 * np.maximum(1.0 - cos_i ** 2, 0.0)
        cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 1e-14))
        return eta_r[:, None] * -wo + (eta_r[:, None] * cos_i - cos_t) * wh

    return {k: rounding_bound(f, BECK_SITES, BECK_ULPS)
            for k, f in (("reflect", reflect), ("refract", refract))}


@jax.jit
def _jax_eval(jm, wo, wi):
    return jbsdf.eval_f(jm, wo, wi), jbsdf.pdf_f(jm, wo, wi)


@jax.jit
def _jax_all(jm, wo, wi, u):
    return (jbsdf.eval_f(jm, wo, wi), jbsdf.pdf_f(jm, wo, wi),
            jbsdf.sample_f(jm, wo, u[0], u[1], u[2]))


@pytest.mark.parametrize("family,dist", CASES,
                         ids=[f"{f}-{d}" for f, d in CASES])
def test_family_matches_jax(scenes, dirs, family, dist):
    wo, wi, u = dirs
    jm, tm = _params(scenes, family, dist)
    jf, jp, js = _jax_all(jm, jnp.asarray(wo), jnp.asarray(wi),
                          jnp.asarray(u))
    two, twi = torch.from_numpy(wo), torch.from_numpy(wi)
    tf, tp = tbsdf.eval_f(tm, two, twi), tbsdf.pdf_f(tm, two, twi)
    _close(tf, jf)
    _close(tp, jp)
    twi_s, tf_s, tp_s, tspec, ttrans, teta = (
        x.numpy() for x in tbsdf.sample_f(tm, two, *(torch.from_numpy(x)
                                                   for x in u)))
    jwi_s, jf_s, jp_s, jspec, jtrans, jeta = (np.asarray(x) for x in js)
    beck = dist == "beckmann"
    same = (ttrans == jtrans) & (np.abs(twi_s - jwi_s).max(-1) < 5e-3)
    assert same.mean() >= 0.999
    assert np.array_equal(tspec, jspec)
    if beck:
        # each package's Beckmann-lobe directions against the f64
        # evaluation, lane by lane within its rounding bound; the other
        # lanes (a diffuse lobe) against each other
        cands = _beckmann_dirs64(wo, u, torch.clamp(tm.rough_u, min=1e-4),
                                 torch.clamp(tm.rough_v, min=1e-4), tm.eta)
        lobe = np.ones(N, bool)
        for got in (twi_s, jwi_s):
            within = np.min([np.max(np.abs(got - v) / bnd, -1)
                             for v, bnd in cands.values()], 0) <= 1.0
            lobe &= within
        if family in ("metal", "roughglass"):      # the lobe on every lane
            assert lobe[same].all(), np.nonzero(same & ~lobe)[0]
        assert lobe.mean() > 0.2
        # the bound is a few ulps where the formula is well conditioned
        assert np.median(np.max(cands["reflect"][1], -1)) < 1e-5
        same_rest = same & ~lobe
    else:
        same_rest = same
    np.testing.assert_allclose(twi_s[same_rest], jwi_s[same_rest], rtol=0,
                               atol=1e-4)
    if beck:
        # f and pdf of a non-specular sample: the other package's eval_f
        # and pdf_f at the same direction (a sampled direction's rounding,
        # held above, moves them as it moves any evaluation there); the
        # specular ones (uber's pass-through) against each other
        jx, jpx = _jax_eval(jm, jnp.asarray(wo), jnp.asarray(twi_s))
        two_j = torch.tensor(jwi_s)
        for got, want in ((tf_s, jx), (tp_s, jpx),
                          (jf_s, tbsdf.eval_f(tm, two, two_j)),
                          (jp_s, tbsdf.pdf_f(tm, two, two_j))):
            _close(got, want, mask=same & ~tspec)
        _close(tf_s, jf_s, mask=same & tspec)
        _close(tp_s, jp_s, mask=same & tspec)
    elif family == "disney":
        # half vectors within 2e-2 rad of the normal: the clearcoat's
        # cancellation (module docstring)
        wh = wo.astype(np.float64) + jwi_s
        wh /= np.linalg.norm(wh, axis=-1, keepdims=True)
        peak = np.abs(wh[:, 2]) > np.cos(2e-2)
        assert peak.mean() < 0.15
        _close(tf_s, jf_s, rtol=0.25, mask=same & peak)
        _close(tp_s, jp_s, rtol=0.25, mask=same & peak)
        _close(tf_s, jf_s, rtol=2e-4, mask=same & ~peak)
        _close(tp_s, jp_s, rtol=2e-4, mask=same & ~peak)
    else:
        _close(tf_s, jf_s, mask=same)
        _close(tp_s, jp_s, mask=same)
    _close(teta, jeta, rtol=1e-6, scale=0, mask=same)
    # the family really scatters somewhere
    assert (tp_s > 0).any() and (np.abs(tf_s).sum(-1) > 0).any()
    if family == "uber":
        # opacity 0.5: about half the lanes pass straight through
        passed = (ttrans & tspec).mean()
        assert 0.4 < passed < 0.6


def test_mix_resolution_matches_jax(scenes):
    """MAT_MIX lanes pick `a` where u_mix < amount, by a supplied uniform
    and by the position hash; other lanes keep their material."""
    js, ts = scenes
    rs = np.random.RandomState(82)
    M = int(ts.mat_type.shape[0])
    idx = rs.randint(-1, M, N).astype(np.int32)
    idx[::3] = M - 1                                 # the mix
    u_mix = rs.rand(N).astype(np.float32)
    p = (rs.rand(N, 3) * 5).astype(np.float32)
    for kw_j, kw_t in (
            (dict(u_mix=jnp.asarray(u_mix)), dict(u_mix=torch.from_numpy(
                u_mix))),
            (dict(p=jnp.asarray(p)), dict(p=torch.from_numpy(p))),
            ({}, {})):
        jr = np.asarray(jbsdf.resolve_mix(js, jnp.asarray(idx), **kw_j))
        tr = tbsdf.resolve_mix(ts, torch.from_numpy(idx), **kw_t).numpy()
        assert np.array_equal(tr, jr)
    mix = idx == M - 1
    got = tbsdf.resolve_mix(ts, torch.from_numpy(idx),
                            u_mix=torch.from_numpy(u_mix)).numpy()
    assert np.array_equal(got[mix], np.where(u_mix[mix] < 0.3, 2, 1))
    assert np.array_equal(got[~mix], idx[~mix])
    jm = jbsdf.gather_materials(js, jnp.asarray(idx),
                                u_mix=jnp.asarray(u_mix))
    tm = tbsdf.gather_materials(ts, torch.from_numpy(idx),
                                u_mix=torch.from_numpy(u_mix))
    assert np.array_equal(tm.type.numpy(), np.asarray(jm.type))
    for k in ("kd", "ks", "kr", "kt", "eta", "sigma", "eta_spec", "k_spec",
              "opacity", "disney"):
        assert np.array_equal(getattr(tm, k).numpy(),
                              np.asarray(getattr(jm, k))), k
    for k in ("rough_u", "rough_v"):
        _close(getattr(tm, k), getattr(jm, k), rtol=1e-6, scale=0)
    assert tm.families == tuple(jm.families) == ts.mat_families


def test_fresnel_conductor_metal_data_and_roughness():
    rs = np.random.RandomState(83)
    c = rs.uniform(-1, 1, N).astype(np.float32)
    eta, k = (rs.uniform(0.1, 3, (N, 31)).astype(np.float32)
              for _ in range(2))
    _close(tbsdf.fresnel_conductor(*(torch.from_numpy(x) for x in (c, eta,
                                                                   k))),
           jbsdf.fresnel_conductor(*(jnp.asarray(x) for x in (c, eta, k))))
    for name in ("Cu", "Au", "Ag", "Al", "MgO", "TiO2"):
        for a, b in zip(tmetal.conductor_eta_k(name),
                        jmetal.conductor_eta_k(name)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    r = np.concatenate([np.linspace(0, 1, 257),
                        rs.uniform(0, 2, 256)]).astype(np.float32)
    # x ** 4: XLA squares twice, torch calls pow: up to 2 ulps apart
    _close(tbsdf.roughness_to_alpha(torch.from_numpy(r)),
           jbsdf.roughness_to_alpha(jnp.asarray(r)), rtol=1e-5, scale=0)


@pytest.fixture(scope="module")
def parsed():
    return jparse(MATS_SCENE).scene, tparse(MATS_SCENE, device=DEV).scene


def _hit_inputs(ts, seed):
    """Random lanes over every material of the parsed scene: uv (outside
    [0,1] too), points in the box, a ray-cone footprint and uv
    derivatives (a quarter of them zero: the cone fallback)."""
    rs = np.random.RandomState(seed)
    M = int(ts.mat_type.shape[0])
    mat = rs.randint(-1, M, N).astype(np.int32)
    uv = rs.uniform(-1, 3, (N, 2)).astype(np.float32)
    p = rs.uniform(0, 5, (N, 3)).astype(np.float32)
    uv_w = rs.uniform(0, 0.05, N).astype(np.float32)
    duv = (rs.randn(N, 4) * 0.01).astype(np.float32)
    duv[::4] = 0.0
    u_mix = rs.rand(N).astype(np.float32)
    return mat, uv, p, uv_w, duv, u_mix


def test_gather_materials_with_textures_matches_jax(parsed):
    """cornell_materials.pbrt's table: imagemap and checkerboard Kd at the
    finest level, through the cone and by EWA, uber's opacity, the mix."""
    js, ts = parsed
    mat, uv, p, uv_w, duv, u_mix = _hit_inputs(ts, 84)
    J = [jnp.asarray(x) for x in (mat, uv, p, uv_w, duv, u_mix)]
    T = [torch.from_numpy(x) for x in (mat, uv, p, uv_w, duv, u_mix)]
    for kw in ({}, dict(uv_width=3), dict(uv_width=3, duv=4)):
        jm = jbsdf.gather_materials(js, J[0], uv=J[1], p=J[2], u_mix=J[5],
                                    **{k: J[v] for k, v in kw.items()})
        tm = tbsdf.gather_materials(ts, T[0], uv=T[1], p=T[2], u_mix=T[5],
                                    **{k: T[v] for k, v in kw.items()})
        assert np.array_equal(tm.type.numpy(), np.asarray(jm.type))
        for k in ("kd", "ks", "kr", "kt"):
            _close(getattr(tm, k), getattr(jm, k), rtol=1e-5, scale=1e-6)
        for k in ("eta", "sigma", "eta_spec", "k_spec", "opacity",
                  "disney"):
            assert np.array_equal(getattr(tm, k).numpy(),
                                  np.asarray(getattr(jm, k))), k
        assert np.array_equal(tm.beckmann.numpy(), np.asarray(jm.beckmann))
    # textured lanes really read the image and the checkerboard
    tex = ts.mat_kd_tex[torch.from_numpy(mat).clamp(min=0).long()]
    assert int((tex >= 0).sum()) > N // 20


def test_bump_shading_normal_matches_jax(parsed):
    js, ts = parsed
    mat, uv, p, *_ = _hit_inputs(ts, 85)
    rs = np.random.RandomState(86)
    ns = _unit(rs, N)
    ng = np.where((ns * _unit(rs, N)).sum(-1, keepdims=True) > 0,
                  ns, -ns).astype(np.float32)

    def hit(mod, conv):
        z = conv(np.zeros(N, np.float32))
        return mod.Hit(valid=conv(np.ones(N, bool)), t=z, p=conv(p),
                       ng=conv(ng), ns=conv(ns), uv=conv(uv), wo=conv(ns),
                       prim=conv(mat), material=conv(mat), light=conv(mat),
                       instance=conv(mat))
    jn = jbsdf.bump_shading_normal(js, jnp.asarray(mat),
                                   hit(jisect, jnp.asarray))
    tn = tbsdf.bump_shading_normal(ts, torch.from_numpy(mat),
                                   hit(tisect, torch.from_numpy)).numpy()
    bumped = ts.mat_bump_tex[torch.from_numpy(mat).clamp(min=0).long()] >= 0
    bumped = bumped.numpy() & (mat >= 0)
    assert bumped.mean() > 0.02
    assert np.abs(tn[bumped] - ns[bumped]).max() > 1e-3   # it bends
    assert np.array_equal(tn[~bumped], ns[~bumped])
    # finite differences at eps 2e-3 of noise that differs by ulps
    np.testing.assert_allclose(tn, np.asarray(jn), rtol=0, atol=1e-4)
