"""The matched-RNG parity integrator's parts: the GlobalSampler index map
of `core/lds.py`, `ray_triangle` and `make_hit(exact_p=True)` of
`ops/intersect.py`, the film's `pbrt_boundary`, and the light list, BSDF
layer and shading frame of `integrators/refpath.py`, each against its
pbrt_tpu twin on the same inputs (numpy seeds, or
scenes/cornell_refrng.pbrt parsed by both packages into the same
primitive order).  trace_ref itself: test_torch_refpath_trace.py.

Tolerances, each with the figure measured on the CPU:
- the Sobol' index map and per-lane samples: bit for bit;
- ray_triangle: hit masks equal, t within 1e-5 relative, barycentrics
  within 1e-5 absolute (measured: equal bit for bit);
- make_hit: ids and masks equal, t, p and normals within 1e-5 / 1e-6
  (measured: t and p equal, normals 1.2e-7);
- the light list: equal;
- the film splat: within 1e-5 / 1e-6;
- the BSDF layer and the shading frame: in their tests' docstrings.
"""
import dataclasses
import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.core import lds as jlds
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import refpath as jref
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.core import lds as tlds
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import refpath as tref
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools.pbrt import build_camera as tbuild_camera
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_core import rounding_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "cornell_refrng.pbrt")
W = H = 128
DEV = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scenes():
    jj, tj = jparse(SCENE), tparse(SCENE, device=DEV)
    assert np.array_equal(np.asarray(jj.scene.tri_v0), tj.scene.tri_v0.numpy())
    return jj, tj


# ---------------------------------------------------------------------------
# the GlobalSampler index map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 7])
def test_sobol_global_index_matches_jax(m):
    jt, tt = jlds.sobol_global_tables(m), tlds.sobol_global_tables(m)
    for k in ("gx", "gy", "gf"):
        assert np.array_equal(jt[k], tt[k]), k
    rs = np.random.RandomState(m)
    n_frames = 1 << (30 - 2 * m)
    frame = rs.randint(0, min(n_frames, 1 << 12), 4096).astype(np.uint32)
    px = rs.randint(0, 1 << m, 4096).astype(np.uint32)
    py = rs.randint(0, 1 << m, 4096).astype(np.uint32)
    want = np.asarray(jlds.sobol_global_index(frame, px, py, m))
    got = tlds.sobol_global_index(*(torch.from_numpy(x.astype(np.int64))
                                    for x in (frame, px, py)), m)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_sobol_sample_pbrt_per_lane_dims_match_jax():
    """Per-lane dimensions (refpath's counters), bit for bit against
    pbrt_tpu's gather, and equal to the int form where dim is constant."""
    rs = np.random.RandomState(3)
    idx = rs.randint(0, 1 << 30, 8192).astype(np.uint32)
    dim = rs.randint(0, tlds.N_SOBOL_DIMS, 8192).astype(np.int32)
    want = np.asarray(jlds.sobol_sample_pbrt(idx, dim))
    ti = torch.from_numpy(idx.astype(np.int64))
    got = tlds.sobol_sample_pbrt(ti, torch.from_numpy(dim.astype(np.int64)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    for d in (0, 1, 2, 5, 44, 1023):
        lanes = tlds.sobol_sample_pbrt(ti, torch.full_like(ti, d))
        assert torch.equal(lanes, tlds.sobol_sample_pbrt(ti, d)), d
        assert np.array_equal(tlds.sobol_sample_pbrt(ti, d).numpy(),
                              np.asarray(jlds.sobol_sample_pbrt(idx, d))), d


def test_sobol_global_index_enumerates_pixels():
    """The index map equals brute-force Sobol' enumeration on a 16x16
    raster (lowdiscrepancy.h:229), the twin of pbrt_tpu's own test."""
    m, F = 4, 4
    tab = tlds._SOBOL_NP

    def sobol_xy(i):
        x = y = 0
        for j in range(30):
            if (i >> j) & 1:
                x ^= int(tab[0, j]) << 2
                y ^= int(tab[1, j]) << 2
        return x, y

    seen = {}
    for i in range(F << (2 * m)):
        x, y = sobol_xy(i)
        seen.setdefault((x >> (32 - m), y >> (32 - m)), []).append(i)
    for (px, py), idxs in seen.items():
        for f in range(F):
            mine = int(tlds.sobol_global_index(f, px, py, m))
            want = [i for i in idxs if (i >> (2 * m)) == f]
            assert len(want) == 1 and mine == want[0], (px, py, f)


# ---------------------------------------------------------------------------
# ops/intersect.py and the film
# ---------------------------------------------------------------------------

def test_ray_triangle_matches_jax():
    rs = np.random.RandomState(5)
    B, K = 2048, 3
    o = rs.uniform(-2, 2, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # triangles whose plane holds a point c of the ray at barycentrics
    # (a, b): the ray hits where a, b >= 0 and a + b <= 1
    c = o[:, None] + d[:, None] * rs.uniform(0.5, 3, (B, K, 1))
    e1 = rs.uniform(-1, 1, (B, K, 3)).astype(np.float32)
    e2 = rs.uniform(-1, 1, (B, K, 3)).astype(np.float32)
    a, b = rs.uniform(-0.3, 0.8, (2, B, K, 1))
    v0 = (c - a * e1 - b * e2).astype(np.float32)
    tmax = np.full(B, 1e30, np.float32)
    tmax[::7] = 1.0
    jt, jb1, jb2, jhit = (np.asarray(x) for x in jisect.ray_triangle(
        *(jnp.asarray(x) for x in (o, d, v0, e1, e2, tmax))))
    tt, tb1, tb2, thit = tisect.ray_triangle(
        *(torch.from_numpy(x) for x in (o, d, v0, e1, e2, tmax)))
    assert 0.2 < jhit.mean() < 0.8
    assert np.array_equal(thit.numpy(), jhit)
    _close(tt.numpy()[jhit], jt[jhit], atol=0)
    _close(tb1.numpy()[jhit], jb1[jhit], rtol=0, atol=1e-5)
    _close(tb2.numpy()[jhit], jb2[jhit], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hits(scenes):
    """Camera rays of every 4th pixel of rows 0-127, and one bounce of
    them, traced by pbrt_tpu; both packages' make_hit(exact_p=True) on
    pbrt_tpu's (t, prim, found)."""
    jj, tj = scenes
    rs = np.random.RandomState(11)
    cam = tbuild_camera(tj, W, H, DEV)
    sampler = tref.RefSampler.make(W, H)
    ids = torch.arange(0, W * H, 4)
    ray = tref.camera_rays_ref(cam, W, H, sampler, ids, 0)[0]
    o, d = ray.o.numpy(), ray.d.numpy()
    out = []
    for _ in range(2):
        jh, th = _hits_pair(jj.scene, tj.scene, o, d)
        out.append((jh, th))
        # next: from each hit point, a random direction off its surface
        ng = np.asarray(jh.ng)
        w = rs.normal(size=ng.shape).astype(np.float32)
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        w = np.where((w * ng).sum(-1, keepdims=True) < 0, -w, w)
        o = (np.asarray(jh.p) + 1e-3 * ng).astype(np.float32)
        d = w
    return out


def test_make_hit_exact_p_and_instance_match_jax(hits):
    n_found = 0
    for jh, th in hits:
        valid = np.asarray(jh.valid)
        n_found += valid.sum()
        for k in ("valid", "prim", "material", "light", "instance"):
            assert np.array_equal(_np(getattr(th, k)),
                                  np.asarray(getattr(jh, k))), k
        for k in ("t", "p", "ng", "ns"):
            _close(_np(getattr(th, k))[valid],
                   np.asarray(getattr(jh, k))[valid])
    assert n_found > 1000
    jh, th = hits[0]
    assert len(np.unique(th.instance.numpy())) > 5


def test_pbrt_boundary_splat_matches_jax():
    """The reference's inclusive pixel set, with jitters of exactly 0.0:
    such a box-filter sample lands full weight in the pixels on both
    sides of each axis."""
    rs = np.random.RandomState(21)
    n = 512
    pf = (rs.rand(n, 2) * [16, 12]).astype(np.float32)
    pf[::3] = np.floor(pf[::3])                 # jitter exactly 0.0
    pf[1::5, 0] = np.floor(pf[1::5, 0])
    L = rs.rand(n, 31).astype(np.float32)
    w = rs.rand(n).astype(np.float32)
    jf = jfilm.add_samples(jfilm.make_film(16, 12, "box", pbrt_boundary=True),
                           jnp.asarray(pf), jnp.asarray(L), jnp.asarray(w))
    tf = tfilm.add_samples(
        tfilm.make_film(16, 12, "box", device=DEV, pbrt_boundary=True),
        torch.from_numpy(pf), torch.from_numpy(L), torch.from_numpy(w))
    assert tf.footprint == jf.footprint == 2
    for k in ("weighted", "weight", "raw"):
        _close(getattr(tf, k), getattr(jf, k))
    one = tfilm.add_samples(
        tfilm.make_film(16, 12, "box", device=DEV, pbrt_boundary=True),
        torch.tensor([[5.0, 4.0]]), torch.ones(1, 31))
    assert torch.equal(one.weight[3:5, 4:6], torch.ones(2, 2))
    assert one.weight.sum() == 4
    # without it the minimal footprint drops such a sample altogether
    plain = tfilm.add_samples(tfilm.make_film(16, 12, "box", device=DEV),
                              torch.tensor([[5.0, 4.0]]), torch.ones(1, 31))
    assert plain.weight.sum() == 0


# ---------------------------------------------------------------------------
# refpath
# ---------------------------------------------------------------------------

def test_build_ref_lights_matches_jax(scenes):
    jj, tj = scenes
    jl, tl = jref.build_ref_lights(jj.scene), tref.build_ref_lights(tj.scene)
    assert tl.count == jl.count == 2
    for k in ("p0", "e1", "e2", "n", "area", "L"):
        assert np.array_equal(getattr(tl, k).numpy(),
                              np.asarray(getattr(jl, k))), k
    assert np.array_equal(tl.two_sided.numpy(), np.asarray(jl.two_sided))
    assert np.array_equal(tl.prim.numpy(), np.asarray(jl.prim))
    # a light record with neither triangles nor a sphere gives no entry,
    # as in the JAX package, so this scene is left with none (sphere
    # lights are ported: test_torch_lights.py)
    lt = tj.scene.light_tri_idx.clone()
    lt[0] = -1
    with pytest.raises(ValueError, match="no area lights"):
        tref.build_ref_lights(dataclasses.replace(tj.scene, light_tri_idx=lt))


# sphere lights (one reversed and scaled) beside a mesh light
SPHERE_LIGHTS = """WorldBegin
Material "matte"
Shape "trianglemesh" "point P" [-4 -4 0 4 -4 0 4 4 0 -4 4 0]
    "integer indices" [0 1 2 2 3 0]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [8 8 8]
Translate 0.3 1.5 2.6
Shape "sphere" "float radius" [.4]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "rgb L" [2 3 4] "bool twosided" "true"
Shape "trianglemesh" "point P" [-1 -1 3 1 -1 3 1 1 3 -1 1 3]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
ReverseOrientation
AreaLightSource "diffuse" "rgb L" [3 2 1]
Translate -1.5 0 1
Scale 1.5 1.5 1.5
Shape "sphere" "float radius" [.3]
AttributeEnd
WorldEnd
"""


def test_ref_sphere_lights_match_jax():
    """build_ref_lights' sphere entries (one each, 4 pi r^2, the normal's
    sign), Sphere::Sample by cone and, inside, by area, and both halves
    of _pdf_li, against pbrt_tpu on the same points.

    The sphere's formulas cancel on some lanes (_sphere_sample64,
    _sphere_pdf64: the cone's 1 - cosmax far from the sphere, ds and
    cos alpha near its silhouette, the angle 2 pi u near 2 pi), and there
    the two packages' f32 results differ by an amount that depends on
    the CPU: on one AMD EPYC CPU 2.5% of the sphere lanes were more than
    1e-5 relative apart, where another CPU had measured under 0.5%.  So
    each package's point, normal and pdf on a sphere lane is held to an
    f64 evaluation of the same formula within REF_ULPS f32 roundings of
    each ill-conditioned intermediate, carried by its f64 derivative
    (test_torch_core.rounding_bound; measured within 0.72 of the bound);
    the triangle lanes' pdf (the same ray_triangle in both) to 1e-5."""
    jsc = JAPI().parse_string(SPHERE_LIGHTS).scene
    tsc = TAPI(DEV).parse_string(SPHERE_LIGHTS).scene
    jl, tl = jref.build_ref_lights(jsc), tref.build_ref_lights(tsc)
    assert tl.count == jl.count == 4
    for k in ("p0", "e1", "e2", "n", "area", "L", "center", "radius",
              "nsign"):
        assert np.array_equal(_np(getattr(tl, k)), np.asarray(getattr(jl,
                                                                      k))), k
    for k in ("two_sided", "prim"):
        assert np.array_equal(_np(getattr(tl, k)), np.asarray(getattr(jl,
                                                                      k))), k
    assert tl.sphere.tolist() == (np.asarray(jl.kind) == 1).tolist() == [
        True, False, False, True]
    rs = np.random.RandomState(81)
    B = 2048
    p = rs.uniform(-2, 2, (B, 3)).astype(np.float32)
    p[::50] = np.float32([0.3, 1.5, 2.6]) + rs.uniform(
        -0.2, 0.2, (len(p[::50]), 3)).astype(np.float32)   # inside
    u1, u2 = rs.rand(2, B).astype(np.float32)
    k = rs.randint(0, 4, B)
    to = tref._sphere_sample_li(tl.center[k], tl.radius[k], tl.nsign[k],
                                torch.from_numpy(p), torch.from_numpy(u1),
                                torch.from_numpy(u2))
    jo = jref._sphere_sample_li(jl.center[k], jl.radius[k], jl.nsign[k],
                                jnp.asarray(p), jnp.asarray(u1),
                                jnp.asarray(u2))
    sph = tl.sphere[k].numpy()
    c64, r64, s64 = (_np(x).astype(np.float64)
                     for x in (tl.center[k], tl.radius[k], tl.nsign[k]))
    p64, u1_64, u2_64 = (x.astype(np.float64) for x in (p, u1, u2))
    want, bound = rounding_bound(lambda pt: _sphere_sample64(
        c64, r64, s64, p64, u1_64, u2_64, pt), SPHERE_SITES, REF_ULPS)
    for o in (to, jo):
        got = np.concatenate([_np(o[0]), _np(o[1]), _np(o[2])[:, None]], -1)
        assert _within(got[sph], want[sph], bound[sph]).all()
    wi = rs.randn(B, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    tpdf, thit = tref._pdf_li(tl, torch.from_numpy(k), torch.from_numpy(p),
                              torch.from_numpy(wi))
    jpdf, jhit = jref._pdf_li(jl, jnp.asarray(k), jnp.asarray(p),
                              jnp.asarray(wi))
    assert np.array_equal(thit.numpy(), np.asarray(jhit))
    want, bound = rounding_bound(lambda pt: _sphere_pdf64(
        c64, r64, p64, wi.astype(np.float64), pt), SPHERE_PDF_SITES,
        REF_ULPS)
    for got in (tpdf, jpdf):
        assert _within(_np(got)[sph], want[sph], bound[sph]).all()
    _close(_np(tpdf)[~sph], np.asarray(jpdf)[~sph])


# ---------------------------------------------------------------------------
# f64 evaluations of the ill-conditioned formulas, for per-lane bounds
# (test_torch_core.rounding_bound)
# ---------------------------------------------------------------------------

# f32 roundings a site may be off by in either package (libm's sqrt, cos
# and sin are within an ulp or two; several roundings meet at each site)
REF_ULPS = 8


def _r(pert, x, name):
    return x * (1.0 + pert.get(name, 0.0))


FR_SITES = ("ci", "st", "et_ci", "ei_ct", "ei_ci", "et_ct", "fr")


def _fr_dielectric64(cos_i, eta_i, eta_t, pert):
    """refpath.fr_dielectric in float64 (sites FR_SITES): near total
    internal reflection cos_t = sqrt(1 - st^2) cancels, and near
    Brewster's angle rpar's numerator does."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    ci = _r(pert, np.abs(cos_i), "ci")
    si = np.sqrt(np.maximum(1.0 - ci * ci, 0.0))
    st = _r(pert, ei / et * si, "st")
    ct = np.sqrt(np.maximum(1.0 - st * st, 0.0))
    a, b = _r(pert, et * ci, "et_ci"), _r(pert, ei * ct, "ei_ct")
    c, d = _r(pert, ei * ci, "ei_ci"), _r(pert, et * ct, "et_ct")
    rpar = (a - b) / np.maximum(a + b, 1e-12)
    rper = (c - d) / np.maximum(c + d, 1e-12)
    return np.where(st >= 1, 1.0, _r(pert, 0.5 * (rpar * rpar + rper * rper),
                                     "fr"))


TR_SITES = ("ws_x", "ws_y", "ws_z", "st", "g1", "A", "AA1", "Btt", "D",
            "z_den", "z", "sy", "s2", "cos_phi", "sin_phi", "wh_x", "wh_y")


def _tr_sample_wh64(wo, ax, ay, u1, u2, pert):
    """refpath.tr_sample_wh in float64 (sites TR_SITES): 1 - cos^2 at
    near-normal incidence, A^2 - 1 where the uniform sits near the
    visible normal's G1, B tmp -+ D, and slope_y's rational fit's
    denominator as u2 -> 0 or 1, cancel."""
    flip = wo[:, 2] < 0
    w = np.where(flip[:, None], -wo, wo)
    ws = np.stack([ax * w[:, 0], ay * w[:, 1], w[:, 2]], -1)
    ws = ws / np.linalg.norm(ws, axis=-1, keepdims=True)
    wsx, wsy = _r(pert, ws[:, 0], "ws_x"), _r(pert, ws[:, 1], "ws_y")
    cos_theta = _r(pert, ws[:, 2], "ws_z")
    ct = np.maximum(cos_theta, 1e-7)
    st = _r(pert, np.sqrt(np.maximum(1.0 - ct * ct, 0.0)), "st")
    tant = st / ct
    a = 1.0 / np.maximum(tant, 1e-12)
    g1 = _r(pert, 2.0 / (1.0 + np.sqrt(1.0 + 1.0 / (a * a))), "g1")
    A = _r(pert, 2.0 * u1 / np.maximum(g1, 1e-12) - 1.0, "A")
    aa1 = _r(pert, A * A - 1.0, "AA1")
    tmp = 1.0 / np.maximum(aa1, -1e30)
    tmp = np.where(np.abs(aa1) < 1e-12, 1e10, tmp)
    tmp = np.minimum(tmp, 1e10)
    btt = _r(pert, tant * tmp, "Btt")
    D = _r(pert, np.sqrt(np.maximum(
        btt * btt - (A * A - tant * tant) * tmp, 0.0)), "D")
    sx1, sx2 = btt - D, btt + D
    slope_x = np.where((A < 0) | (sx2 > 1.0 / np.maximum(tant, 1e-12)),
                       sx1, sx2)
    S = np.where(u2 > 0.5, 1.0, -1.0)
    u2p = np.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    # the rational fit's denominator cancels to ~5e-4 as u2 -> 0 or 1
    den = _r(pert, u2p * (u2p * (u2p * 0.093073 + 0.309420) - 1.0),
             "z_den") + 0.597999
    z = _r(pert, (u2p * (u2p * (u2p * 0.27385 - 0.73369) + 0.46341))
           / den, "z")
    slope_y = _r(pert, S * z * np.sqrt(1.0 + slope_x * slope_x), "sy")
    rr = np.sqrt(np.maximum(u1 / np.maximum(1.0 - u1, 1e-12), 0.0))
    phi = 6.28318530718 * u2
    near = cos_theta > 0.9999
    slope_x = np.where(near, rr * np.cos(phi), slope_x)
    slope_y = np.where(near, rr * np.sin(phi), slope_y)
    s2 = _r(pert, np.maximum(1.0 - cos_theta ** 2, 0.0), "s2")
    inv_s = 1.0 / np.sqrt(np.maximum(s2, 1e-20))
    cos_phi = _r(pert, np.where(s2 > 1e-20, wsx * inv_s, 1.0), "cos_phi")
    sin_phi = _r(pert, np.where(s2 > 1e-20, wsy * inv_s, 0.0), "sin_phi")
    hx = _r(pert, -ax * (cos_phi * slope_x - sin_phi * slope_y), "wh_x")
    hy = _r(pert, -ay * (sin_phi * slope_x + cos_phi * slope_y), "wh_y")
    wh = np.stack([hx, hy, np.ones_like(hx)], -1)
    wh = wh / np.linalg.norm(wh, axis=-1, keepdims=True)
    return np.where(flip[:, None], -wh, wh)


SPHERE_SITES = ("dc2", "wc", "cosmax", "cost", "phi", "dc_cost", "disc",
                "ds", "num", "cosa", "cos_in", "d2_in")


def _pbrt_frame64(v1):
    use_x = np.abs(v1[:, 0]) > np.abs(v1[:, 1])
    z = np.zeros_like(v1[:, 0])
    inv = 1.0 / np.sqrt(np.maximum(np.where(
        use_x, v1[:, 0] ** 2 + v1[:, 2] ** 2,
        v1[:, 1] ** 2 + v1[:, 2] ** 2), 1e-30))
    v2 = np.where(use_x[:, None], np.stack([-v1[:, 2], z, v1[:, 0]], -1),
                  np.stack([z, v1[:, 2], -v1[:, 1]], -1)) * inv[:, None]
    return v2, np.cross(v1, v2)


def _sphere_sample64(c, r, nsign, p_ref, u1, u2, pert):
    """refpath._sphere_sample_li in float64 (sites SPHERE_SITES) as one
    [B,7] array: point, normal, pdf.  Far from the sphere the cone's
    1 - cosmax cancels (its pdf), and ds and cos alpha cancel near the
    silhouette; inside, the area-to-solid-angle |cos| does near the
    horizon; and an angle 2 pi u near 2 pi has a sine near 0 whose f32
    angle's rounding is a large share of it."""
    to_c = c - p_ref
    dc2 = _r(pert, np.maximum(np.sum(to_c * to_c, -1), 1e-20), "dc2")
    inside = dc2 <= r * r
    dc = np.sqrt(dc2)
    wc = _r(pert, to_c / dc[:, None], "wc")
    wcx, wcy = _pbrt_frame64(wc)
    cosmax = _r(pert, np.sqrt(np.maximum(1.0 - r * r / dc2, 0.0)),
                "cosmax")
    cost = _r(pert, (1.0 - u1) + u1 * cosmax, "cost")
    sint = np.sqrt(np.maximum(1.0 - cost * cost, 0.0))
    phi = _r(pert, u2 * 2.0 * np.pi, "phi")
    ds = _r(pert, _r(pert, dc * cost, "dc_cost") - np.sqrt(np.maximum(
        _r(pert, r * r - dc2 * sint * sint, "disc"), 0.0)), "ds")
    cosa = _r(pert, _r(pert, dc2 + r * r - ds * ds, "num")
              / np.maximum(2.0 * dc * r, 1e-20), "cosa")
    sina = np.sqrt(np.maximum(1.0 - cosa * cosa, 0.0))
    n_cone = ((sina * np.cos(phi))[:, None] * -wcx
              + (sina * np.sin(phi))[:, None] * -wcy + cosa[:, None] * -wc)
    p_cone = c + r[:, None] * n_cone
    pdf_cone = 1.0 / np.maximum(2.0 * np.pi * (1.0 - cosmax), 1e-20)
    zz = 1.0 - 2.0 * u1
    rr = np.sqrt(np.maximum(1.0 - zz * zz, 0.0))
    ph = _r(pert, 2.0 * np.pi * u2, "phi")
    n_in = np.stack([rr * np.cos(ph), rr * np.sin(ph), zz], -1)
    p_in = c + r[:, None] * n_in
    wi_in = p_in - p_ref
    d2_in = _r(pert, np.maximum(np.sum(wi_in * wi_in, -1), 1e-20), "d2_in")
    wi_n = wi_in / np.sqrt(d2_in)[:, None]
    cos_in = _r(pert, np.abs(np.sum(n_in * -wi_n, -1)), "cos_in")
    pdf_in = d2_in / np.maximum(cos_in * (4.0 * np.pi * r * r), 1e-20)
    n = np.where(inside[:, None], n_in, n_cone) * nsign[:, None]
    return np.concatenate([np.where(inside[:, None], p_in, p_cone), n,
                           np.where(inside, pdf_in, pdf_cone)[:, None]], -1)


SPHERE_PDF_SITES = ("dc2", "cosmax", "bq", "disc", "ts", "cos_s")


def _sphere_pdf64(c, r, p_ref, wi, pert):
    """The sphere half of refpath._pdf_li in float64 (sites
    SPHERE_PDF_SITES): the cone's 1 - cosmax from outside; from inside the
    quadratic's discriminant and the hit's |cos|."""
    dc2 = _r(pert, np.maximum(np.sum((c - p_ref) ** 2, -1), 1e-20), "dc2")
    inside = dc2 <= r * r
    cosmax = _r(pert, np.sqrt(np.maximum(1.0 - r * r / dc2, 0.0)),
                "cosmax")
    pdf_cone = 1.0 / np.maximum(2.0 * np.pi * (1.0 - cosmax), 1e-20)
    oc = p_ref - c
    bq = _r(pert, 2.0 * np.sum(oc * wi, -1), "bq")
    disc = _r(pert, bq * bq - 4.0 * (np.sum(oc * oc, -1) - r * r), "disc")
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0, t1 = 0.5 * (-bq - sq), 0.5 * (-bq + sq)
    ts = _r(pert, np.where(t0 > 1e-5, t0, t1), "ts")
    s_hit = (disc >= 0) & (ts > 1e-5)
    cos_s = _r(pert, np.abs(np.sum((oc + ts[:, None] * wi) * -wi, -1))
               / np.maximum(r, 1e-20), "cos_s")
    pdf_in = np.where(s_hit, ts * ts / np.maximum(
        cos_s * (4.0 * np.pi * r * r), 1e-20), 0.0)
    return np.where(inside, pdf_in, pdf_cone)


def _within(got, want, bound):
    """Lanes (rows) whose every element lies within its bound."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    return (np.abs(got - want.reshape(len(want), -1))
            <= bound.reshape(len(want), -1)).all(-1)


GLASS_SITES = FR_SITES + ("sin2_t",)


def _glass_spec64(wo, eta, kr, kt, u1, pert):
    """ref_sample_all's smooth-glass branch in float64 (sites
    GLASS_SITES) as one [B,35] array: wi, f, pdf.  Near total internal
    reflection cos_t = sqrt(1 - sin2_t) cancels, in the refracted
    direction and in f's 1 / cos_t."""
    Fr = _fr_dielectric64(wo[:, 2], 1.0, eta, pert)
    refl = u1 < _fr_dielectric64(wo[:, 2], 1.0, eta, {})
    entering = wo[:, 2] > 0
    ei, et = np.where(entering, 1.0, eta), np.where(entering, eta, 1.0)
    eta_rel = ei / et
    cos_i = np.abs(wo[:, 2])
    sin2_t = _r(pert, eta_rel * eta_rel * np.maximum(1.0 - cos_i * cos_i,
                                                     0.0), "sin2_t")
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    nz = np.where(entering, 1.0, -1.0)
    wi_t = np.stack([-eta_rel * wo[:, 0], -eta_rel * wo[:, 1], -cos_t * nz],
                    -1)
    wi_r = np.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    f_r = kr * (Fr / np.maximum(cos_i, 1e-9))[:, None]
    f_t = kt * ((1.0 - Fr) * eta_rel ** 2 / np.maximum(cos_t, 1e-9))[:, None]
    return np.concatenate([
        np.where(refl[:, None], wi_r, wi_t), np.where(refl[:, None], f_r, f_t),
        np.where(refl, Fr, 1.0 - Fr)[:, None]], -1)


# refpath's component remap clamps u to pbrt's OneMinusEpsilon
_ONE_MINUS_EPS = float(np.float32(0.99999994))


def _reflect64(wo, wh):
    return 2.0 * np.sum(wo * wh, -1, keepdims=True) * wh - wo


def _subset(mat, m):
    """The lanes m of a material record (pbrt_tpu's namespace or the
    port's MaterialParams)."""
    if isinstance(mat, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: v[m] for k, v in
                                        vars(mat).items()})
    mt = torch.from_numpy(m)
    return dataclasses.replace(mat, **{
        f.name: getattr(mat, f.name)[mt] for f in dataclasses.fields(mat)
        if torch.is_tensor(getattr(mat, f.name))})


MATERIALS = {"matte": 0, "plastic": 1, "mirror": 2, "glass": 3}


def _materials(mtype, B, rs):
    kd = rs.uniform(0, 1, (B, 31)).astype(np.float32)
    kd[::5] = 0.0                               # black lobes are not made
    ks = rs.uniform(0, 1, (B, 31)).astype(np.float32)
    ks[1::6] = 0.0
    f = dict(type=np.full(B, mtype, np.int32), kd=kd, ks=ks,
             kr=rs.uniform(0, 1, (B, 31)).astype(np.float32),
             kt=rs.uniform(0, 1, (B, 31)).astype(np.float32),
             rough_u=rs.uniform(0.01, 0.6, B).astype(np.float32),
             rough_v=rs.uniform(0.01, 0.6, B).astype(np.float32),
             eta=rs.uniform(1.2, 1.8, B).astype(np.float32))
    jm = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in f.items()})
    tm = tbsdf.MaterialParams(sigma=torch.zeros(B), **{
        k: torch.from_numpy(v) for k, v in f.items()})
    return jm, tm


def _dirs(rs, B, flip_share=0.3):
    w = rs.normal(size=(B, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[:, 2] = np.abs(w[:, 2]) * np.where(rs.rand(B) < flip_share, -1, 1)
    return w


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_ref_bsdf_matches_jax(name):
    """The reference BSDF layer per material on seeded directions,
    samples and parameters (raw alpha 0.01-0.6).  Evaluations (ref_f,
    ref_pdf) within 1e-5 / 1e-6 (measured <= 1.9e-6 absolute);
    tr_sample_11 within 1e-4 (measured 4.6e-5).

    Three formulas cancel on some lanes, and there the two packages' f32
    results differ by an amount that depends on the CPU (on one AMD EPYC
    CPU 1.4-1.5% of sampled directions were more than 1e-5 apart, where
    another CPU had measured under 1%, and one Fresnel value 1.5e-5
    relative): TrowbridgeReitzSample11 (_tr_sample_wh64: 1 - cos^2 at
    near-normal incidence, A^2 - 1, B tmp -+ D, and slope_y's rational
    fit, whose denominator falls to ~5e-4 as u2 -> 0 or 1), FrDielectric
    (_fr_dielectric64: cos_t near total internal reflection, rpar near
    Brewster's angle) and smooth glass's refraction (_glass_spec64).  So
    each package's Fresnel value, sampled microfacet normal, glossy
    sampled direction, and smooth glass's sampled direction, f and pdf
    are held lane by lane to an f64 evaluation of the same formula
    within REF_ULPS f32 roundings of each ill-conditioned intermediate,
    carried by its f64 derivative (test_torch_core.rounding_bound;
    measured within 0.48 of the bound, whose median is 2.7e-6 for the
    normal); the other sampled directions (Lambertian, mirror) to 1e-5
    / 1e-6 against each other; the f, pdf and eta factor of every sample
    to 5e-3 relative (measured 9.3e-4: a glossy lobe of alpha 0.01
    amplifies the direction's rounding).  Masks equal."""
    rs = np.random.RandomState(MATERIALS[name] + 31)
    B = 4096
    jm, tm = _materials(MATERIALS[name], B, rs)
    wo, wi = _dirs(rs, B), _dirs(rs, B)
    # u1 > 0: at u1 = 0 exactly TrowbridgeReitzSample11 clamps 1/(A^2-1)
    # to 1e10 and subtracts two terms of ~1e10, so its slope is f32 noise
    # in the reference and in both packages alike
    u1, u2 = (rs.uniform(1e-6, 1, B).astype(np.float32) for _ in range(2))
    ngwo = rs.normal(size=B).astype(np.float32)
    reflect = rs.rand(B) < 0.8
    J = {k: jnp.asarray(v) for k, v in dict(wo=wo, wi=wi, u1=u1, u2=u2,
                                            ngwo=ngwo, r=reflect).items()}
    T = {k: torch.tensor(np.asarray(v)) for k, v in J.items()}
    _close(tref.ref_f(tm, T["wo"], T["wi"], T["r"]),
           jref.ref_f(jm, J["wo"], J["wi"], J["r"]))
    _close(tref.ref_pdf(tm, T["wo"], T["wi"]),
           jref.ref_pdf(jm, J["wo"], J["wi"]))
    cos = T["wo"][:, 2]
    jm_np = {k: np.asarray(getattr(jm, k), np.float64) for k in ("kr", "kt")}
    f64 = {k: v.astype(np.float64) for k, v in dict(
        wo=wo, u1=u1, u2=u2, eta=tm.eta.numpy(), ax=tm.rough_u.numpy(),
        ay=tm.rough_v.numpy()).items()}
    fr, fr_b = rounding_bound(lambda pt: _fr_dielectric64(
        f64["wo"][:, 2], 1.0, f64["eta"], pt), FR_SITES, REF_ULPS)
    for got in (tref.fr_dielectric(cos, 1.0, tm.eta),
                jref.fr_dielectric(J["wo"][:, 2], 1.0, jm.eta)):
        assert _within(_np(got), fr, fr_b).all()
    for a, b in zip(tref.tr_sample_11(cos.abs(), T["u1"], T["u2"]),
                    jref.tr_sample_11(jnp.abs(J["wo"][:, 2]), J["u1"],
                                      J["u2"])):
        _close(a, b, rtol=1e-4, atol=1e-4)

    def wh64(u):
        return rounding_bound(lambda pt: _tr_sample_wh64(
            f64["wo"], f64["ax"], f64["ay"], u, f64["u2"], pt), TR_SITES,
            REF_ULPS)

    wh, wh_b = wh64(f64["u1"])
    assert np.median(wh_b) < 1e-5             # a few ulps where well posed
    for got in (tref.tr_sample_wh(T["wo"], tm.rough_u, tm.rough_v, T["u1"],
                                  T["u2"]),
                jref.tr_sample_wh(J["wo"], jm.rough_u, jm.rough_v, J["u1"],
                                  J["u2"])):
        assert _within(_np(got), wh, wh_b).all()
    # the glossy lobe's direction, for each remap of u1 the component
    # choice may make (u1, 2 u1, 2 u1 - 1)
    glossy = []
    for u in (f64["u1"], 2.0 * f64["u1"], 2.0 * f64["u1"] - 1.0):
        v, b = rounding_bound(lambda pt: _reflect64(f64["wo"], _tr_sample_wh64(
            f64["wo"], f64["ax"], f64["ay"], np.minimum(u, _ONE_MINUS_EPS),
            f64["u2"], pt)), TR_SITES, REF_ULPS)
        glossy.append((v, b))
    tn = tref.ref_sample_nonspec(tm, T["wo"], T["u1"], T["u2"])
    jn = jref.ref_sample_nonspec(jm, J["wo"], J["u1"], J["u2"])
    ta = tref.ref_sample_all(tm, T["wo"], T["u1"], T["u2"], T["ngwo"])
    ja = jref.ref_sample_all(jm, J["wo"], J["u1"], J["u2"], J["ngwo"])
    assert np.array_equal(tn[3].numpy(), np.asarray(jn[3]))
    for k in (3, 5):                     # specular, valid
        assert np.array_equal(ta[k].numpy(), np.asarray(ja[k])), k
    assert np.asarray(ja[5]).mean() > 0.5
    for t_out, j_out, ok, extra in ((tn, jn, np.asarray(jn[3]), ()),
                                    (ta, ja, np.asarray(ja[5]), (4,))):
        if not ok.any():                 # no non-specular lobe
            continue
        t_wi, j_wi = _np(t_out[0]), np.asarray(j_out[0])
        spec = (np.asarray(j_out[3]) if extra else np.zeros(B, bool))
        mf = ~spec
        for got in (t_wi, j_wi):
            mf &= np.any([_within(got, v, b) for v, b in glossy], 0)
        rest = ok & ~mf
        if name == "glass" and extra:
            # smooth glass: wi, f and pdf against their f64 evaluation
            gl, gl_b = rounding_bound(lambda pt: _glass_spec64(
                f64["wo"], f64["eta"], jm_np["kr"], jm_np["kt"], f64["u1"],
                pt), GLASS_SITES, REF_ULPS)
            for o in (t_out, j_out):
                got = np.concatenate([_np(o[0]), _np(o[1]),
                                      _np(o[2])[:, None]], -1)
                assert _within(got[rest], gl[rest], gl_b[rest]).all()
        else:
            _close(t_wi[rest], j_wi[rest])
        for k in (1, 2) + extra:         # f, pdf, eta factor
            _close(_np(t_out[k])[ok], np.asarray(j_out[k])[ok], rtol=5e-3,
                   atol=ATOL)


def _hits_pair(js, ts, o, d):
    """pbrt_tpu's (t, prim, found) for rays o, d and both packages'
    make_hit(exact_p=True) on them."""
    jray = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d))
    t, prim, u, v, found = jisect.intersect(js, jray)
    jh = jisect.make_hit(js, jray, t, prim, u, v, found, exact_p=True)
    th = tisect.make_hit(ts, tgeom.Ray.make(torch.tensor(o), torch.tensor(d)),
                         torch.tensor(np.asarray(t)),
                         torch.tensor(np.asarray(prim)).to(torch.int32),
                         torch.tensor(np.asarray(found)), exact_p=True)
    return jh, th


def _normals_scene():
    """A wavy grid with vertex normals and uvs, turned over
    (ReverseOrientation), the same grid without normals, turned over, and
    a sphere: the shading frame's branches that cornell_refrng.pbrt (no
    vertex normals) does not reach."""
    from pbrt_tpu.core import transform as jtfm
    from pbrt_tpu.scene import ir as jir
    b = jir.SceneBuilder()
    m = b.add_material(jir.MaterialSpec(kd=np.full(31, 0.5, np.float32)))
    n = 7
    xs, ys = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    zs = 0.15 * np.sin(3 * xs) * np.cos(2 * ys)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    nrm = np.stack([-0.45 * np.cos(3 * xs) * np.cos(2 * ys),
                    0.3 * np.sin(3 * xs) * np.sin(2 * ys),
                    np.ones_like(xs)], -1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack([xs ** 2, ys + 0.3 * xs], -1).reshape(-1, 2)
    q = np.arange(n * n).reshape(n, n)[:-1, :-1].reshape(-1)
    idx = np.concatenate([np.stack([q, q + 1, q + n + 1], -1),
                          np.stack([q, q + n + 1, q + n], -1)])
    b.add_triangle_mesh(verts, idx, m, normals=nrm, uvs=uv, flip_normal=True,
                        instance_id=1)
    b.add_triangle_mesh(verts + [0.0, 0.0, -0.8], idx, m, flip_normal=True,
                        instance_id=2)
    b.add_sphere(jtfm.translate(0.4, -0.3, 0.6), 0.25, m, instance_id=3)
    js = b.build()
    arrays = {k: np.asarray(getattr(js, k)) for k in tir.JAX_ARRAYS}
    statics = {k: getattr(js, k) for k in tir.JAX_STATICS}
    return js, tir.scene_from_jax(arrays, statics, DEV)


def test_shading_frame_matches_jax(scenes, hits):
    """cornell_refrng's hits and those of _normals_scene from above and
    below; within 1e-5 absolute (measured <= 2.4e-7)."""
    jj, tj = scenes
    cases = [(jj.scene, tj.scene, jh, th) for jh, th in hits]
    js, ts = _normals_scene()
    rs = np.random.RandomState(41)
    seen = set()
    for side in (1.0, -1.0):
        o = np.concatenate([rs.uniform(-0.9, 0.9, (2048, 2)),
                            np.full((2048, 1), 2.0 * side)], -1)
        d = np.concatenate([rs.uniform(-0.3, 0.3, (2048, 2)),
                            np.full((2048, 1), -side)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        jh, th = _hits_pair(js, ts, o.astype(np.float32),
                            d.astype(np.float32))
        seen |= set(np.unique(th.instance.numpy()).tolist())
        cases.append((js, ts, jh, th))
    assert seen >= {1, 2, 3}
    for jsc, tsc, jh, th in cases:
        valid = np.asarray(jh.valid)
        assert valid.mean() > 0.5
        for a, b in zip(tref._shading_frame(tsc, th),
                        jref._shading_frame(jsc, jh)):
            _close(_np(a)[valid], np.asarray(b)[valid], atol=1e-5)
