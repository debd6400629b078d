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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "cornell_refrng.pbrt")
W = H = 128
DEV = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _mostly_close(a, b, share, atol_all):
    """Rows (lanes) within RTOL / ATOL but for at most 1 - share of them,
    and every element within atol_all."""
    a, b = _np(a), _np(b)
    ok = np.isclose(a, b, rtol=RTOL, atol=ATOL).reshape(len(a), -1).all(-1)
    assert ok.mean() >= share, ok.mean()
    np.testing.assert_allclose(a, b, rtol=0, atol=atol_all)


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
    of _pdf_li, against pbrt_tpu on the same points (1e-5 relative on
    all but 0.5% of lanes, where the cone's 1 - cos cancels near the
    sphere's silhouette, every lane within 1e-3)."""
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
    for a, b in zip(to, jo):
        _mostly_close(_np(a)[sph], np.asarray(b)[sph], 0.995, 1e-3)
    wi = rs.randn(B, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    tpdf, thit = tref._pdf_li(tl, torch.from_numpy(k), torch.from_numpy(p),
                              torch.from_numpy(wi))
    jpdf, jhit = jref._pdf_li(jl, jnp.asarray(k), jnp.asarray(p),
                              jnp.asarray(wi))
    assert np.array_equal(thit.numpy(), np.asarray(jhit))
    _mostly_close(tpdf, jpdf, 0.995, 1e-3 * float(np.abs(jpdf).max()))


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
    ref_pdf, fr_dielectric) within 1e-5 / 1e-6 (measured <= 1.9e-6
    absolute); tr_sample_11 within 1e-4 (measured 4.6e-5).  A sampled
    direction goes through TrowbridgeReitzSample11's cancellations, so
    sampled directions are held to 1e-5 on >= 99% of lanes (measured
    0.990-0.993) and to 1e-3 absolute on all (measured 3.4e-4); the
    f, pdf and eta factor of a sample to 5e-3 relative (measured 9.3e-4:
    a glossy lobe of alpha 0.01 amplifies the direction's 5e-5).  Masks
    equal."""
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
    _close(tref.fr_dielectric(cos, 1.0, tm.eta),
           jref.fr_dielectric(J["wo"][:, 2], 1.0, jm.eta))
    for a, b in zip(tref.tr_sample_11(cos.abs(), T["u1"], T["u2"]),
                    jref.tr_sample_11(jnp.abs(J["wo"][:, 2]), J["u1"],
                                      J["u2"])):
        _close(a, b, rtol=1e-4, atol=1e-4)
    _mostly_close(tref.tr_sample_wh(T["wo"], tm.rough_u, tm.rough_v,
                                    T["u1"], T["u2"]),
                  jref.tr_sample_wh(J["wo"], jm.rough_u, jm.rough_v,
                                    J["u1"], J["u2"]), 0.99, 1e-3)
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
        _mostly_close(_np(t_out[0])[ok], np.asarray(j_out[0])[ok], 0.99,
                      1e-3)
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
