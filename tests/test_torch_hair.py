"""The port's hair (materials/hair.py, the fiber-aligned shading frame, the
parser's Material "hair" and a render on curves) against pbrt_tpu's on
the CPU.

Tolerances:
- hair_eval, hair_pdf and hair_sample are the same f32 formulas: on
  seeded lanes (beta_m and beta_n in [0.15, 0.8], so that both of Mp's
  branches, the series and the asymptotic log I0, run) f and pdf within
  2e-4 relative of the batch's own scale (an absolute floor of 1e-6 of
  the batch's largest value: exp(log I0(a) - b - 1/v) has exponents of a
  few hundred at small v, where an ulp of the exponent is ~1e-5
  relative), the sampled directions within 1e-4, and each package's
  sampled f and pdf against the other's hair_eval and hair_pdf at the
  same direction at the same 2e-4 (f is steep in wi: the two sampled
  directions, ulps apart, are no measure of it); measured 1.0e-5 (eval,
  pdf), 1.9e-5 (the samples' f and pdf), directions within 1.4e-6;
- the lobe chosen by hair_sample (a uniform against the Ap cdf) agrees
  on >= 99.9% of the lanes;
- the render: test_torch_volpath.assert_renders_alike.  The scene is
  tests/test_hair.py's but for its second curve, moved 0.05 behind the
  first: in one plane the two ribbons overlap, and a camera ray through
  the overlap meets two triangles at the same t, a tie that each
  package's intersector breaks its own way (another fiber, another h).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.materials import hair as jhair
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.materials import hair as thair
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.scene import ir as tir
from test_torch_bssrdf import _hit_to_torch, render_pair
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import assert_scene_equal, jax_arrays
from test_torch_volpath import assert_renders_alike

B = 4096
NS = 31


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    rs = np.random.RandomState(11)
    return dict(
        wo=_unit(rs, B), wi=_unit(rs, B),
        h=rs.uniform(-0.99, 0.99, B).astype(np.float32),
        sigma_a=rs.uniform(0.0, 3.0, (B, NS)).astype(np.float32),
        beta_m=rs.uniform(0.15, 0.8, B).astype(np.float32),
        beta_n=rs.uniform(0.15, 0.8, B).astype(np.float32),
        alpha=np.full(B, np.radians(2.0), np.float32),
        eta=np.full(B, 1.55, np.float32),
        u=rs.uniform(0.0, 1.0, (B, 4)).astype(np.float32))


def _args(d, lib):
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return {k: conv(v) for k, v in d.items()}


def _close(a, b, rtol=2e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    floor = 1e-6 * max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b) / (np.abs(b) + floor)
    assert err.max() <= rtol, err.max()


def _kw(d):
    return dict(eta=d["eta"], beta_m=d["beta_m"], beta_n=d["beta_n"],
                alpha=d["alpha"])


def test_eval_and_pdf_match_jax(lanes):
    t, j = _args(lanes, "torch"), _args(lanes, "jax")
    _close(thair.hair_eval(t["wo"], t["wi"], t["h"], t["sigma_a"], **_kw(t)),
           jhair.hair_eval(j["wo"], j["wi"], j["h"], j["sigma_a"], **_kw(j)))
    _close(thair.hair_pdf(t["wo"], t["wi"], t["h"], t["sigma_a"], **_kw(t)),
           jhair.hair_pdf(j["wo"], j["wi"], j["h"], j["sigma_a"], **_kw(j)))


def test_sample_matches_jax(lanes):
    t, j = _args(lanes, "torch"), _args(lanes, "jax")
    wt, ft, pt = thair.hair_sample(t["wo"], t["h"], t["sigma_a"], t["u"],
                                   **_kw(t))
    wj, fj, pj = jhair.hair_sample(j["wo"], j["h"], j["sigma_a"], j["u"],
                                   **_kw(j))
    # each package's f and pdf of its sample against the other's eval_f
    # and pdf at the same direction: f is steep in wi, so a direction an
    # ulp away is no measure of the sample's f
    _close(ft.numpy(), jhair.hair_eval(j["wo"], jnp.asarray(wt.numpy()),
                                       j["h"], j["sigma_a"], **_kw(j)))
    _close(pt.numpy(), jhair.hair_pdf(j["wo"], jnp.asarray(wt.numpy()),
                                      j["h"], j["sigma_a"], **_kw(j)))
    _close(thair.hair_eval(t["wo"], torch.from_numpy(np.array(wj)),
                           t["h"], t["sigma_a"], **_kw(t)), fj)
    wt, wj = wt.numpy(), np.asarray(wj)
    # the lobe each lane chose
    apt = thair._ap_pdf(*_ap_args(t, thair))
    apj = np.asarray(jhair._ap_pdf(*_ap_args(j, jhair)))
    sel_t = (lanes["u"][:, :1] > torch.cumsum(apt, -1).numpy()).sum(-1)
    sel_j = (lanes["u"][:, :1] > np.cumsum(apj, -1)).sum(-1)
    same = sel_t == sel_j
    assert same.mean() >= 0.999
    assert np.abs(wt[same] - wj[same]).max() <= 1e-4


def _ap_args(d, mod):
    """(cos_to, eta, h, T) of hair._ap_pdf for the lanes."""
    lib = torch if mod is thair else jnp
    sin_to = lib.clip(d["wo"][:, 0], -1.0, 1.0)
    cos_to = lib.sqrt(lib.maximum(1.0 - sin_to ** 2,
                                  lib.full_like(sin_to, 1e-14)))
    etap = lib.sqrt(lib.maximum(d["eta"] ** 2 - sin_to ** 2,
                                lib.full_like(sin_to, 1e-6))) \
        / lib.maximum(cos_to, lib.full_like(cos_to, 1e-6))
    sin_gt = lib.clip(d["h"] / etap, -1.0, 1.0)
    cos_gt = lib.sqrt(lib.maximum(1.0 - sin_gt ** 2,
                                  lib.full_like(sin_gt, 1e-14)))
    sin_tt = sin_to / d["eta"]
    cos_tt = lib.sqrt(lib.maximum(1.0 - sin_tt ** 2,
                                  lib.full_like(sin_tt, 1e-14)))
    T = lib.exp(-d["sigma_a"] * (2.0 * cos_gt / lib.maximum(
        cos_tt, lib.full_like(cos_tt, 1e-4)))[:, None])
    return cos_to, d["eta"], d["h"], T


CURVES = """
Integrator "path" "integer maxdepth" [3]
Sampler "sobol" "integer pixelsamples" [8]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
AttributeBegin
AreaLightSource "area" "color L" [15 15 15]
Shape "trianglemesh" "point P" [-3 3 -3  3 3 -3  3 3 3  -3 3 3]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
Material "hair" %s
Shape "curve" "point P" [-1 -1 0  -0.3 0.5 0  0.3 -0.5 0  1 1 0]
    "float width" [0.4] "string type" "flat"
Shape "curve" "point P" [-1 0.8 0.05  -0.3 0.2 0.05  0.3 0.8 0.05
    1 -0.6 0.05] "float width" [0.4] "string type" "flat"
WorldEnd
"""


@pytest.mark.parametrize("params", [
    '"float eumelanin" [0.3]',
    '"rgb color" [.6 .4 .2] "float beta_n" [.5]',
    '"rgb sigma_a" [.3 .5 1.1] "float beta_m" [.2] "float alpha" [3]'],
    ids=["melanin", "color", "sigma_a"])
def test_parsed_scene_equals_scene_from_jax(params):
    src = CURVES % params
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    assert tj.scene.has_hair and tir.MAT_HAIR in tj.scene.mat_families
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    "cpu"))


def test_fiber_frame_and_sample_f_match_jax():
    """bsdf.shading_frame's fiber-aligned axes on the curves' hits, and
    sample_f on those lanes with u3 given and without it (its hash of u1
    and u2)."""
    src = CURVES % '"float eumelanin" [0.3]'
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    n = 64
    xs = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    o = np.stack([xs, np.tile([-0.6, 0.0, 0.4, 0.7], n // 4), -4 + 0 * xs],
                 -1).astype(np.float32)
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (n, 1))
    from pbrt_tpu.core import geometry as jgeom
    from pbrt_tpu_torch.core import geometry as tgeom
    jh = jisect.intersect_full(jj.scene, jgeom.Ray.make(jnp.asarray(o),
                                                        jnp.asarray(d)))
    th = _hit_to_torch(jh)
    on_hair = np.asarray(jh.valid) & (np.asarray(jh.material) >= 0)
    assert on_hair.sum() > 8
    jss, jts = jbsdf.shading_frame(jj.scene, jh)
    tss, tts = tbsdf.shading_frame(tj.scene, th)
    assert np.abs(tss.numpy() - np.asarray(jss)).max() <= 1e-5
    assert np.abs(tts.numpy() - np.asarray(jts)).max() <= 1e-5
    jm = jbsdf.gather_materials(jj.scene, jh.material, uv=jh.uv, p=jh.p)
    tm = tbsdf.gather_materials(tj.scene, th.material, uv=th.uv, p=th.p)
    assert np.array_equal(tm.hair_h.numpy(), np.asarray(jm.hair_h))
    rs = np.random.RandomState(5)
    us = [rs.uniform(0, 1, n).astype(np.float32) for _ in range(4)]
    wo_t = tgeom.world_to_frame(tss, tts, th.ns, th.wo)
    wo_j = jgeom.world_to_frame(jss, jts, jh.ns, jh.wo)
    for u3 in (us[3], None):
        wt, ft, pt, *_ = tbsdf.sample_f(
            tm, wo_t, *(torch.from_numpy(u) for u in us[:3]),
            u3=None if u3 is None else torch.from_numpy(u3))
        wj, fj, pj, *_ = jbsdf.sample_f(
            jm, wo_j, *(jnp.asarray(u) for u in us[:3]),
            u3=None if u3 is None else jnp.asarray(u3))
        assert np.abs(wt.numpy()[on_hair] - np.asarray(wj)[on_hair]).max() \
            <= 1e-4
        _close(ft.numpy()[on_hair], np.asarray(fj)[on_hair])
        _close(pt.numpy()[on_hair], np.asarray(pj)[on_hair])


def test_hair_on_curves_renders_like_jax():
    """tests/test_hair.py's two flat curves under an area light: the
    fiber frame, h from the curve's v and the ninth sampler dimension."""
    assert_renders_alike(*render_pair(CURVES % '"float eumelanin" [0.3]'))
