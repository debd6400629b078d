"""The port's bidirectional path tracer (integrators/bdpt.py) against
pbrt_tpu's on the CPU, on tests/test_bdpt.py's boxes: the point-light
box, the area-light box and the point-light box with its mirror sphere,
at 8x8 (64 camera samples, sample index 1) and depth 2 (4 camera and 3
light vertices).

pbrt_tpu's side runs eagerly with its intersect, material, light and
sampler functions jitted one by one (the fused pass compiles for ~14 s a
scene).  Same counter-based samples, so the same subpaths but where the
two intersectors (pbrt_tpu's BVH, the port's dense kernels) pick another
triangle at an edge:
- the subpath vertices: >= 97% of lanes with p within 1e-5 and beta,
  pdf_fwd and pdf_rev within 1e-4 relative, and the same valid, delta and
  connectible flags (measured: every lane);
- the MIS weight of every (s,t) strategy on the lanes whose vertices are
  valid and whose connection is not grazing (a cosine above 1e-3 at both
  ends: a connection along a wall takes its densities from cosines of
  rounding size): >= 97% within 1e-4 relative, every one within 1e-2
  (measured: all but one lane within 1e-4, that one 1.6e-4, a hit on the
  mirror sphere 4e-6 apart: the two packages solve the sphere by other
  f32 formulas);
- connect_strategies' L and each t=1 splat: >= 97% of lanes within 1e-4
  relative (measured: every lane), sums within 1e-4.
Reference-side issue (z): a vertex shades in geom.coordinate_system(ns),
also on a hair fiber, as pbrt_tpu's does.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.integrators import bdpt as jb
from pbrt_tpu.integrators import lighttracer as jlt
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.integrators import bdpt as tb
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from test_bdpt import _box
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_hair import CURVES
from test_torch_lighttracer import port_camera, port_scene

W = H = 8
DEPTH = 2
T, S = DEPTH + 2, DEPTH + 1
SIDX = 1
BOXES = {"point": ("point", False), "area": ("area", False),
         "mirror": ("point", True)}


def _strategy_list():
    return [(s, t) for t in range(1, T + 1) for s in range(S + 1)
            if s + t <= T and s + t > 2 and not (t == 1 and s < 2)]


@pytest.fixture(scope="module")
def jitted():
    """pbrt_tpu's pieces jitted one by one, for the module."""
    jit = jax.jit
    mp = pytest.MonkeyPatch()
    mp.setattr(jb, "sample_dim", jit(jsamp.sample_dim, static_argnums=0))
    for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                 "bump_shading_normal"):
        mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
    for name in ("area_le", "delta_emit_scale", "env_le"):
        mp.setattr(jlights, name, jit(getattr(jlights, name)))
    mp.setattr(jlt, "sample_le", jit(jlt.sample_le))
    mp.setattr(jisect, "occluded", jit(jisect.occluded))
    mp.setattr(jisect, "intersect_full", jit(
        jisect.intersect_full, static_argnames=("presorted",)))
    yield
    mp.undo()


@pytest.fixture(scope="module", params=list(BOXES))
def box(request, jitted):
    """Both packages' subpaths, strategies and MIS weights of one pass."""
    js = _box(BOXES[request.param][0], mirror=BOXES[request.param][1])
    jc = jproj.make_perspective(
        jtfm.look_at([0, 0, -1.9], [0, 0, 1], [0, 1, 0]), 40.0, W, H)
    cfg = ("sobol", 0, 16)
    jray, _, _, jpid, jsidx = jpath.camera_rays_for_pixels(
        jc, W, H, JCfg(*cfg), jnp.arange(W * H, dtype=jnp.uint32),
        jnp.uint32(SIDX), jproj.generate_rays)
    jcv = jb.generate_camera_subpath(js, jray, jpid, jsidx, JCfg(*cfg), T,
                                     jc, W, H)
    jlv = jb.generate_light_subpath(js, jpid, jsidx, JCfg(*cfg), S)
    jL, jspl = jb.connect_strategies(js, jc, W, H, jcv, jlv, JCfg(*cfg), T,
                                     jray.wavelength)
    jw = {(s, t): np.asarray(jb._mis_weight(js, jcv if t > 1 else jcv[:1],
                                            jlv, s, t, jc, W, H))
          for s, t in _strategy_list()}
    ts, tc = port_scene(js), port_camera(jc)
    ray, _, _, pid, sidx = tpath.camera_rays_for_pixels(
        tc, W, H, TCfg(*cfg), torch.arange(W * H), SIDX)
    tcv = tb.generate_camera_subpath(ts, ray, pid, sidx, TCfg(*cfg), T, tc,
                                     W, H)
    tlv = tb.generate_light_subpath(ts, pid, sidx, TCfg(*cfg), S)
    tL, tspl = tb.connect_strategies(ts, tc, W, H, tcv, tlv, TCfg(*cfg), T,
                                     ray.wavelength)
    tw = {(s, t): tb.mis_weight(ts, tcv if t > 1 else tcv[:1], tlv, s, t, tc,
                                W, H).numpy()
          for s, t in _strategy_list()}
    return dict(jcv=jcv, jlv=jlv, jL=jL, jspl=jspl, jw=jw, tcv=tcv, tlv=tlv,
                tL=tL, tspl=tspl, tw=tw)


def _share_close(t, j, rtol=1e-4, atol=1e-7):
    """The share of lanes (rows) whose values all lie within rtol."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    ok = np.abs(t - j) <= rtol * np.abs(j) + atol
    return ok.reshape(ok.shape[0], -1).all(-1).mean()


def test_subpath_vertices_like_jax(box):
    for jv, tv in zip(box["jcv"] + box["jlv"], box["tcv"] + box["tlv"]):
        valid = np.asarray(jv.valid)
        for flag in ("valid", "delta") + (("connectible",) if hasattr(
                jv, "connectible") else ()):
            same = np.asarray(getattr(jv, flag)) == getattr(tv, flag).numpy()
            assert same.mean() >= 0.97, flag
        p_ok = np.abs(tv.p.numpy() - np.asarray(jv.p)).max(-1) <= 1e-5
        assert p_ok[valid].mean() >= 0.97
        for f in ("beta", "pdf_fwd", "pdf_rev"):
            t_, j_ = getattr(tv, f).numpy()[valid], np.asarray(
                getattr(jv, f))[valid]
            assert _share_close(t_, j_) >= 0.97, f
    assert np.asarray(box["jcv"][1].valid).mean() > 0.9


def _grazing(a, b):
    """Lanes whose connection a -> b grazes either end's surface."""
    d = b.p.numpy() - a.p.numpy()
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    out = np.zeros(d.shape[0], bool)
    for v in (a, b):
        if v.is_surface is not False:
            out |= np.abs((v.ns.numpy() * d).sum(-1)) < 1e-3
    return out


def test_mis_weights_like_jax(box):
    tcv, tlv = box["tcv"], box["tlv"]
    for (s, t), jw in box["jw"].items():
        live = np.ones(W * H, bool)
        for v in tcv[:t] + tlv[:s]:
            live &= v.valid.numpy()
        if s > 0:
            live &= ~_grazing(tcv[t - 1], tlv[s - 1])
        tw = box["tw"][(s, t)]
        assert np.isfinite(tw).all() and (tw >= 0).all() and (tw <= 1).all()
        assert live.sum() > 0 or s + t == T, (s, t)
        if live.any():
            assert _share_close(tw[live], jw[live]) >= 0.97, (s, t)
            assert np.allclose(tw[live], jw[live], rtol=1e-2,
                               atol=1e-7), (s, t)


def test_connect_strategies_like_jax(box):
    jL, tL = np.asarray(box["jL"]), box["tL"].numpy()
    assert jL.sum() > 0 and _share_close(tL, jL) >= 0.97
    assert abs(tL.sum() / jL.sum() - 1) < 1e-4
    assert len(box["tspl"]) == len(box["jspl"]) == S - 1
    for (jp, jl), (tp, tl) in zip(box["jspl"], box["tspl"]):
        jl, tl = np.asarray(jl), tl.numpy()
        assert _share_close(tl, jl) >= 0.97
        assert abs(tl.sum() - jl.sum()) <= 1e-4 * max(jl.sum(), 1e-6)
        lit = jl.sum(-1) > 0
        assert np.abs(tp.numpy()[lit] - np.asarray(jp)[lit]).max() <= 1e-3
    assert sum(float(tl.sum()) for _, tl in box["tspl"]) > 0


def test_strategy_order_counts_the_any_hit_calls():
    """tb.strategies lists connect_strategies' any-hit calls in their
    order: at depth 5, 5 s=1, 10 s>=2 and 5 t=1."""
    st = tb.strategies(7, 6, 7, 1)
    assert len(st) == 20
    assert sum(1 for k in st if k[0] == "s1") == 5
    assert sum(1 for k in st if k[0] == "t1") == 5
    assert tb.strategies(T, S, T, 0) == [(2, 2), ("t1", 2), ("t1", 3)]


def test_hair_vertex_shades_in_coordinate_system():
    """Reference-side issue (z), reproduced: a bdpt vertex on a hair
    fiber evaluates its BSDF in geom.coordinate_system(ns), as pbrt_tpu's
    _Vertex.f_world does, and not in the fiber frame of
    bsdf.shading_frame that path, lighttracer and sppm use."""
    src = CURVES % '"float eumelanin" [0.3]'
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    n = 32
    xs = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    o = np.stack([xs, np.tile([-0.6, 0.0, 0.4, 0.7], n // 4), -4 + 0 * xs],
                 -1).astype(np.float32)
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (n, 1))
    jh = jisect.intersect_full(jj.scene, jgeom.Ray.make(jnp.asarray(o),
                                                        jnp.asarray(d)))
    th = tisect.intersect_full(tj.scene, tgeom.Ray.make(
        torch.as_tensor(o), torch.as_tensor(d)))
    on = th.valid & (th.material >= 0)
    assert int(on.sum()) > 8
    wi = tgeom.normalize(torch.tensor([[0.3, 0.8, -0.5]]).expand(n, 3))

    def vertex(pkg, h):
        return pkg.Vertex(h.p, h.ng, h.ns, h.wo, h.uv, h.material, None,
                          torch.ones(n), None, h.valid) if pkg is tb else \
            jb._Vertex(h.p, h.ng, h.ns, h.wo, h.uv, h.material, None,
                       jnp.ones(n), None, h.valid)
    tv, jv = vertex(tb, th), vertex(jb, jh)
    f_t = tv.f_world(tj.scene, wi).numpy()
    f_j = np.asarray(jv.f_world(jj.scene, jnp.asarray(wi.numpy())))
    m = on.numpy()
    assert np.allclose(f_t[m], f_j[m], rtol=1e-4, atol=1e-6)
    # the coordinate_system frame, not the fiber frame
    ss, ts_ = tgeom.coordinate_system(th.ns)
    mat = tbsdf.gather_materials(tj.scene, th.material, uv=th.uv, p=th.p)
    f_cs = tbsdf.eval_f(mat, tgeom.world_to_frame(ss, ts_, th.ns, th.wo),
                        tgeom.world_to_frame(ss, ts_, th.ns, wi)).numpy()
    assert np.array_equal(f_t[m], f_cs[m])
    fs, ft = tbsdf.shading_frame(tj.scene, th)
    f_fiber = tbsdf.eval_f(mat, tgeom.world_to_frame(fs, ft, th.ns, th.wo),
                           tgeom.world_to_frame(fs, ft, th.ns, wi)).numpy()
    assert np.abs(f_fiber[m] - f_t[m]).max() > 1e-3 * np.abs(f_t[m]).max()


def test_padded_lanes_splat_pixel_zeros_light_subpath(jitted):
    """Reference-side issue (aa), reproduced: a pass's padding lanes
    (pixel ids >= W*H, when W*H is not a multiple of the pass) take pixel
    0's samples, so their light subpaths are pixel 0's and their t=1
    strategies splat it again; only the camera samples are masked.  On
    the area-light box at 8x8 with the last 32 lanes padded, each padded
    lane's splats equal lane 0's in both packages."""
    js = _box("area")
    jc = jproj.make_perspective(
        jtfm.look_at([0, 0, -1.9], [0, 0, 1], [0, 1, 0]), 40.0, W, H)
    ids = np.arange(W * H, dtype=np.int64)
    ids[32:] = 0xFFFFFFFF
    cfg = ("sobol", 0, 16)
    jray, _, _, jpid, jsidx = jpath.camera_rays_for_pixels(
        jc, W, H, JCfg(*cfg), jnp.asarray(ids, jnp.uint32), jnp.uint32(3),
        jproj.generate_rays)
    jcv = jb.generate_camera_subpath(js, jray, jpid, jsidx, JCfg(*cfg), T,
                                     jc, W, H)
    jlv = jb.generate_light_subpath(js, jpid, jsidx, JCfg(*cfg), S)
    _, jspl = jb.connect_strategies(js, jc, W, H, jcv, jlv, JCfg(*cfg), T,
                                    jray.wavelength)
    ts, tc = port_scene(js), port_camera(jc)
    ray, _, _, pid, sidx = tpath.camera_rays_for_pixels(
        tc, W, H, TCfg(*cfg), torch.as_tensor(ids), 3)
    tcv = tb.generate_camera_subpath(ts, ray, pid, sidx, TCfg(*cfg), T, tc,
                                     W, H)
    tlv = tb.generate_light_subpath(ts, pid, sidx, TCfg(*cfg), S)
    _, tspl = tb.connect_strategies(ts, tc, W, H, tcv, tlv, TCfg(*cfg), T,
                                    ray.wavelength)
    assert not tcv[1].valid[32:].any()
    for (_, jl), (_, tl) in zip(jspl, tspl):
        for sl in (np.asarray(jl), tl.numpy()):
            assert np.array_equal(sl[32:], np.broadcast_to(sl[:1],
                                                           sl[32:].shape))
    assert max(float(tl[0].sum()) for _, tl in tspl) > 0


def test_light_side_batches_are_recorded():
    """kernel_workloads.bdpt_batches and photon_batch record the K1 / K2
    batches of a bdpt pass and an SPPM iteration at cornell_bench.pbrt's
    16x16: rays leaving the light (closest-hit, all live), the (2,2) and
    (2,1) connections (any-hit, some lanes dead) and the first photons."""
    import os
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    from pbrt_tpu_torch.tools import pbrt as tcli
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "cornell_bench.pbrt")
    job = TAPI("cpu").parse_string(open(bench).read(),
                                   os.path.dirname(bench))
    cam = tcli.build_camera(job, 16, 16, "cpu")
    cfg = TCfg("sobol", 0, 4)
    b = kw.bdpt_batches(job.scene, cam, cfg, 16, 16, 256, 3)
    r16, tmax, _ = b["light"]
    assert r16.shape == (256, 16) and (tmax > 0).all()
    assert not (r16[:, 12] > 0.5).any()
    for k in ("s2t2", "t1"):
        r16, tmax, _ = b[k]
        assert (r16[:, 12] > 0.5).all() and 0 < (tmax > 0).sum() < 256
    r16, tmax, _ = kw.photon_batch(job.scene, cfg, 256, 3)
    assert r16.shape == (256, 16) and (tmax > 0).all()
