"""The port's metadata and spectralpath integrators, their dispatch, the
CLI's `--sampler refsobol`, and the dense intersector's scene cap (the
threshold of the BVH / kd-tree route), each against pbrt_tpu on the same
inputs where pbrt_tpu has a twin.

Tolerances, each with the figure measured on the CPU:
- metadata, all four strategies on scenes/metadata_depth.pbrt, per ray
  on the same camera rays: ids equal, depth within 1e-5 relative
  (measured 5.0e-6), coordinates within 1e-4 absolute (measured 1.8e-5):
  both on the sphere's lanes, whose t the two packages solve in f32 by
  different formulas (pbrt_tpu's BVH leaf test, the port's sphere
  pre-test); triangle lanes are equal;
- the metadata reference gate, tests/test_tools.py's thresholds: centre
  pixel within 5e-3 (measured 5.2e-4), median 6x6-block error < 1e-2
  (3.7e-3), largest < 3e-2 (0.0216);
- spectralpath, Cornell 16x16 at 2 spp, 4 bands, depth 5, against
  pbrt_tpu's: test_torch_path.py's tolerances, image mean within 1% and
  >= 95% of pixels within 1e-2 relative (measured 1.2e-7 and 1.0); with
  one band it is the path integrator, bit for bit.
pbrt_tpu runs eagerly in these tests, its trace_paths jitted once for the four
bands' equal shapes.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import metadata as jmeta
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.integrators import spectralpath as jspec
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu.tools.pbrt import build_camera as jbuild_camera
from pbrt_tpu_torch.core.transform import translate
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.integrators import dispatch as tdispatch
from pbrt_tpu_torch.integrators import metadata as tmeta
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import refpath as tref
from pbrt_tpu_torch.integrators import spectralpath as tspec
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lighttracer import jax_light_render
from test_torch_volpath import assert_renders_alike

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = os.path.join(ROOT, "scenes", "metadata_depth.pbrt")
BENCH = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")
REFRNG = os.path.join(ROOT, "scenes", "cornell_refrng.pbrt")
META_REF = os.path.join(ROOT, "tests", "data", "ref_metadata_depth.npz")
DEV = "cpu"


def _frac_close(a, b, rtol=1e-2):
    return (np.abs(a - b) <= rtol * np.abs(b)).mean()


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meta_jobs():
    return jparse(META), tparse(META, device=DEV)


@pytest.mark.parametrize("strategy", ["depth", "material", "mesh",
                                      "coordinates"])
def test_metadata_matches_jax(meta_jobs, strategy):
    jj, tj = meta_jobs
    assert tj.integrator_kind == "metadata"
    assert tj.integrator_params["strategy"] == "depth"
    W, H = tj.film_width, tj.film_height
    ids = np.arange(W * H)
    cfg_j, cfg_t = JCfg("sobol", 0, 1), TCfg("sobol", 0, 1)
    jray, _, _, jpid, jsid = jpath.camera_rays_for_pixels(
        jbuild_camera(jj, W, H), W, H, cfg_j, jnp.asarray(ids, jnp.uint32),
        0, jproj.generate_rays)
    tray, _, _, tpid, tsid = tpath.camera_rays_for_pixels(
        tcli.build_camera(tj, W, H, DEV), W, H, cfg_t, torch.from_numpy(ids),
        0)
    jout = np.asarray(jmeta.make_trace_metadata(strategy)(
        jj.scene, jray, jpid, jsid, cfg_j))
    tout = tmeta.make_trace_metadata(strategy)(tj.scene, tray, tpid, tsid,
                                               cfg_t).numpy()
    assert tout.shape == jout.shape == (W * H, 31)
    if strategy == "coordinates":
        np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    hit = jout[:, 0] != 0
    assert 0.3 < hit.mean() < 1.0
    if strategy == "mesh":                      # the floor and the sphere
        assert len(np.unique(tout[hit, 0])) == 2
    if strategy == "coordinates":
        assert (tout[:, 3:] == 0).all()
    else:
        assert (tout == tout[:, :1]).all()
    with pytest.raises(ValueError):
        tmeta.make_trace_metadata("normals")


def test_metadata_reference_gate_through_run_job(meta_jobs):
    """tests/test_tools.py::test_metadata_depth_vs_reference's gate, on
    the port's run_job; the metadata integrator counts no rays, so stats
    stays without "rays"."""
    _, tj = meta_jobs
    ref = np.load(META_REF)["depth"]
    stats = {}
    film, _ = tcli.run_job(tj, stats=stats)
    assert stats == {}
    ours = tfilm.develop_spectral(film).numpy()[:, :, 0]
    assert ours.shape == ref.shape == (48, 48)
    assert abs(ours[24, 24] / ref[24, 24] - 1.0) < 5e-3
    bs, nb = 6, 8
    bm_r = np.median(ref.reshape(nb, bs, nb, bs), axis=(1, 3))
    bm_o = np.median(ours.reshape(nb, bs, nb, bs), axis=(1, 3))
    sel = bm_r > 1e-3
    rel = np.abs(bm_o[sel] - bm_r[sel]) / bm_r[sel]
    assert np.median(rel) < 1e-2, np.median(rel)
    assert rel.max() < 3e-2, rel.max()


# ---------------------------------------------------------------------------
# spectralpath
# ---------------------------------------------------------------------------

SW = SH = 16
SPP = 2


@pytest.fixture(scope="module")
def cornell():
    js, jcam = jflag.cornell(tessellate=True)
    ts, tcam = tflag.cornell(device=DEV)
    return js, jcam(SW, SH), ts, tcam(SW, SH)


def test_band_slices_match_jax():
    for n in (1, 3, 4, 7):
        assert tspec.band_slices(n) == jspec.band_slices(n)


def test_spectralpath_matches_jax(cornell):
    js, jc, ts, tc = cornell
    cfg_j, cfg_t = JCfg("sobol", 0, SPP), TCfg("sobol", 0, SPP)
    ids = np.arange(SW * SH)
    jf = jfilm.make_film(SW, SH, "box")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpath, "sample_dim",
                   jax.jit(jsamp.sample_dim, static_argnums=0))
        mp.setattr(jpath, "trace_paths", jax.jit(
            jpath.trace_paths, static_argnums=4,
            static_argnames=("max_depth",)))
        trace = jspec.make_trace_spectral(num_ca_bands=4)
        for s in range(SPP):
            ray, w, pf, pid, sidx = jpath.camera_rays_for_pixels(
                jc, SW, SH, cfg_j, jnp.asarray(ids, jnp.uint32), s,
                jproj.generate_rays)
            jf = jfilm.add_samples(jf, pf, trace(js, ray, pid, sidx, cfg_j,
                                                 max_depth=5), w)
    tf = tpath.render(ts, tc, tfilm.make_film(SW, SH, "box", device=DEV),
                      cfg_t, SPP, max_depth=5,
                      trace_fn=tspec.make_trace_spectral(4, camera=tc))
    ji = np.asarray(jfilm.develop_spectral(jf))
    ti = tfilm.develop_spectral(tf).numpy()
    assert np.isfinite(ti).all() and (ti >= 0).all() and ti.mean() > 0
    assert abs(ti.mean() / ji.mean() - 1) < 0.01
    assert _frac_close(ti.sum(-1), ji.sum(-1)) >= 0.95
    # one band: the path integrator itself
    one = tpath.render(ts, tc, tfilm.make_film(SW, SH, "box", device=DEV),
                       cfg_t, 1, max_depth=5,
                       trace_fn=tspec.make_trace_spectral(1))
    plain = tpath.render(ts, tc, tfilm.make_film(SW, SH, "box", device=DEV),
                         cfg_t, 1, max_depth=5)
    assert torch.equal(one.weighted, plain.weighted)


def test_spectralpath_waits_for_lens_cameras(tmp_path):
    """Lens cameras are ported: spectralpath regenerates their rays per
    band (tests/test_torch_lens.py holds the render against pbrt_tpu's);
    it needs the film's size for that, and a camera of no ported kind
    still raises."""
    from pbrt_tpu_torch.cameras import lens as tlens
    from pbrt_tpu_torch.core import transform as ttfm
    dat = tmp_path / "singlet.dat"
    dat.write_text("50 4 1.5 20\n-50 0 1 20\n")
    cam = tlens.build_lens_camera(
        "realistic", ttfm.Transform(), tlens.read_dat_lens(str(dat)),
        focus_distance=1e6, device=DEV)
    assert callable(tspec.make_trace_spectral(4, camera=cam, width=8,
                                              height=8))
    with pytest.raises(ValueError, match="width and height"):
        tspec.make_trace_spectral(4, camera=cam)
    with pytest.raises(NotImplementedError, match="lens"):
        tspec.make_trace_spectral(4, camera=object())


def test_dispatch_routes_the_ported_integrators(meta_jobs, cornell):
    """metadata, spectralpath and path through render_with_integrator
    (path alone counts rays), and bdpt on cornell_bench.pbrt (8x8, 1 spp,
    depth 2) against pbrt_tpu's run_job: image mean within 1e-4, >= 97%
    of pixels within 1e-3 (test_torch_volpath's tolerance; measured
    equal to 2.4e-7), its t=1 strategies in the splat buffer and no rays
    counted."""
    _, tj = meta_jobs
    _, _, ts, tc = cornell
    film, n = tdispatch.render_with_integrator(
        tj, tcli.build_camera(tj, 48, 48, DEV),
        tfilm.make_film(48, 48, device=DEV), TCfg("sobol", 0, 1), 1, 5,
        count_rays=True)
    assert n is None and film.weight.sum() > 0
    for kind, params, counted in (("spectralpath", {"numCABands": 2}, False),
                                  ("path", {}, True)):
        job = type(tj)(**{**tj.__dict__, "scene": ts,
                          "integrator_kind": kind,
                          "integrator_params": {"maxdepth": 2, **params}})
        film, n = tdispatch.render_with_integrator(
            job, tc, tfilm.make_film(SW, SH, device=DEV), TCfg("sobol", 0, 1),
            1, 2, count_rays=True)
        assert (n is not None) == counted and film.weighted.sum() > 0, kind
    text = open(BENCH).read()
    jj = JAPI().parse_string(text, os.path.dirname(BENCH))
    job = TAPI(DEV).parse_string(text, os.path.dirname(BENCH))
    for j in (jj, job):
        j.integrator_kind = "bdpt"
        j.film_width = j.film_height = 8
    film, n = tdispatch.render_with_integrator(
        job, tcli.build_camera(job, 8, 8, DEV),
        tfilm.make_film(8, 8, job.filter_name, device=DEV),
        TCfg(job.sampler_kind, 0, 1), 1, 2, count_rays=True)
    assert n is None and float(film.splat.sum()) > 0
    assert_renders_alike(tfilm.develop_spectral(film).numpy(),
                         jax_light_render(jj, 1, 2))


# ---------------------------------------------------------------------------
# the CLI's matched-RNG mode
# ---------------------------------------------------------------------------

def test_cli_refsobol_writes_the_render_ref_dat(tmp_path):
    """`--sampler refsobol --cpu` on cornell_refrng.pbrt with its film cut
    to 16x16 and 1 spp: the .dat holds render_ref's film, bit for bit."""
    text = open(REFRNG).read()
    text = text.replace('"integer xresolution" [128] "integer yresolution" '
                        '[128]', '"integer xresolution" [16] '
                        '"integer yresolution" [16]')
    text = text.replace('"integer pixelsamples" [32]',
                        '"integer pixelsamples" [1]')
    scene = tmp_path / "refrng16.pbrt"
    scene.write_text(text)
    out = tmp_path / "out.exr"
    assert tcli.main([str(scene), "--cpu", "--quiet", "--sampler",
                      "refsobol", "-o", str(out)]) == 0
    dat, flag = tio.read_dat(str(tmp_path / "out.dat"))
    job = tparse(str(scene), device=DEV)
    assert (job.film_width, job.spp) == (16, 1)
    film = tref.render_ref(job.scene, tcli.build_camera(job, 16, 16, DEV),
                           tfilm.make_film(16, 16, job.filter_name,
                                           device=DEV), 16, 16, 1)
    want = film.raw.numpy().astype(np.float64) * job.film_scale
    assert flag == "v3" and dat.shape == want.shape == (16, 16, 31)
    assert np.array_equal(dat, want)
    assert np.isfinite(dat).all() and (dat >= 0).all() and dat.mean() > 0
    with pytest.raises(ValueError, match="override"):
        tcli.run_job(job, sampler_override="halton")


# ---------------------------------------------------------------------------
# the dense intersector's cap
# ---------------------------------------------------------------------------

def test_dense_cap_routes_to_the_bvh():
    """Above 300,000 static primitives (150,000 with an animated mesh)
    pbrt_tpu leaves the dense kernels for its BVH or kd-tree
    (pbrt_tpu/scene/ir.py:900); so does the port: the caps are the
    route's thresholds, and a build over them makes no dense table."""
    assert (tir.MAX_DENSE_PRIMS, tir.MAX_MOTION_PRIMS) == (300_000, 150_000)
    assert tir.dense_route(tir.MAX_DENSE_PRIMS, animated=False)
    assert tir.dense_route(tir.MAX_MOTION_PRIMS, animated=True)
    assert not tir.dense_route(tir.MAX_DENSE_PRIMS + 1, animated=False)
    assert not tir.dense_route(tir.MAX_MOTION_PRIMS + 1, animated=True)
    assert not tir.dense_route(0, animated=False)
    for n, animated in ((tir.MAX_DENSE_PRIMS + 1, False),
                        (tir.MAX_MOTION_PRIMS + 1, True)):
        b = tir.SceneBuilder()
        m = b.add_material(tir.MaterialSpec())
        move = translate(0.25, 0.0, 0.0) if animated else None
        b.add_triangle_mesh(np.eye(3), np.zeros((n, 3), np.int64)
                            + [0, 1, 2], m, object_to_world1=move)
        s = b.build(device=DEV)
        assert s.prim_type.shape[0] == n and s.has_animated_mesh == animated
        assert not s.use_dense and not s.use_kd and not s.dense_motion
        assert s.dense_w is None and s.dense_cb is None
        assert s.bvh_packed.shape == (s.n_nodes, 8) and s.n_nodes > 1
        assert s.tri_packed.shape == (n, 12)
        assert tcli.route_name(s) == "BVH"


# ---------------------------------------------------------------------------
# the path integrator's light strategies and lights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,strategy", [
    ("uniform", "uniform"), ("power", "power"), ("spatial", "spatial"),
    ("all", "spatial"), ("bogus", "spatial")])
def test_dispatch_maps_the_light_strategy(meta_jobs, monkeypatch, name,
                                          strategy):
    """lightsamplestrategy reaches trace_paths; any other name is
    "spatial", as in pbrt_tpu/integrators/dispatch.py:20-22 ("all" is
    directlighting's)."""
    _, tj = meta_jobs
    seen = {}
    monkeypatch.setattr(tpath, "render", lambda *a, **k: seen.update(k))
    for kind in ("path", "spectralpath"):
        job = type(tj)(**{**tj.__dict__, "integrator_kind": kind,
                          "integrator_params": {"lightsamplestrategy":
                                                name}})
        tdispatch.render_with_integrator(job, None, tfilm.make_film(
            4, 4, device=DEV), TCfg("sobol", 0, 1), 1, 2)
        want = {"light_strategy": strategy} if kind == "path" else {}
        assert seen["trace_kwargs"] == want, kind


def _one_light_render(text, n, spp, depth, strategy="uniform"):
    job = TAPI(DEV).parse_string(text)
    cam = tcli.build_camera(job, n, n, DEV)
    film = tpath.render(job.scene, cam, tfilm.make_film(n, n, device=DEV),
                        TCfg("sobol", 0, spp), spp, max_depth=depth,
                        trace_kwargs={"light_strategy": strategy})
    return tfilm.develop_spectral(film).numpy().mean(-1)


FURNACE = """LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
WorldBegin
LightSource "infinite" "float L" [1]
Material "matte" "float Kd" [{kd}]
Shape "sphere" "float radius" [1]
WorldEnd
"""


def test_furnace_on_the_cpu():
    """A convex matte sphere under a constant infinite light reflects
    albedo x Le (tests/test_integrators.py:43-56, same limits): albedo
    0.5 gives 0.5 at the centre, a white one is invisible."""
    half = _one_light_render(FURNACE.format(kd=0.5), 24, 8, 5)
    assert abs(half[8:16, 8:16].mean() - 0.5) < 0.02
    white = _one_light_render(FURNACE.format(kd=1.0), 24, 8, 8)
    assert abs(white.mean() - 1.0) < 0.02


def test_point_light_over_a_plane_on_the_cpu():
    """rho / pi I cos / r^2 under a point light 1 above a Lambertian plane
    (tests/test_integrators.py:68-95, same limits), through the parser's
    LightSource "point"."""
    text = """LookAt 0 0 3  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
WorldBegin
LightSource "point" "float I" [10] "point from" [0 0 1]
Material "matte" "float Kd" [.6]
Shape "trianglemesh" "point P" [-50 -50 0 50 -50 0 50 50 0 -50 50 0]
    "integer indices" [0 1 2 2 3 0]
WorldEnd
"""
    img = _one_light_render(text, 24, 8, 2)
    centre = 0.6 / np.pi * 10.0
    assert abs(img[11:13, 11:13].mean() / centre - 1) < 0.02
