"""The port's lighttracer (integrators/lighttracer.py), the film's splat
buffer and the light-side integrators through the CLI, against pbrt_tpu
on the CPU.

- sample_le and camera_we_splat lane by lane on the same inputs, on a
  scene with a mesh area light, a sphere light, a point and a spot light:
  every lane within 1e-5 relative and absolute of pbrt_tpu's (the same
  f32 formulas, rounded apart where the two take another cosine or
  inverse; measured 2.3e-5 absolute on Le values up to 5);
- one photon pass's splat buffer (tests/test_lighttracer.py's scene at
  16x16, depth 3, 4,096 photons, the same counter-based samples): the
  buffer's sum within 1e-4 relative of pbrt_tpu's and >= 97% of pixels
  within 1e-3 (photons that take another triangle at an edge of the two
  intersectors diverge), with `weighted` staying zero;
- the four light-side integrators render through `run_job` on the CPU,
  finite, non-negative and non-black; dispatch folds lighttracer's and
  bdpt's splat scale into film.splat (exactly), which develop adds;
- reference-side issue (x): a lighttracer `.dat` is all zeros (the CLI
  writes `raw`; the light tracer fills only the splat buffer), its EXR is
  not; issue (y): the warnings name the ignored iterations and
  mutationsperpixel.
"""
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import bdpt as jb
from pbrt_tpu.integrators import lighttracer as jlt
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.integrators import sppm as jsppm
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu_torch.cameras import projective as tproj
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.integrators import dispatch
from pbrt_tpu_torch.integrators import lighttracer as tlt
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from test_lighttracer import _scene as light_quad_scene
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")
FOUR_LIGHTS = """LookAt 0 0 3  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "trianglemesh" "point P" [-5 -5 0 5 -5 0 5 5 0 -5 5 0]
    "integer indices" [0 1 2 2 3 0]
LightSource "point" "rgb I" [1 2 3] "point from" [1 0.5 1]
LightSource "spot" "rgb I" [5 5 5] "point from" [0 0 2] "point to" [0.3 0 0]
    "float coneangle" [30] "float conedeltaangle" [5]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [6 4 2]
Translate -1.2 0.8 0.6
Shape "sphere" "float radius" [0.15]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "rgb L" [1 3 5]
Shape "trianglemesh" "point P" [-1 -1 2 1 -1 2 1 1 2 -1 1 2.5]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
WorldEnd
"""
CAM_FIELDS = ("cam_to_world", "raster_to_camera", "camera_to_raster",
              "lens_radius", "focal_distance", "shutter_open",
              "shutter_close")


def jax_light_render(jj, spp, depth):
    """pbrt_tpu's run_job of job jj with a light-side integrator, its
    drivers eager around its jitted intersect, material, light and
    sampler functions (test_torch_volpath.jax_render's way); the
    developed image [H,W,31], splats included."""
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        sd = jit(jsamp.sample_dim, static_argnums=(0, 3))
        for mod in (jpath, jlt, jb, jsppm):
            mp.setattr(mod, "sample_dim", sd)
        le = jit(jlt.sample_le)
        mp.setattr(jlt, "sample_le", le)
        mp.setattr(jsppm, "sample_le", le)
        for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                     "bump_shading_normal", "shading_frame"):
            mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
        for name in ("sample_li", "pdf_li_area", "area_le", "env_le",
                     "delta_emit_scale"):
            mp.setattr(jlights, name, jit(getattr(jlights, name)))
        mp.setattr(jisect, "occluded", jit(jisect.occluded))
        mp.setattr(jisect, "trace_pair", jit(jisect.trace_pair))
        mp.setattr(jisect, "intersect_full", jit(
            jisect.intersect_full, static_argnames=("presorted",)))
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        film, _ = jcli.run_job(jj, spp=spp, max_depth=depth, quiet=True)
    return np.asarray(jfilm.develop_spectral(film))


def port_camera(jc):
    return tproj.camera_from_jax({k: np.asarray(getattr(jc, k))
                                  for k in CAM_FIELDS}, "cpu")


def port_scene(js):
    return tir.scene_from_jax(
        {k: np.asarray(getattr(js, k)) for k in tir.JAX_ARRAYS},
        {k: getattr(js, k) for k in tir.JAX_STATICS}, "cpu")


@pytest.fixture(scope="module")
def four_lights():
    jj, tj = JAPI().parse_string(FOUR_LIGHTS), TAPI("cpu").parse_string(
        FOUR_LIGHTS)
    assert set(tj.scene.light_kinds) == {tir.LIGHT_POINT, tir.LIGHT_SPOT,
                                         tir.LIGHT_AREA}
    assert tj.scene.has_mesh_lights and tj.scene.has_sphere_lights
    return jj, tj


def test_sample_le_lane_by_lane(four_lights):
    jj, tj = four_lights
    B = 4096
    rs = np.random.RandomState(0)
    l = rs.randint(0, tj.scene.n_lights, B)
    u = rs.rand(4, B).astype(np.float32)
    jo = jax.jit(jlt.sample_le)(jj.scene, jnp.asarray(l, jnp.int32),
                                *map(jnp.asarray, u))
    to = tlt.sample_le(tj.scene, torch.as_tensor(l),
                       *map(torch.as_tensor, u))
    for a, b in zip(jo, to):
        assert np.allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    # every kind was drawn, and the spot's falloff zeroed some lanes
    assert np.isin(np.arange(4), l).all()
    assert (to[2].sum(-1) == 0).any() and (to[3] > 0).all()


def test_camera_we_splat_lane_by_lane(four_lights):
    jj, tj = four_lights
    W, H = 24, 16
    jc = jproj.make_perspective(jtfm.look_at([0, 0, 3], [0, 0, 0],
                                             [0, 1, 0]), 60.0, W, H)
    tc = port_camera(jc)
    rs = np.random.RandomState(1)
    p = rs.uniform(-3, 3, (2048, 3)).astype(np.float32)
    jp, jw, jv = jlt.camera_we_splat(jc, W, H, jnp.asarray(p), None, None)
    frame = tlt.camera_frame(tc, W, H)
    tp, tw, tv = tlt.camera_we_splat(tc, W, H, torch.as_tensor(p), frame)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert 0.05 < tv.float().mean() < 0.95
    v = tv.numpy()
    assert np.abs(np.asarray(jp)[v] - tp.numpy()[v]).max() <= 1e-3
    assert np.allclose(np.asarray(jw)[v], tw.numpy()[v], rtol=1e-5)


def test_light_pass_splats_like_jax():
    """One photon pass at depth 3 into the splat buffer; `weighted`,
    `weight` and `raw` stay zero."""
    W = H = 16
    js = light_quad_scene()
    jc = jproj.make_perspective(
        jtfm.look_at([0, -6, 2.5], [0, 0, 1], [0, 0, 1]), 40.0, W, H)
    B = 4096
    cfg = ("independent", 7, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlt, "sample_dim", jax.jit(jsamp.sample_dim,
                                              static_argnums=0))
        jpass = jax.jit(jlt.make_trace_lighttracer(jc, W, H, 1),
                        static_argnums=(4, 5))
        jf = jpass(js, jfilm.make_film(W, H), jnp.arange(B, dtype=jnp.uint32),
                   jnp.full(B, 1, jnp.uint32), JCfg(*cfg), 3)
    ts, tc = port_scene(js), port_camera(jc)
    tf = tfilm.make_film(W, H, device="cpu")
    pid = torch.arange(B)
    tlt.make_trace_lighttracer(tc, W, H)(ts, tf, pid, torch.ones_like(pid),
                                         TCfg(*cfg), 3)
    for buf in (tf.weighted, tf.weight, tf.raw):
        assert float(buf.abs().sum()) == 0.0
    ts_, js_ = tf.splat.numpy().sum(-1), np.asarray(jf.splat).sum(-1)
    assert js_.sum() > 0 and (js_ > 0).mean() > 0.5
    assert abs(ts_.sum() / js_.sum() - 1) < 1e-4
    assert (np.abs(ts_ - js_) <= 1e-3 * np.abs(js_)).mean() >= 0.97


@pytest.mark.parametrize("kind", dispatch.LIGHT_SIDE)
def test_light_side_integrators_render_through_the_cli(kind):
    """`Integrator "<kind>"` in cornell_bench.pbrt (8x8, 1 spp, depth 2;
    mlt with 64 chains and 256 bootstrap paths) through run_job."""
    text = open(BENCH).read().replace(
        'Integrator "path" "integer maxdepth" [5]',
        f'Integrator "{kind}" "integer maxdepth" [2] "integer chains" [64]'
        ' "integer bootstrapsamples" [256]')
    job = TAPI("cpu").parse_string(text, os.path.dirname(BENCH))
    job.film_width = job.film_height = 8
    assert job.integrator_kind == kind
    film, _ = tcli.run_job(job, spp=1)
    img = tfilm.develop_spectral(film)
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert float(img.mean()) > 0


def test_lighttracer_dat_is_all_zeros(tmp_path):
    """Reference-side issue (x), reproduced: the light tracer's image is
    all splats, and the .dat holds the film's raw sums."""
    job = TAPI("cpu").parse_string(open(BENCH).read(), os.path.dirname(BENCH))
    job.film_width = job.film_height = 8
    job.integrator_kind = "lighttracer"
    film, _ = tcli.run_job(job, spp=1, max_depth=2)
    out = str(tmp_path / "lt.exr")
    tcli.write_outputs(job, film, out, quiet=True)
    dat, _ = tio.read_dat(str(tmp_path / "lt.dat"))
    assert np.all(dat == 0)
    rgb = tio.read_image(out)
    assert np.isfinite(rgb).all() and rgb.max() > 0


def test_ignored_parameters_warn(caplog):
    """Reference-side issue (y): SPPM's iterations and MLT's
    mutationsperpixel are parsed and reach no integrator; the warning
    names the ignored value."""
    text = open(BENCH).read()
    for kind, param, value in (("sppm", "iterations", 7),
                               ("mlt", "mutationsperpixel", 5)):
        job = TAPI("cpu").parse_string(text.replace(
            'Integrator "path" "integer maxdepth" [5]',
            f'Integrator "{kind}" "integer maxdepth" [1] '
            f'"integer {param}" [{value}] "integer chains" [16] '
            '"integer bootstrapsamples" [64]'), os.path.dirname(BENCH))
        assert job.integrator_params[param] == value
        job.film_width = job.film_height = 4
        with caplog.at_level(logging.WARNING, logger="pbrt_tpu_torch"):
            tcli.run_job(job, spp=1)
        assert f"{param} {value} is ignored" in caplog.text


@pytest.mark.parametrize("kind", dispatch.LIGHT_SIDE)
def test_launch_components_counts_a_light_side_unit(kind):
    """launch_components counts one unit of a light-side integrator (a
    photon pass, a bdpt pass, an SPPM iteration, an MLT step) by
    component; an SPPM iteration's photon gather is its own."""
    from pbrt_tpu_torch.tools import launch_components
    job = TAPI("cpu").parse_string(open(BENCH).read(), os.path.dirname(BENCH))
    job.integrator_kind = kind
    job.integrator_params["maxdepth"] = 2
    counts, launches = launch_components.count_pass(job, 64, 8, 8, "cpu")
    assert sum(counts.values()) > 1000 and counts["intersect"] > 0
    assert ("photon gather" in counts) == (kind == "sppm")
    assert set(launches.values()) == {0}     # plain versions on the CPU


@pytest.mark.parametrize("kind", ("lighttracer", "bdpt"))
def test_dispatch_folds_the_splat_scale(kind):
    """lighttracer and bdpt return their splat scale (1 / spp); dispatch
    folds it into film.splat, so the film the CLI develops holds the
    scaled splats and develop adds them as they are."""
    from pbrt_tpu_torch.integrators import bdpt as tbdpt
    from pbrt_tpu_torch.integrators import path as tpath
    job = TAPI("cpu").parse_string(open(BENCH).read(), os.path.dirname(BENCH))
    job.integrator_kind = kind
    job.film_width = job.film_height = 4
    film, camera = tcli.run_job(job, spp=2, max_depth=1)
    raw = tfilm.make_film(4, 4, job.filter_name, device="cpu",
                          **job.filter_params)
    cfg = TCfg(kind=job.sampler_kind, seed=0, spp=2)
    if kind == "lighttracer":
        raw, scale = tlt.render_lighttracer(job.scene, camera, raw, cfg, 2,
                                            max_depth=1)
    else:
        raw, scale = tbdpt.render_bdpt(job.scene, camera, raw, cfg, 2,
                                       max_depth=1,
                                       generate_rays=tpath.generate_fn(camera))
    assert scale == 0.5 and raw.splat.sum() > 0
    assert torch.equal(film.splat, raw.splat * scale)
    assert torch.equal(tfilm.develop_spectral(film),
                       film.weighted / torch.clamp(film.weight, min=1e-12)
                       [..., None] + film.splat)
