"""whitted, ambient occlusion and directlighting (with the "all" light
strategy) through the CLI's `run_job` against pbrt_tpu's on the CPU, the
integrator names of dispatch, and the broadcast albedo of the
differentiable renderer.

Scenes at 16x16, 2 spp: scenes/cornell_bench.pbrt with its Integrator
overridden, and for "all" a plane under two point lights and an area
light.  pbrt_tpu's render runs unfused with its pieces jitted
(test_torch_volpath.jax_render).  Tolerances: test_torch_volpath's (the
same samples and paths but at rounding ties); measured: means within
1.8e-7 relative (equal on cornell_bench), every pixel within 1e-5.
"""
import logging
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.integrators import diff as jdiff
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.cameras import projective as tproj
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import diff as tdiff
from pbrt_tpu_torch.integrators import dispatch
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lighttracer import jax_light_render
from test_torch_volpath import assert_renders_alike, jax_render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")
RES, SPP = 16, 2
THREE_LIGHTS = """LookAt 0 0 3  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
Integrator "directlighting" "string strategy" "all"
WorldBegin
Material "plastic" "rgb Kd" [.4 .5 .3] "rgb Ks" [.3 .3 .3]
    "float roughness" [.1]
Shape "trianglemesh" "point P" [-5 -5 0 5 -5 0 5 5 0 -5 5 0]
    "integer indices" [0 1 2 2 3 0]
LightSource "point" "rgb I" [8 6 4] "point from" [-1 0 1.5]
LightSource "point" "rgb I" [1 2 3] "point from" [1 0.5 1]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [4 4 4]
Translate 0 -1 2
Shape "sphere" "float radius" [0.3]
AttributeEnd
WorldEnd
"""

# two sphere lights and a point light: the light strategies pick them
# with different probabilities
TWO_AREA_LIGHTS = """LookAt 0 0 3  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "trianglemesh" "point P" [-5 -5 0 5 -5 0 5 5 0 -5 5 0]
    "integer indices" [0 1 2 2 3 0]
LightSource "point" "rgb I" [1 2 3] "point from" [1 0.5 1]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [6 4 2]
Translate -1.2 0.8 0.6
Shape "sphere" "float radius" [0.15]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "rgb L" [1 3 5]
Translate 1 -1 1.4
Shape "sphere" "float radius" [0.4]
AttributeEnd
WorldEnd
"""


def _jobs(text, integrator=None, **params):
    jj, tj = (api.parse_string(text, os.path.dirname(BENCH))
              for api in (JAPI(), TAPI("cpu")))
    for j in (jj, tj):
        j.film_width = j.film_height = RES
        if integrator is not None:
            j.integrator_kind = integrator
        j.integrator_params.update(params)
    return jj, tj


def _render_pair(jj, tj, depth):
    tf, _ = tcli.run_job(tj, spp=SPP, max_depth=depth)
    return (tfilm.develop_spectral(tf).numpy(), jax_render(jj, SPP, depth))


@pytest.fixture(scope="module")
def bench_text():
    with open(BENCH) as f:
        return f.read()


@pytest.mark.parametrize("integrator,params,depth", [
    ("whitted", {}, 5),
    ("ao", {}, 5),
    ("ambientocclusion", {"cossample": False}, 5),
    ("directlighting", {"strategy": "all"}, 5),
    ("directlighting", {}, 5)],
    ids=["whitted", "ao", "ao-uniform", "directlighting-all",
         "directlighting-path-strategy"])
def test_integrator_renders_like_jax(bench_text, integrator, params, depth):
    """cornell_bench.pbrt (its glass and mirror for whitted's specular
    recursion).  directlighting without "strategy all" takes the path's
    light strategy, as pbrt_tpu's parser, whose strategy default is
    "depth", gives it."""
    jj, tj = _jobs(bench_text, integrator, **params)
    ti, ji = _render_pair(jj, tj, depth)
    assert_renders_alike(ti, ji)
    if integrator.startswith("a"):          # a grey image in [0, 1]
        assert np.allclose(ti, ti[..., :1]) and ti.max() <= 1.0 + 1e-6


def test_all_lights_render_like_jax():
    """The "all" strategy over three lights (two point lights and a
    sphere light): one sample of each a bounce."""
    jj, tj = _jobs(THREE_LIGHTS)
    assert tj.scene.n_lights == 3
    ti, ji = _render_pair(jj, tj, 1)
    assert_renders_alike(ti, ji)


@pytest.mark.parametrize("kind", dispatch.INTEGRATORS)
def test_every_ported_integrator_renders(bench_text, kind):
    """Each name dispatch lists renders cornell_bench.pbrt (8x8, 1 spp,
    depth 2) through render_with_integrator: finite, non-negative and
    not black."""
    job = TAPI("cpu").parse_string(bench_text, os.path.dirname(BENCH))
    job.integrator_kind = kind
    film = tfilm.make_film(8, 8, job.filter_name, device="cpu")
    dispatch.render_with_integrator(job, tcli.build_camera(job, 8, 8, "cpu"),
                                    film, TCfg("sobol", 0, 1), 1, 2)
    img = tfilm.develop_spectral(film)
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert float(img.mean()) > 0


def test_unknown_integrator_warns_and_renders_path(caplog):
    """A name neither package knows renders path with a warning, as
    pbrt_tpu's dispatch does: with trace_paths' own light strategy,
    "uniform", not the path integrator's "spatial" default.  Held against
    pbrt_tpu on TWO_AREA_LIGHTS (two sphere lights and a point light)
    at depth 2, where the spatial strategy gives another image.  The
    light-side integrators, once unported, render the same scene through
    dispatch (16x16, 1 spp, depth 2; mlt with 64 chains, 256 bootstrap
    paths): finite, non-negative, lit; lighttracer and sppm against
    pbrt_tpu's (assert_renders_alike; bdpt and mlt are held to it in
    test_torch_bdpt.py, test_torch_integrators.py and test_torch_mlt.py)."""
    jj, tj = _jobs(TWO_AREA_LIGHTS, "nosuchintegrator")
    with caplog.at_level(logging.WARNING, logger="pbrt_tpu_torch"):
        ti, ji = _render_pair(jj, tj, 2)
    assert "unknown integrator 'nosuchintegrator'" in caplog.text
    assert_renders_alike(ti, ji)
    _, pj = _jobs(TWO_AREA_LIGHTS, "path")
    pf, _ = tcli.run_job(pj, spp=SPP, max_depth=2)
    pi = tfilm.develop_spectral(pf).numpy()
    assert abs(pi.mean() / ji.mean() - 1) > 1e-3
    for kind in dispatch.LIGHT_SIDE:
        jj, job = _jobs(TWO_AREA_LIGHTS, kind, chains=64,
                        bootstrapsamples=256)
        film = tfilm.make_film(RES, RES, device="cpu")
        dispatch.render_with_integrator(
            job, tcli.build_camera(job, RES, RES, "cpu"), film,
            TCfg(job.sampler_kind, 0, 1), 1, 2)
        img = tfilm.develop_spectral(film).numpy()
        assert np.isfinite(img).all() and (img >= 0).all(), kind
        assert img.mean() > 0, kind
        if kind in ("lighttracer", "sppm"):
            assert_renders_alike(img, jax_light_render(jj, 1, 2))


def test_broadcast_albedo_matches_jax():
    """A [1, 31] mat_kd sets every material's albedo, as pbrt_tpu's
    apply_params broadcasts it: on cornell(tessellate=False) (7
    materials) at 8x8, depth 2, the port's samples equal those of the
    explicit [7, 31] parameter and their mean equals pbrt_tpu's within
    1e-5 relative."""
    js, jcam = jflag.cornell(tessellate=False)
    ts = tir.scene_from_jax({k: np.asarray(getattr(js, k))
                             for k in tir.JAX_ARRAYS},
                            {k: getattr(js, k) for k in tir.JAX_STATICS},
                            "cpu")
    cam = tproj.camera_from_jax({k: np.asarray(getattr(jcam(8, 8), k))
                                 for k in ("cam_to_world", "raster_to_camera",
                                           "camera_to_raster", "lens_radius",
                                           "focal_distance", "shutter_open",
                                           "shutter_close")}, "cpu")
    assert ts.mat_kd.shape[0] == 7
    kd = np.full((1, 31), 0.5, np.float32)
    ids = torch.arange(64)
    one, _ = tdiff.render_samples({"mat_kd": torch.from_numpy(kd)}, ts, cam,
                                  8, 8, TCfg("sobol", 0, 1), ids, 0,
                                  max_depth=2)
    seven, _ = tdiff.render_samples(
        {"mat_kd": torch.from_numpy(np.repeat(kd, 7, 0))}, ts, cam, 8, 8,
        TCfg("sobol", 0, 1), ids, 0, max_depth=2)
    assert torch.equal(one, seven)
    jl, _ = jdiff.render_samples({"mat_kd": jnp.asarray(kd)}, js, jcam(8, 8),
                                 8, 8, JCfg("sobol", 0, 1),
                                 jnp.arange(64, dtype=jnp.uint32), 0,
                                 max_depth=2)
    assert abs(float(one.mean()) / float(jl.mean()) - 1) < 1e-5
    # the gradient reaches the one row from every material
    p = torch.from_numpy(kd).requires_grad_()
    L, _ = tdiff.render_samples({"mat_kd": p}, ts, cam, 8, 8,
                                TCfg("sobol", 0, 1), ids, 0, max_depth=2)
    L.mean().backward()
    assert p.grad.shape == (1, 31) and float(p.grad.abs().sum()) > 0
