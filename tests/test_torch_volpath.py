"""The volpath slice as a whole: the port's integrators/volpath.py through
the CLI's `run_job` against pbrt_tpu's, on the CPU.

Scenes at 16x16, 2 spp, depth 3: scenes/volpath_bench.pbrt (the camera
and every shape in homogeneous fog through MediumInterface),
scenes/smoke_glass.pbrt (a grid bound inside a glass sphere: per-lane
delta tracking and the interface walk's ratio tracking), and each of
them with its MediumInterface lines removed, so that its medium is the
scene's one medium (homogeneous, and a grid).

pbrt_tpu's render runs its pass unfused, with its sampler, BSDF, light,
medium and intersect functions jitted one by one (`jax_render`, as
test_torch_materials_render.py runs its own): the fused depth-3 pass of
the grid scenes compiles its tracking loops unrolled.

kernel_workloads.shells_scene (eight nested material-less MediumInterface
boxes about a light) drives the walk through all of its crossings.

Tolerances: the same counter-based samples, so the same paths but where
the two intersectors pick another triangle at an edge or a lobe choice
flips at a rounding tie: image mean within 1e-4 relative, >= 97% of
pixels within 1e-3 and >= 99% within 1e-2 (measured: means within
2.4e-7, every pixel within 1e-3, >= 99.6% within 1e-5).
"""
import os
import re

import numpy as np
import jax
import pytest
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.integrators import volpath as jvol
from pbrt_tpu.lights import distrib as jdistrib
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.media import media as jmed
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import dispatch
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import volpath as tvol
from pbrt_tpu_torch.media import media as tmed
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import kernel_workloads as kw
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_DIR = os.path.join(ROOT, "scenes")
RES, SPP, DEPTH = 16, 2, 3


def jax_render(jj, spp, depth):
    """pbrt_tpu's run_job of job jj, its pass unfused and its pieces
    jitted one by one; the developed image [H,W,31]."""
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jpath, jvol):
            mp.setattr(mod, "sample_dim", jit(jsamp.sample_dim,
                                              static_argnums=(0, 3)))
        for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                     "bump_shading_normal"):
            mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
        for name in ("sample_li", "pdf_li_area", "pdf_li_infinite",
                     "area_le", "env_le"):
            mp.setattr(jlights, name, jit(getattr(jlights, name)))
        for name in ("select_light", "selection_pdf"):
            mp.setattr(jdistrib, name, jit(getattr(jdistrib, name),
                                           static_argnums=1))
        for name in ("sample_distance_lanes", "sample_distance_grid_lanes",
                     "ratio_tr_lanes", "hg_sample", "hg_p"):
            mp.setattr(jmed, name, jit(getattr(jmed, name)))
        mp.setattr(jisect, "intersect", jit(jisect.intersect))
        mp.setattr(jisect, "occluded", jit(jisect.occluded))
        mp.setattr(jisect, "trace_pair", jit(jisect.trace_pair))
        mp.setattr(jisect, "intersect_full", jit(
            jisect.intersect_full, static_argnames=("presorted",)))
        # render's per-pass jit: the pass runs unfused
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        film, _ = jcli.run_job(jj, spp=spp, max_depth=depth, quiet=True)
    return np.asarray(jfilm.develop_spectral(film))


def assert_renders_alike(ti, ji):
    """The slice's image tolerance (module docstring)."""
    assert np.isfinite(ti).all() and (ti >= 0).all() and ti.mean() > 0
    assert abs(ti.mean() / ji.mean() - 1) < 1e-4
    tl, jl = ti.sum(-1), ji.sum(-1)
    diff = np.abs(tl - jl)
    assert (diff <= 1e-3 * np.abs(jl)).mean() >= 0.97
    assert (diff <= 1e-2 * np.abs(jl)).mean() >= 0.99


def _jobs(name, bound=True):
    src = open(os.path.join(SCENE_DIR, name + ".pbrt")).read()
    if not bound:
        src = re.sub(r"MediumInterface[^\n]*\n", "", src)
    jj, tj = JAPI().parse_string(src, SCENE_DIR), TAPI("cpu").parse_string(
        src, SCENE_DIR)
    for j in (jj, tj):
        j.film_width = j.film_height = RES
    return jj, tj


@pytest.mark.parametrize("name,bound", [
    ("volpath_bench", True), ("smoke_glass", True),
    ("volpath_bench", False), ("smoke_glass", False)],
    ids=["fog-interface", "smoke-in-glass", "fog-scene-medium",
         "grid-scene-medium"])
def test_volpath_renders_like_jax(name, bound):
    jj, tj = _jobs(name, bound)
    assert tj.scene.has_prim_media == bound
    assert tj.scene.has_grid_media == (bound and name == "smoke_glass")
    if not bound:
        kind = tvol.build_medium_from_job(tj, "cpu").kind
        assert kind == (tmed.MEDIUM_GRID if name == "smoke_glass"
                        else tmed.MEDIUM_HOMOGENEOUS)
    tf, _ = tcli.run_job(tj, spp=SPP, max_depth=DEPTH)
    assert_renders_alike(tfilm.develop_spectral(tf).numpy(),
                         jax_render(jj, SPP, DEPTH))


def test_salt_stride_lets_walk_and_next_bounce_share_dimensions():
    """The salts of pbrt_tpu's volpath (volpath.py:60, :86, :186, kept):
    a bounce's medium samples start at 0x9000 + 256 bounce, its grid
    tracking at + 8, its shadow walk at + 64 + 64 crossing with two
    dimensions a step; so the walk's later crossings draw the next
    bounce's free-flight and tracking dimensions (ADVICE r5)."""
    assert (tvol.SALT_BASE, tvol.SALT_STRIDE) == (0x9000, 256)
    walk = {tvol.SALT_BASE + 64 + 64 * c + 2 * k
            for c in range(8) for k in range(tmed.LANE_TRACK_STEPS)}
    nxt = tvol.SALT_BASE + tvol.SALT_STRIDE
    assert nxt in walk and nxt + 8 in walk


def test_volpath_without_media_renders_path_uniform():
    """"volpath" on a scene without media renders trace_paths with the
    uniform light strategy (pbrt_tpu/integrators/dispatch.py:63-67)."""
    src = open(os.path.join(SCENE_DIR, "volpath_bench.pbrt")).read()
    src = re.sub(r"(MakeNamedMedium|MediumInterface)[^\n]*\n(    [^\n]*\n)?",
                 "", src)
    job = TAPI("cpu").parse_string(src, SCENE_DIR)
    assert not job.media and job.integrator_kind == "volpath"
    cam = tcli.build_camera(job, 8, 8, "cpu")
    films = []
    for strategy in (None, "uniform"):
        film = tfilm.make_film(8, 8, job.filter_name, device="cpu")
        if strategy is None:
            dispatch.render_with_integrator(job, cam, film,
                                            SamplerConfig("sobol", 0, 1), 1,
                                            2)
        else:
            tpath.render(job.scene, cam, film, SamplerConfig("sobol", 0, 1),
                         1, max_depth=2,
                         trace_kwargs=dict(light_strategy=strategy))
        films.append(film.weighted)
    assert torch.equal(*films)


def test_shells_render_like_jax():
    """kernel_workloads.shells_scene, whose shadow rays cross eight
    material-less MediumInterface boxes to the light: every step of the
    walk carries live lanes (depth 1)."""
    src = kw.shells_scene(RES)
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    assert tj.scene.has_prim_media and tj.scene.camera_medium == -1
    tf, _ = tcli.run_job(tj, spp=SPP, max_depth=1)
    assert_renders_alike(tfilm.develop_spectral(tf).numpy(),
                         jax_render(jj, SPP, 1))


def test_shell_walk_hits_a_triangle_at_every_crossing():
    """The batches the card's K1 / K2 check takes from the shell scene:
    at each of the walk's 8 crossings of bounce 0, the same lanes are
    live and every one of them finds a box's triangle (closest hit)."""
    res = 16
    job = TAPI("cpu").parse_string(kw.shells_scene(res))
    cam = tcli.build_camera(job, res, res, "cpu")
    walks = kw.volpath_walk_batches(job, cam, SamplerConfig("sobol", 0, 1),
                                    res, res, res * res, 1,
                                    crossings=range(1, 9), bounce=0)
    s = job.scene
    live0 = None
    for c, (r16, tmax, _) in walks.items():
        live = tmax > 0
        live0 = live if live0 is None else live0
        assert torch.equal(live, live0) and int(live.sum()) > res * res // 4
        cl, na = dense.tile_chunk_lists_plain(r16, tmax, s.dense_cb)
        _, prim = dense.loop_hits_plain(r16, tmax, s.dense_w, cl, na)
        assert not (r16[:, 12] > 0.5).any()
        assert torch.equal(prim >= 0, live), c
