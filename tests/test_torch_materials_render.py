"""The materials slice as a whole: pbrt_tpu_torch/scenes/
cornell_materials.pbrt (every ported surface family, an imagemap and a
checkerboard, a wrinkled bump map, camera ray differentials with EWA
filtering) at 32x32, 2 spp, depth 5 through both CLIs' `run_job` on the
CPU.

pbrt_tpu's render runs its pass unfused, with its BSDF, intersect and
sampler functions jitted one by one: XLA compiles the whole fused pass
of this scene in ~170 s on the CPU, the pieces in ~30 s; the functions
and their order are the same.

Tolerances: the samples are the same counter-based Sobol' bits, and the
same paths but where the two intersectors pick different triangles at an
edge or a lobe choice flips at a rounding tie: image mean within 1e-4
relative; >= 98% of pixels within 1e-3 relative and >= 99.5% within 1e-2
(measured 1.5e-6, 99.5% and 100%).
"""
import os

import numpy as np
import jax
import pytest
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.textures import textures as ttex
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                     "cornell_materials.pbrt")
W = H = 32
SPP = 2


@pytest.fixture(scope="module")
def jobs():
    jj, tj = jparse(SCENE), tparse(SCENE, device="cpu")
    for j in (jj, tj):
        j.film_width = j.film_height = W
    return jj, tj


def _jax_render(jj):
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpath, "sample_dim", jit(jsamp.sample_dim,
                                            static_argnums=0))
        for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                     "bump_shading_normal"):
            mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
        mp.setattr(jisect, "trace_pair", jit(jisect.trace_pair))
        mp.setattr(jisect, "intersect_full", jit(
            jisect.intersect_full, static_argnames=("presorted",)))
        # render's per-pass jit: the pass runs unfused
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        film, _ = jcli.run_job(jj, spp=SPP, max_depth=5, quiet=True)
    return np.asarray(jfilm.develop_spectral(film))


def test_materials_scene_renders_like_jax(jobs):
    jj, tj = jobs
    tf, _ = tcli.run_job(tj, spp=SPP, max_depth=5)
    ti = tfilm.develop_spectral(tf).numpy()
    assert np.isfinite(ti).all() and (ti >= 0).all() and ti.mean() > 0
    ji = _jax_render(jj)
    assert abs(ti.mean() / ji.mean() - 1) < 1e-4
    tl, jl = ti.sum(-1), ji.sum(-1)
    diff = np.abs(tl - jl)
    assert (diff <= 1e-3 * np.abs(jl)).mean() >= 0.98
    assert (diff <= 1e-2 * np.abs(jl)).mean() >= 0.995


def test_first_hits_carry_differentials_and_the_image_loads(jobs):
    """render hands the projective camera's ray differentials to the
    trace: the floor's and walls' first hits get nonzero uv derivatives
    (EWA), the spheres' zero (the cone); the imagemap's table entry is
    the PNG, not a constant."""
    _, tj = jobs
    sc = tj.scene
    assert sc.tex_kinds == (ttex.TEX_IMAGE, ttex.TEX_CHECKER,
                            ttex.TEX_WRINKLED)
    img = sc.tex_images[list(sc.tex_type.tolist()).index(ttex.TEX_IMAGE, 1)]
    assert float(img[:ttex.RES].std()) > 0.05
    kw, use_rd = tpath.trace_options(sc, tcli.build_camera(tj, W, H, "cpu"),
                                     tpath.trace_paths)
    assert use_rd and kw["tex_spread"] > 0
    cam = tcli.build_camera(tj, W, H, "cpu")
    cfg = SamplerConfig("sobol", 0, SPP)
    ids = torch.arange(W * H)
    ray, _, _, pid, sidx = tpath.camera_rays_for_pixels(cam, W, H, cfg, ids,
                                                        0)
    rd = tpath.camera_ray_differentials(cam, W, H, cfg, pid, sidx,
                                        tpath.generate_fn(cam), SPP)
    hit = tisect.intersect_full(sc, ray, presorted=True, ray_diff=rd)
    tri = sc.prim_type[hit.prim] == 0
    has = (hit.duv != 0).any(-1)
    assert has[hit.valid & tri].float().mean() > 0.9
    assert not has[~tri].any()
