"""The Cornell slice as a whole: the port's trace_paths and render against
pbrt_tpu's on the CPU.

The samples are bit-identical (same counter-based Sobol'), so most paths
are the same path.  A few diverge: pbrt_tpu's CPU intersector is a BVH
with a watertight triangle test, the port's the dense Plücker test, and
the two can pick different triangles at an edge or round a spawned
origin differently, after which the path goes elsewhere.  Tolerances:
image mean within 1%; >= 95% of pixels (and of per-ray radiances) within
1e-2 relative; ray counts within 1%.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.film import io as jio
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg

W = H = 32


@pytest.fixture(scope="module")
def scenes():
    js, jcam = jflag.cornell(tessellate=True)
    ts, tcam = tflag.cornell()
    return js, jcam(W, H), ts, tcam(W, H)


def _frac_close(a, b, rtol=1e-2):
    return (np.abs(a - b) <= rtol * np.abs(b)).mean()


def test_trace_paths_matches_jax(scenes):
    js, jc, ts, tc = scenes
    ids = np.arange(W * H, dtype=np.uint32)

    @jax.jit
    def jrun(pixel_ids):
        ray, _, _, pid, sidx = jpath.camera_rays_for_pixels(
            jc, W, H, JCfg("sobol", 0, 4), pixel_ids, 1,
            jproj.generate_rays)
        return jpath.trace_paths(js, ray, pid, sidx, JCfg("sobol", 0, 4),
                                 max_depth=5, count_rays="full")

    jL, jn = (np.asarray(x) for x in jrun(jnp.asarray(ids)))
    ray, _, _, pid, sidx = tpath.camera_rays_for_pixels(
        tc, W, H, TCfg("sobol", 0, 4), torch.from_numpy(ids.astype(np.int64)),
        1)
    tL, tn = tpath.trace_paths(ts, ray, pid, sidx, TCfg("sobol", 0, 4),
                               max_depth=5, count_rays="full")
    tL, tn = tL.numpy(), tn.numpy()
    assert tL.shape == jL.shape == (W * H, 31)
    assert np.isfinite(tL).all() and (tL >= 0).all()
    assert abs(tL.mean() / jL.mean() - 1) < 0.01
    assert _frac_close(tL.sum(-1), jL.sum(-1)) >= 0.95
    # counters [closest, shadow, camera, path vertices]
    assert tn[2] == jn[2] == W * H
    np.testing.assert_allclose(tn, jn, rtol=0.01)


def test_render_matches_jax(scenes):
    js, jc, ts, tc = scenes
    spp = 2
    jf = jpath.render(js, jc, jfilm.make_film(W, H, "box"),
                      JCfg("sobol", 0, spp), spp, max_depth=5)
    tf, n_rays = tpath.render(ts, tc, tfilm.make_film(W, H, "box"),
                              TCfg("sobol", 0, spp), spp, max_depth=5,
                              count_rays=True)
    ji = np.asarray(jfilm.develop_spectral(jf))
    ti = tfilm.develop_spectral(tf).numpy()
    assert abs(ti.mean() / ji.mean() - 1) < 0.01
    assert _frac_close(ti.sum(-1), ji.sum(-1)) >= 0.95
    np.testing.assert_allclose(tfilm.develop_rgb(tf).numpy().mean((0, 1)),
                               np.asarray(jfilm.develop_rgb(jf)).mean((0, 1)),
                               rtol=0.01)
    assert n_rays > 2 * spp * W * H


@pytest.mark.parametrize("name", ["box", "gaussian"])
def test_film_splat_matches_jax(name):
    rs = np.random.RandomState(16)
    pf = (rs.rand(512, 2) * [W, H]).astype(np.float32)
    L = rs.rand(512, 31).astype(np.float32)
    w = rs.rand(512).astype(np.float32)
    jf = jfilm.add_samples(jfilm.make_film(W, H, name),
                           jnp.asarray(pf), jnp.asarray(L), jnp.asarray(w))
    tf = tfilm.add_samples(tfilm.make_film(W, H, name),
                           torch.from_numpy(pf), torch.from_numpy(L),
                           torch.from_numpy(w))
    for k in ("weighted", "weight", "raw"):
        np.testing.assert_allclose(getattr(tf, k).numpy(),
                                   np.asarray(getattr(jf, k)),
                                   rtol=1e-5, atol=1e-6)


def test_write_dat_and_exr_bytes_match_jax(tmp_path):
    img = np.random.RandomState(17).rand(6, 5, 31).astype(np.float32)
    a = jio.write_dat(str(tmp_path / "jax.dat"), img, scale=2.0)
    b = tio.write_dat(str(tmp_path / "torch.dat"), torch.from_numpy(img),
                      scale=2.0)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back, flag = tio.read_dat(b)
    assert flag == "v3" and np.array_equal(back, img.astype(np.float64) * 2)
    rgb = img[..., :3]
    jio.write_exr(str(tmp_path / "jax.exr"), rgb)
    tio.write_exr(str(tmp_path / "torch.exr"), torch.from_numpy(rgb))
    assert (tmp_path / "jax.exr").read_bytes() == \
        (tmp_path / "torch.exr").read_bytes()
    assert os.path.getsize(tmp_path / "torch.exr") > rgb.nbytes
