"""The port's matched-RNG integrator as a whole (`integrators/refpath.py`
trace_ref), against pbrt_tpu's on the same rays and against the
reference binary's image.

- trace_ref on 512 lanes of row 60 of the 128x128 raster (m = 7), sample
  1, both offset constructions (pbrt_tpu's module constant set to the
  same): image mean within 1%, and >= 97% of lanes within 1e-2 relative
  with the default offsets (measured 0.992), >= 90% with offset="pbrt"
  (measured 0.963).  pbrt_tpu's CPU intersector is a BVH with the
  watertight test, the port's the dense Plucker test, so a few paths
  part at a seam or a spawned origin.  pbrt_tpu runs eagerly in this
  test: one compile of each operation, no compile of the whole loop.
- The reference gate of tests/test_refrng_parity.py on the CPU, its four
  thresholds unchanged, over rows 89-104 of the 4 spp fixture: the 16
  rows whose camera rays hit the mirror, plastic and glass objects most
  (1,079 of their 2,048 pixels; the rest see the walls).  The whole image
  takes ~230 s on one CPU thread, the band ~30 s.  Rows 89-105 are
  rendered, since a sample of jitter exactly 0.0 splats into the row
  above its own.  Measured: 0.9985 of pixels within 1e-2, median
  relative error 4.2e-7, mean ratio 4.7e-4, band median 4.2e-7.  The
  card gates the whole image at 4 and 32 spp (chip_smoke.py).
- trace_ref on pbrt_tpu_torch/scenes/refpath_sphere_sky.pbrt (a sphere
  light and the Hosek sky of textures/sky.exr over mirror and glass
  spheres): 32x32 lanes, depth 3: image mean within 1e-3 relative and
  >= 99% of lanes within 1e-2 (measured 1.5e-4 and 0.999).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.integrators import refpath as jref
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.tools.pbrt import build_camera as jbuild_camera
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import refpath as tref
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.tools.pbrt import build_camera as tbuild_camera
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "cornell_refrng.pbrt")
FIXTURE4 = os.path.join(ROOT, "tests", "data", "ref_cornell_refrng4.npz")
W = H = 128
DEV = "cpu"
BAND = (89, 105)


@pytest.fixture(scope="module")
def tjob():
    return tparse(SCENE, device=DEV)


@pytest.mark.parametrize("offset", ["scaled", "pbrt"])
def test_trace_ref_matches_jax(tjob, offset, monkeypatch):
    jj = jparse(SCENE)
    monkeypatch.setattr(jref, "REF_OFFSET_MODE", offset)
    ids = np.arange(60 * W, 60 * W + 512)
    js, ts = jref.RefSampler.make(W, H), tref.RefSampler.make(W, H)
    assert js.m == ts.m == 7
    jray, _, jpf, jpid, jsid = jref.camera_rays_ref(
        jbuild_camera(jj, W, H), W, H, js, jnp.asarray(ids, jnp.uint32),
        jnp.uint32(1), jproj.generate_rays)
    jL = np.asarray(jref.trace_ref(jj.scene, jref.build_ref_lights(jj.scene),
                                   js, jray, jpid, jsid, max_depth=5))
    tray, _, tpf, tpid, tsid = tref.camera_rays_ref(
        tbuild_camera(tjob, W, H, DEV), W, H, ts, torch.from_numpy(ids), 1)
    assert np.array_equal(tpf.numpy(), np.asarray(jpf))
    lt = tref.build_ref_lights(tjob.scene)
    tL = tref.trace_ref(tjob.scene, lt, ts, tray, tpid, tsid, max_depth=5,
                        offset=offset).numpy()
    assert tL.shape == jL.shape == (512, 31)
    assert np.isfinite(tL).all() and (tL >= 0).all()
    a, b = tL.sum(-1), jL.sum(-1)
    assert abs(a.mean() / b.mean() - 1) < 0.01
    close = (np.abs(a - b) <= 1e-2 * np.abs(b)).mean()
    assert close >= (0.97 if offset == "scaled" else 0.90), close
    with pytest.raises(ValueError):
        tref.trace_ref(tjob.scene, lt, ts, tray, tpid, tsid, offset="other")


def test_refrng_fixture_gate_on_a_band(tjob):
    """tests/test_refrng_parity.py's four thresholds, rows BAND."""
    d = np.load(FIXTURE4)
    ref, spp = d["img"], int(d["spp"])
    assert spp == 4 and ref.shape == (H, W, 31)
    cam = tbuild_camera(tjob, W, H, DEV)
    film = tfilm.make_film(W, H, "box", radius=(0.5, 0.5), device=DEV,
                           pbrt_boundary=True)
    sampler = tref.RefSampler.make(W, H)
    lt = tref.build_ref_lights(tjob.scene)
    r0, r1 = BAND
    ids = torch.arange(r0 * W, min(r1 + 1, H) * W)
    for s in range(spp):
        ray, weight, pfilm, pid, sidx = tref.camera_rays_ref(
            cam, W, H, sampler, ids, s)
        L = tref.trace_ref(tjob.scene, lt, sampler, ray, pid, sidx,
                           max_depth=5)
        tfilm.add_samples(film, pfilm, L, weight)
    ours, ref = film.weighted.numpy()[r0:r1], ref[r0:r1]
    lo, lr = ours.sum(-1), ref.sum(-1)
    rel = np.abs(lo - lr) / np.maximum(lr, 1e-3)
    frac_close = float(np.mean(rel < 1e-2))
    assert frac_close > 0.98, frac_close
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(lo.mean() / lr.mean() - 1.0) < 2e-3
    m = rel < 1e-2
    band_rel = np.abs(ours[m] - ref[m]) / np.maximum(ref[m], 1e-3)
    assert np.median(band_rel) < 1e-4


SPHERE_SKY = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                          "refpath_sphere_sky.pbrt")


def test_trace_ref_with_sphere_and_infinite_lights_matches_jax():
    """The sphere light sampled by its cone, the probe's hit on it, and
    the sky on escaped camera and specular rays."""
    n = 32
    jj, tj = jparse(SPHERE_SKY), tparse(SPHERE_SKY, device=DEV)
    assert tj.scene.has_sphere_lights and tj.scene.has_infinite
    ids = np.arange(n * n)
    js, ts = jref.RefSampler.make(n, n), tref.RefSampler.make(n, n)
    jray, _, _, jpid, jsid = jref.camera_rays_ref(
        jbuild_camera(jj, n, n), n, n, js, jnp.asarray(ids, jnp.uint32),
        jnp.uint32(1), jproj.generate_rays)
    jL = np.asarray(jref.trace_ref(jj.scene, jref.build_ref_lights(jj.scene),
                                   js, jray, jpid, jsid, max_depth=3))
    tray, _, _, tpid, tsid = tref.camera_rays_ref(
        tbuild_camera(tj, n, n, DEV), n, n, ts, torch.from_numpy(ids), 1)
    tL = tref.trace_ref(tj.scene, tref.build_ref_lights(tj.scene), ts, tray,
                        tpid, tsid, max_depth=3).numpy()
    assert np.isfinite(tL).all() and (tL >= 0).all()
    a, b = tL.sum(-1), jL.sum(-1)
    assert (b > 0).mean() > 0.5
    assert abs(a.mean() / b.mean() - 1) < 1e-3
    assert (np.abs(a - b) <= 1e-2 * np.abs(b)).mean() >= 0.99
