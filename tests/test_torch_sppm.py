"""The port's SPPM (integrators/sppm.py) against pbrt_tpu's on the CPU, on
tests/test_sppm.py's scene (a light quad over a floor and a back wall)
at 12x12, depth 3 camera paths and depth 4 photons.

pbrt_tpu runs eagerly with its intersect, material, light and sampler
functions jitted one by one.  The same counter-based samples:
- the camera pass: Ld, the visible points, their kd / pi weights and
  flags: >= 97% of pixels within 1e-4 relative (measured: every pixel;
  visible points 1.7e-6 apart, the two intersectors' rounding);
- the photon pass, from pbrt_tpu's visible points: 4,096 photons of
  which a few hundred deposit within radius 0.5.  The photon counts M
  must be equal on every visible point but those with a photon whose
  distance lies within its position's difference between the two
  packages (plus 1e-6) of the radius: those are counted and must be
  rare (measured: M equal everywhere, positions within 4.5e-5); tau_add
  within 1e-4 relative where M is equal.
The whole render through the CLI is in test_torch_lighttracer.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.integrators import lighttracer as jlt
from pbrt_tpu.integrators import sppm as jsppm
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.integrators import sppm as tsppm
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from test_sppm import _scene_with_indirect
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lighttracer import port_camera, port_scene

W = H = 12
CFG = ("independent", 0, 4)
PHOTONS = 4096
RADIUS = 0.5


@pytest.fixture(scope="module")
def passes():
    """Both packages' camera pass and photon pass (from pbrt_tpu's
    visible points), with each photon bounce's hit points."""
    jit = jax.jit
    jhits, thits = [], []
    jif = jit(jisect.intersect_full, static_argnames=("presorted",))

    def jrecord(*a, **k):
        h = jif(*a, **k)
        jhits.append(h)
        return h

    gather = tsppm.gather

    def trecord(vp_p, vp_valid, r2, p, alive, *a):
        thits.append((p.clone(), alive.clone()))
        return gather(vp_p, vp_valid, r2, p, alive, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsppm, "sample_dim", jit(jsamp.sample_dim,
                                            static_argnums=0))
        for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                     "shading_frame"):
            mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
        for name in ("area_le", "sample_li", "env_le"):
            mp.setattr(jlights, name, jit(getattr(jlights, name)))
        mp.setattr(jsppm, "sample_le", jit(jlt.sample_le))
        mp.setattr(jisect, "occluded", jit(jisect.occluded))
        mp.setattr(jisect, "intersect_full", jrecord)
        mp.setattr(tsppm, "gather", trecord)
        js = _scene_with_indirect()
        jc = jproj.make_perspective(
            jtfm.look_at([0, -7, 3], [0, 0, 1.5], [0, 0, 1]), 45.0, W, H)
        ts, tc = port_scene(js), port_camera(jc)
        jcam = jsppm._camera_pass(js, jc, W, H, JCfg(*CFG), jnp.uint32(0), 3,
                                  jproj.generate_rays)
        tcam = tsppm.camera_pass(ts, tc, W, H, TCfg(*CFG), 0, 3)
        del jhits[:]
        jph = jsppm._photon_pass(js, JCfg(*CFG), jnp.uint32(0), PHOTONS, 4,
                                 *jcam[1:4], jnp.full(W * H, RADIUS))
        vp_p, vp_ok = (torch.tensor(np.asarray(jcam[k])) for k in (1, 3))
        tph = tsppm.photon_pass(ts, TCfg(*CFG), 0, PHOTONS, 4, vp_p, vp_ok,
                                torch.full((W * H,), RADIUS))
    return dict(jcam=jcam, tcam=tcam, jph=jph, tph=tph, jhits=jhits,
                thits=thits)


def test_camera_pass_like_jax(passes):
    names = ("Ld", "vp_p", "vp_f", "vp_valid", "pfilm")
    for name, j, t in zip(names, passes["jcam"], passes["tcam"]):
        j = np.asarray(j, np.float64).reshape(W * H, -1)
        t = t.numpy().astype(np.float64).reshape(W * H, -1)
        ok = (np.abs(t - j) <= 1e-4 * np.abs(j) + 1e-6).all(-1)
        assert ok.mean() >= 0.97, name
    assert passes["tcam"][3].float().mean() > 0.5


def test_photon_pass_like_jax(passes):
    jt, jM = (np.asarray(x) for x in passes["jph"])
    tt, tM = (x.numpy() for x in passes["tph"])
    assert jM.sum() > 100
    vp_p = np.asarray(passes["jcam"][1], np.float64)
    vp_ok = np.asarray(passes["jcam"][3])
    # bounces 1-3 deposit: pbrt_tpu's intersect calls 1-3 of 4
    assert len(passes["thits"]) == 3 and len(passes["jhits"]) == 4
    near = np.zeros(W * H, bool)
    n_pairs = 0
    for jh, (tp, ta) in zip(passes["jhits"][1:], passes["thits"]):
        jp, tp = np.asarray(jh.p, np.float64), tp.numpy().astype(np.float64)
        live = np.asarray(jh.valid) | ta.numpy()
        dp = np.abs(jp - tp).max(-1)[live]
        assert (dp <= 1e-5).mean() >= 0.97
        dist = np.linalg.norm(vp_p[:, None, :] - tp[None, live, :], axis=-1)
        amb = (np.abs(dist - RADIUS) <= dp[None, :] * np.sqrt(3) + 1e-6) \
            & vp_ok[:, None]
        near |= amb.any(-1)
        n_pairs += int(amb.sum())
    differ = jM != tM
    assert not (differ & ~near).any()
    assert n_pairs <= 0.01 * jM.sum() + 2
    same = ~differ
    assert np.allclose(tt[same], jt[same], rtol=1e-4, atol=1e-6)
    assert tt.sum() > 0
