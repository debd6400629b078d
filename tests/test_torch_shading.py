"""The port's BSDFs (matte, plastic, mirror, glass) and mesh area light
against pbrt_tpu on the same inputs (CPU).

Tolerances: the same f32 formulas in a different framework differ by a
few ulps (libm sqrt/cos/log), so continuous outputs agree to 1e-4
relative (1e-6 absolute); discrete lobe choices compare uniforms with
those outputs and may flip only where a uniform lands within rounding of
its threshold (<= 0.1% of lanes).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu_torch.lights import lights as tlights
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.models import flagship as tflag
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

N = 4096
RTOL, ATOL = 1e-4, 1e-6
DEV = "cpu"


@pytest.fixture(scope="module")
def scenes():
    return jflag.cornell(tessellate=True)[0], tflag.cornell(device=DEV)[0]


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs(scenes):
    js, ts = scenes
    rs = np.random.RandomState(14)
    M = ts.mat_type.shape[0]
    mat = rs.randint(-1, M, N).astype(np.int32)     # -1: no material
    wo, wi = _unit(rs, N), _unit(rs, N)
    u = rs.rand(3, N).astype(np.float32)
    jm = jbsdf.gather_materials(js, jnp.asarray(mat))
    tm = tbsdf.gather_materials(ts, torch.from_numpy(mat))
    return jm, tm, wo, wi, u


def _close(a, b, mask=None, rtol=RTOL, atol=ATOL):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_gather_materials(inputs):
    jm, tm, *_ = inputs
    assert np.array_equal(tm.type.numpy(), np.asarray(jm.type))
    for k in ("kd", "ks", "kr", "kt", "eta", "sigma"):
        _close(getattr(tm, k), getattr(jm, k), rtol=0, atol=0)
    for k in ("rough_u", "rough_v"):
        _close(getattr(tm, k), getattr(jm, k), rtol=1e-6)
    assert set(np.unique(tm.type.numpy())) == {-1, 0, 1, 2, 3}


def test_eval_and_pdf(inputs):
    jm, tm, wo, wi, _ = inputs
    two, twi = torch.from_numpy(wo), torch.from_numpy(wi)
    _close(tbsdf.eval_f(tm, two, twi),
           jbsdf.eval_f(jm, jnp.asarray(wo), jnp.asarray(wi)))
    _close(tbsdf.pdf_f(tm, two, twi),
           jbsdf.pdf_f(jm, jnp.asarray(wo), jnp.asarray(wi)))
    # the glossy plastic lobe is exercised, not just the diffuse ones
    f = tbsdf.eval_f(tm, two, twi).numpy()
    assert (f[tm.type.numpy() == 1] > 0).any()


def test_sample_f(inputs):
    jm, tm, wo, _, u = inputs
    jout = jbsdf.sample_f(jm, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    tout = tbsdf.sample_f(tm, torch.from_numpy(wo),
                          *(torch.from_numpy(x) for x in u))
    jwi, jf, jpdf, jspec, jtrans, jeta = (np.asarray(x) for x in jout)
    twi, tf, tpdf, tspec, ttrans, teta = tout
    assert np.array_equal(tspec.numpy(), jspec)
    same = ttrans.numpy() == jtrans
    assert same.mean() >= 0.999
    # where the lobe choice agrees the sampled direction does too
    same &= np.abs(twi.numpy() - jwi).max(-1) < 1e-3
    assert same.mean() >= 0.999
    _close(twi, jwi, same, atol=1e-5)
    _close(tf, jf, same)
    _close(tpdf, jpdf, same)
    _close(teta, jeta, same, rtol=1e-6)
    for t in (1, 2, 3):          # every ported family samples somewhere
        assert (tpdf.numpy()[tm.type.numpy() == t] > 0).any()


def test_fresnel_dielectric():
    c = np.linspace(-1, 1, 513).astype(np.float32)
    _close(tbsdf.fresnel_dielectric(torch.from_numpy(c), 1.0,
                                    torch.full((513,), 1.5)),
           jbsdf.fresnel_dielectric(jnp.asarray(c), 1.0, jnp.full(513, 1.5)))


def test_mesh_light(scenes):
    js, ts = scenes
    rs = np.random.RandomState(15)
    p = np.stack([rs.uniform(0, 5, N), rs.uniform(0, 5, N),
                  rs.uniform(0, 4.9, N)], -1).astype(np.float32)
    p[::4, 2] = 4.995            # behind the one-sided light: no emission
    n = _unit(rs, N)
    u1, u2 = rs.rand(2, N).astype(np.float32)
    l = np.zeros(N, np.int32)
    jo = jlights.sample_li(js, jnp.asarray(l), jnp.asarray(p), jnp.asarray(n),
                           jnp.asarray(u1), jnp.asarray(u2))
    to = tlights.sample_li(ts, torch.from_numpy(l), torch.from_numpy(p),
                           torch.from_numpy(n), torch.from_numpy(u1),
                           torch.from_numpy(u2))
    for a, b in zip(to[:4], jo[:4]):
        _close(a, b)
    assert np.array_equal(to[4].numpy(), np.asarray(jo[4]))
    assert (to[1].numpy() > 0).any() and (to[1].numpy() == 0).any()

    light = rs.randint(-1, 1, N).astype(np.int32)
    wi, ng, wo = _unit(rs, N), _unit(rs, N), _unit(rs, N)
    t = rs.uniform(0.1, 6, N).astype(np.float32)
    _close(tlights.pdf_li_area(ts, torch.from_numpy(light),
                               torch.from_numpy(p), torch.from_numpy(wi),
                               torch.from_numpy(t), torch.from_numpy(ng)),
           jlights.pdf_li_area(js, jnp.asarray(light), jnp.asarray(p),
                               jnp.asarray(wi), jnp.asarray(t),
                               jnp.asarray(ng)))
    _close(tlights.area_le(ts, torch.from_numpy(light), torch.from_numpy(ng),
                           torch.from_numpy(wo)),
           jlights.area_le(js, jnp.asarray(light), jnp.asarray(ng),
                           jnp.asarray(wo)), rtol=0, atol=0)
