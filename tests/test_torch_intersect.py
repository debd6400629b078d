"""The port's intersect layer against pbrt_tpu's CPU path on a Cornell
bounce batch (CPU).

pbrt_tpu on the CPU intersects with its BVH and watertight f32 triangle
test; the port with the dense Plücker kernels' plain versions.  Both
re-solve the winner with the same f32 Moller-Trumbore in make_hit.

Tolerances: with identical (t, prim) inputs make_hit agrees to 1e-5
(f32 rounding of the same formulas).  Through trace_pair, hits and
occlusion may differ only where the two triangle tests disagree at an
edge or at t ~ tmax (<= 1% of lanes); where prims agree, t, p and the
normals agree to 1e-4.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.scene import ir as jir
from pbrt_tpu.textures import textures as jtex
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.core import transform as ttfm
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.textures import textures as ttex
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

N = 2048
DEV = "cpu"


def _jray(r):
    return jgeom.Ray.make(*(jnp.asarray(r[k]) for k in ("o", "d")),
                          tmax=jnp.asarray(r["tmax"]),
                          wavelength=jnp.asarray(r["wavelength"]),
                          time=jnp.asarray(r["time"]))


def _tray(r):
    return tgeom.Ray(*(torch.from_numpy(r[k]) for k in
                       ("o", "d", "tmax", "wavelength", "time")))


def _np(ray):
    return {k: np.array(getattr(ray, k), np.float32)
            for k in ("o", "d", "tmax", "wavelength", "time")}


@pytest.fixture(scope="module")
def batch():
    """Camera rays, their JAX hits, and a bounce batch spawned from them:
    random hemisphere directions plus shadow rays toward random points
    on the light."""
    js, _ = jflag.cornell(tessellate=True)
    ts, _ = tflag.cornell(device=DEV)
    rs = np.random.RandomState(12)
    eye = np.array([2.5, -4.5, 2.5], np.float32)
    tgt = np.stack([rs.uniform(0, 5, N), np.full(N, 5.0),
                    rs.uniform(0, 5, N)], -1)
    d = (tgt - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = dict(o=np.tile(eye, (N, 1)), d=d,
               tmax=np.full(N, np.inf, np.float32),
               wavelength=np.full(N, 550.0, np.float32),
               time=np.zeros(N, np.float32))
    hit = jisect.intersect_full(js, _jray(cam))
    p, ng = np.asarray(hit.p), np.asarray(hit.ng)
    valid = np.asarray(hit.valid)
    w = rs.randn(N, 3)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w = np.where(((w * ng).sum(-1) < 0)[:, None], -w, w).astype(np.float32)
    nray = jisect.spawn_ray(jnp.asarray(p), jnp.asarray(ng), jnp.asarray(w),
                            jnp.asarray(cam["wavelength"]))
    nray = _np(nray)
    nray["tmax"] = np.where(valid, nray["tmax"], -1.0).astype(np.float32)
    q = np.stack([rs.uniform(1.8, 3.2, N), rs.uniform(1.8, 3.2, N),
                  np.full(N, 4.99)], -1).astype(np.float32)
    to_q = q - p
    dist = np.linalg.norm(to_q, axis=-1).astype(np.float32)
    sray = jisect.spawn_shadow_ray(
        jnp.asarray(p), jnp.asarray(ng), jnp.asarray(to_q / dist[:, None]),
        jnp.asarray(dist), jnp.asarray(valid), jnp.asarray(cam["wavelength"]))
    return js, ts, cam, nray, _np(sray)


def _compare_hits(jh, th, lanes, tol):
    for k in ("t", "p", "ng", "ns", "uv", "wo"):
        np.testing.assert_allclose(getattr(th, k).numpy()[lanes],
                                   np.asarray(getattr(jh, k))[lanes],
                                   rtol=tol, atol=tol, err_msg=k)
    for k in ("prim", "material", "light"):
        assert np.array_equal(getattr(th, k).numpy()[lanes],
                              np.asarray(getattr(jh, k))[lanes]), k


def test_make_hit_matches_jax(batch):
    js, ts, cam, nray, _ = batch
    for r in (cam, nray):
        jt, jp, _, _, jf = jisect.intersect(js, _jray(r))
        jh = jisect.make_hit(js, _jray(r), jt, jp, jnp.zeros_like(jt),
                             jnp.zeros_like(jt), jf)
        th = tisect.make_hit(ts, _tray(r), torch.from_numpy(np.array(jt)),
                             torch.from_numpy(np.array(jp)),
                             torch.from_numpy(np.array(jf)))
        assert np.array_equal(th.valid.numpy(), np.asarray(jh.valid))
        _compare_hits(jh, th, np.asarray(jf), 1e-5)


def test_camera_intersect_matches_jax(batch):
    js, ts, cam, _, _ = batch
    jh = jisect.intersect_full(js, _jray(cam))
    th = tisect.intersect_full(ts, _tray(cam), presorted=True)
    same = th.prim.numpy() == np.asarray(jh.prim)
    assert same.mean() > 0.99
    _compare_hits(jh, th, same & np.asarray(jh.valid), 1e-4)


def test_trace_pair_matches_jax(batch):
    js, ts, _, nray, sray = batch
    jh, jocc = jisect.trace_pair(js, _jray(nray), _jray(sray))
    th, tocc = tisect.trace_pair(ts, _tray(nray), _tray(sray))
    jv, tv = np.asarray(jh.valid), th.valid.numpy()
    assert (jv != tv).mean() <= 0.01
    same = (th.prim.numpy() == np.asarray(jh.prim)) & jv & tv
    assert same.sum() >= 0.99 * (jv & tv).sum()
    _compare_hits(jh, th, same, 1e-4)
    assert (tocc.numpy() != np.asarray(jocc)).mean() <= 0.01
    assert tocc.numpy().any() and not tocc.numpy().all()
    # dead lanes never hit or occlude
    dead = nray["tmax"] <= 0
    assert not tv[dead].any() and not tocc.numpy()[sray["tmax"] <= 0].any()


def test_spawn_rays_match_jax():
    rs = np.random.RandomState(13)
    p = rs.uniform(-3, 7, (256, 3)).astype(np.float32)
    n = rs.randn(256, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = rs.randn(256, 3).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    dist = rs.uniform(0.1, 5, 256).astype(np.float32)
    cand = rs.rand(256) > 0.3
    wl = np.full(256, 550.0, np.float32)
    jr = jisect.spawn_shadow_ray(*(jnp.asarray(x) for x in
                                   (p, n, w, dist, cand, wl)))
    tr = tisect.spawn_shadow_ray(*(torch.from_numpy(x) for x in
                                   (p, n, w, dist, cand, wl)))
    for k in ("o", "d", "tmax"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=1e-6,
                                   atol=1e-6)
    jr = jisect.spawn_ray(*(jnp.asarray(x) for x in (p, n, w, wl)))
    tr = tisect.spawn_ray(*(torch.from_numpy(x) for x in (p, n, w, wl)))
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o), atol=1e-6)


def _uv_sphere(n=24):
    """A lat-long tessellated unit sphere with vertex normals and uvs."""
    th = np.linspace(0.05, np.pi - 0.05, n)
    ph = np.linspace(0, 2 * np.pi, 2 * n)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                  np.cos(t)], -1).reshape(-1, 3)
    uv = np.stack([p / (2 * np.pi), t / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(2 * n - 1),
                       indexing="ij")
    a = (i * 2 * n + j).ravel()
    idx = np.concatenate([np.stack([a, a + 2 * n, a + 1], -1),
                          np.stack([a + 1, a + 2 * n, a + 2 * n + 1], -1)])
    return v, idx, uv


@pytest.mark.parametrize("textured", [False, True])
def test_make_hit_ray_differentials_match_jax(textured):
    """make_hit(ray_diff=): uv derivatives, footprint offsets and shading
    normal derivatives on a smooth tessellated sphere, a uv-mapped floor
    and a quadric sphere (zeros there), against pbrt_tpu's.  Tolerance:
    the same f32 plane projections and 2x2 solves, 1e-4 relative to each
    column's scale (the solves' conditioning on grazing lanes)."""
    def build(ir, tfm, tex):
        b = ir.SceneBuilder()
        m = b.add_material(ir.MaterialSpec(kd=np.full(31, 0.5, np.float32)))
        v, idx, uv = _uv_sphere()
        b.add_triangle_mesh(v * 1.2 + [2.5, 2.5, 1.5], idx, m, normals=v,
                            uvs=uv)
        b.add_triangle_mesh([[0, 0, 0], [5, 0, 0], [5, 5, 0], [0, 5, 0]],
                            [[0, 1, 2], [2, 3, 0]], m,
                            uvs=[[0, 0], [3, 0], [3, 2], [0, 2]])
        b.add_sphere(tfm.translate(4, 3, 1), 0.6, m)
        if textured:
            b.textures.add(tex.TEX_UV)
        return b.build(device=DEV) if ir is tir else b.build()

    js, ts = build(jir, jtfm, jtex), build(tir, ttfm, ttex)
    rs = np.random.RandomState(21)
    eye = np.array([2.5, -4.5, 2.5], np.float32)
    tgt = np.stack([rs.uniform(0, 5, N), rs.uniform(1.5, 5, N),
                    rs.uniform(0, 3, N)], -1)
    d = (tgt - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = dict(o=np.tile(eye, (N, 1)), d=d,
               tmax=np.full(N, np.inf, np.float32),
               wavelength=np.full(N, 550.0, np.float32),
               time=np.zeros(N, np.float32))
    jr = _jray(cam)
    jt, jp, _, _, jf = jisect.intersect(js, jr)
    step = (rs.randn(2, N, 3) * 2e-3).astype(np.float32)
    rd = (cam["o"] + step[0] * 0.1, d + step[0], cam["o"],
          (d + step[1]).astype(np.float32))
    jh = jisect.make_hit(js, jr, jt, jp, jnp.zeros_like(jt),
                         jnp.zeros_like(jt), jf,
                         ray_diff=tuple(jnp.asarray(x) for x in rd))
    th = tisect.make_hit(ts, _tray(cam), torch.from_numpy(np.array(jt)),
                         torch.from_numpy(np.array(jp)),
                         torch.from_numpy(np.array(jf)),
                         ray_diff=tuple(torch.from_numpy(np.asarray(x))
                                        for x in rd))
    valid = np.asarray(jf)
    _compare_hits(jh, th, valid, 1e-5)
    for k in ("duv", "dpdx", "dpdy", "dndx", "dndy", "uv_density"):
        a, b = getattr(th, k).numpy(), np.asarray(getattr(jh, k))
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
    duv = th.duv.numpy()
    tri = np.asarray(js.prim_type)[np.asarray(jh.prim)] == 0
    assert (np.abs(duv[valid & tri]).sum(-1) > 0).mean() > 0.95
    assert not np.abs(duv[valid & ~tri]).any()          # quadric hits
    assert (np.abs(th.dndx.numpy()).sum(-1) > 0).any()  # smooth normals
    # without differentials: no duv; uv_density only with textures
    plain = tisect.make_hit(ts, _tray(cam), torch.from_numpy(np.array(jt)),
                            torch.from_numpy(np.array(jp)),
                            torch.from_numpy(np.array(jf)))
    assert plain.duv is None
    assert (plain.uv_density is not None) == textured
