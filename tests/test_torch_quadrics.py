"""The port's quadrics (sphere, cylinder, disk, cone, paraboloid) against
pbrt_tpu's on the CPU: `_quadric_ts`, `all_quadrics_test` on static and
two-keyframe transforms, `make_hit`'s normal, uv and uv_density, the
shadow walk's medium switch at a quadric interface, and the
reference-side behaviours the port reproduces (ROADMAP Queue 3 (q), (r)).

Rays are seeded through numpy: 4,096 a case, aimed at points in and
around each quadric's clip box, so both roots, the z clip, the phi clip
and a disk's radius all decide lanes.

Tolerances:
- t within 1e-5 relative where both packages hit (f32 on each side;
  XLA and torch round the same formulas in another order); on moving
  quadrics, whose world-to-object transform each package interpolates
  from the decomposed keyframes in its own f32, within 1e-4 and on >=
  99.5% of lanes within 1e-5 (measured: 3 of 1,423 lanes above 1e-5,
  the largest 1.5e-5);
- hit masks, and the winning quadric, equal on every lane but the seam
  lanes: a lane is a seam lane when, in an f64 evaluation of its
  object-space ray, a root lies within SEAM (1e-4, in object units or
  radians) of a clip edge (z at zmin or zmax, phi at 0 or phimax, a
  disk's radius at r), within 1e-5 of the root cut t > 1e-5 or of
  tmax, or its discriminant within DISC_SEAM (1e-5) of 0 relative to
  its terms (a grazing ray, or one through a cone's apex, where the
  discriminant falls as the square of the ray's distance from it).
  At most MAX_SEAM_SHARE (1%) of a case's lanes may be seam lanes
  (measured: 0.02-0.44%), and the packages part on none of the others;
- make_hit: the normals within 1e-5, u and v within 1e-4 (arccos is
  steep near the poles) but on seam lanes, where u may wrap from ~0 to
  ~1; uv_density within 1e-6 relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.scene import ir as tir
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

B = 4096
SEAM = 1e-4
DISC_SEAM = 1e-5
MAX_SEAM_SHARE = 0.01
TYPES = {"sphere": tir.PRIM_SPHERE, "cylinder": tir.PRIM_CYLINDER,
         "disk": tir.PRIM_DISK, "cone": tir.PRIM_CONE,
         "paraboloid": tir.PRIM_PARABOLOID}
# the port's quadric functions take the types that may occur (a scene's
# quad_kinds): here every one
KINDS = tuple(TYPES.values())
# (radius, zmin, zmax, phimax in degrees) as the parser stores them: a
# disk's (radius, height, innerradius, phimax), a cone's (radius, 0,
# height, phimax)
PARAMS = {"sphere": (0.5, -0.3, 0.45, 270.0),
          "cylinder": (0.5, -0.3, 0.4, 300.0),
          "disk": (0.6, 0.1, 0.25, 290.0),
          "cone": (0.5, 0.0, 0.8, 320.0),
          "paraboloid": (0.5, 0.1, 0.7, 330.0)}
SHAPES = {
    "sphere": '"float radius" [0.5] "float zmin" [-0.3] "float zmax" [0.45]'
              ' "float phimax" [270]',
    "cylinder": '"float radius" [0.5] "float zmin" [-0.3] "float zmax" '
                '[0.4] "float phimax" [300]',
    "disk": '"float radius" [0.6] "float height" [0.1] "float innerradius" '
            '[0.25] "float phimax" [290]',
    "cone": '"float radius" [0.5] "float height" [0.8] "float phimax" [320]',
    "paraboloid": '"float radius" [0.5] "float zmin" [0.1] "float zmax" '
                  '[0.7] "float phimax" [330]'}
CENTRES = {"sphere": (2, 0, 0), "cylinder": (-2, 0, 0), "disk": (-1, 0, 0),
           "cone": (0, 0, 0), "paraboloid": (1, 0, 0)}


def _t(x):
    return torch.from_numpy(np.array(x))


def scene_text(moving=False, medium=False):
    """Each quadric at its centre, turned about x and z; with moving, each
    shifted by (0.2, 0.3, 0) over the shutter; with medium, each a
    material-less interface of homogeneous "ink" inside."""
    out = ['LookAt 0 -6 0  0 0 0  0 0 1\nCamera "perspective"\n'
           'Film "image" "integer xresolution" [8] "integer yresolution" '
           '[8]\n']
    if medium:
        out.append('MakeNamedMedium "ink" "string type" "homogeneous" '
                   '"rgb sigma_a" [0.8 0.6 0.4] "rgb sigma_s" [0.2 0.2 0.2]'
                   '\n')
    out.append("WorldBegin\n")
    for i, (name, shape) in enumerate(SHAPES.items()):
        cx, cy, cz = CENTRES[name]
        out.append(f"AttributeBegin\nTranslate {cx} {cy} {cz}\n"
                   f"Rotate {25 + 40 * i} 1 0.3 0\nRotate {70 * i} 0 0 1\n")
        if moving:
            out.append("ActiveTransform EndTime\nTranslate 0.2 0.3 0\n"
                       "ActiveTransform All\n")
        if medium:
            out.append('Material ""\nMediumInterface "ink" ""\n')
        out.append(f'Shape "{name}" {shape}\nAttributeEnd\n')
    out.append("WorldEnd\n")
    return "".join(out)


@pytest.fixture(scope="module")
def scenes():
    return {m: (JAPI().parse_string(scene_text(m)).scene,
                TAPI("cpu").parse_string(scene_text(m)).scene)
            for m in (False, True)}


def world_rays(seed, n=B):
    """Origins around the row of quadrics, aimed at points in and around
    each one's box; tmax cuts some lanes short; times in [-0.2, 1.2]."""
    rs = np.random.RandomState(seed)
    target = np.array([CENTRES[k] for k in SHAPES], np.float64)[
        rs.randint(0, len(SHAPES), n)] + rs.uniform(-0.8, 0.8, (n, 3))
    o = target + rs.normal(size=(n, 3)) * 2.5
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rs.rand(n) < 0.1, rs.uniform(0.5, 3.0, n), 1e30)
    time = rs.uniform(-0.2, 1.2, n)
    return (o.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32), time.astype(np.float32))


def object_rays(name, seed, n=B):
    """Object-space rays at one quadric: origins on a radius-2.5 shell,
    aimed at points in its clip box grown by 0.3."""
    rs = np.random.RandomState(seed)
    r, z0, z1, _ = PARAMS[name]
    lo = np.array([-r, -r, min(z0, z1)]) - 0.3
    hi = np.array([r, r, max(z0, z1)]) + 0.3
    if name == "disk":
        lo[2], hi[2] = z0 - 0.3, z0 + 0.3
    target = rs.uniform(lo, hi, (n, 3))
    o = rs.normal(size=(n, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _params(name):
    r, z0, z1, phimax = PARAMS[name]
    return np.array([r, z0, z1, np.radians(phimax)], np.float32)


def seam_lanes(qtype, params, oo, od, tmax):
    """[...] bool: lanes within SEAM of a decision edge, in f64 (module
    docstring).  qtype [Q], params [Q,4], oo / od [B,Q,3], tmax [B]."""
    qtype = qtype[None]
    r, zmin, zmax, phimax = (params[None, :, k].astype(np.float64)
                             for k in range(4))
    o, d = oo.astype(np.float64), od.astype(np.float64)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    cyl, disk = qtype == tir.PRIM_CYLINDER, qtype == tir.PRIM_DISK
    cone, par = qtype == tir.PRIM_CONE, qtype == tir.PRIM_PARABOLOID
    a = dx * dx + dy * dy + dz * dz
    b = 2 * (dx * ox + dy * oy + dz * oz)
    c = ox * ox + oy * oy + oz * oz - r * r
    a, b, c = (np.where(cyl, x, y) for x, y in zip(
        (dx * dx + dy * dy, 2 * (dx * ox + dy * oy),
         ox * ox + oy * oy - r * r),
        (a, b, c)))
    h = np.where(zmax == 0, 1.0, zmax)
    k = (r / h) ** 2
    a, b, c = (np.where(cone, x, y) for x, y in zip(
        (dx * dx + dy * dy - k * dz * dz,
         2 * (dx * ox + dy * oy - k * dz * (oz - h)),
         ox * ox + oy * oy - k * (oz - h) ** 2), (a, b, c)))
    kp = zmax / np.where(r == 0, 1.0, r * r)
    a, b, c = (np.where(par, x, y) for x, y in zip(
        (kp * (dx * dx + dy * dy), 2 * kp * (dx * ox + dy * oy) - dz,
         kp * (ox * ox + oy * oy) - oz), (a, b, c)))
    disc = b * b - 4 * a * c
    near = ~disk & (np.abs(disc) <= DISC_SEAM * (b * b + 4 * np.abs(a * c)))
    sq = np.sqrt(np.maximum(disc, 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        roots = [(-b - sq) / (2 * a), (-b + sq) / (2 * a)]
        t_disk = (zmin - oz) / dz
    roots = [np.where(disk, t_disk, x) for x in roots]
    for t in roots:
        t = np.where(np.isfinite(t), t, -1.0)
        p = o + t[..., None] * d
        zlo, zhi = np.minimum(zmin, zmax), np.maximum(zmin, zmax)
        phi = np.arctan2(p[..., 1], p[..., 0]) % (2 * np.pi)
        rad = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        edge = ((np.minimum(np.abs(p[..., 2] - zlo), np.abs(p[..., 2] - zhi))
                 < SEAM) & ~disk) | (disk & (np.abs(rad - r) < SEAM))
        edge |= (np.abs(phi - phimax) < SEAM) | (phi < SEAM) \
            | (phi > 2 * np.pi - SEAM)
        edge |= (np.abs(t - 1e-5) < 1e-5) \
            | (np.abs(t - tmax[:, None]) < 1e-5 * np.abs(t))
        near |= edge & (t > 0)
    return near


@pytest.mark.parametrize("name", list(TYPES))
def test_quadric_ts_matches_jax(name):
    """Both roots and their validity, in object space."""
    o, d = object_rays(name, seed=11 + len(name))
    q = np.full((B, 1), TYPES[name], np.int32)
    par = np.broadcast_to(_params(name), (B, 1, 4)).copy()
    jt0, jt1, jok = (np.asarray(x)[:, 0] for x in jisect._quadric_ts(
        jnp.asarray(q), jnp.asarray(par), jnp.asarray(o[:, None]),
        jnp.asarray(d[:, None])))
    tt0, tt1, tok = (x.numpy()[:, 0] for x in tisect._quadric_ts(
        _t(q), _t(par), _t(o[:, None]), _t(d[:, None]), KINDS))
    seam = seam_lanes(q[0], par[0], o[:, None], d[:, None],
                      np.full(B, 1e30, np.float32))[:, 0]
    assert seam.mean() <= MAX_SEAM_SHARE
    assert np.array_equal(tok[~seam], jok[~seam])
    both = tok & jok & ~seam
    assert both.mean() > 0.3
    for a, b in ((tt0, jt0), (tt1, jt1)):
        np.testing.assert_allclose(a[both], b[both], rtol=1e-5, atol=1e-7)


def _object_space(scene, o, d, time):
    """Each ray in each quadric's object space, as the port transforms it
    (f32), for the seam test."""
    if scene.has_animated_quads:
        w = tisect._animated_quad_w2o(scene, _t(time))
    else:
        w = scene.quad_w2o[None, :, :3].expand(o.shape[0], -1, -1, -1)
    w = w.numpy().astype(np.float64)
    oo = np.einsum("bqij,bj->bqi", w[..., :3], o) + w[..., 3]
    od = np.einsum("bqij,bj->bqi", w[..., :3], d)
    return oo, od


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_all_quadrics_test_matches_jax(scenes, moving):
    js, ts = scenes[moving]
    assert ts.clip_quadrics and ts.has_animated_quads == moving
    o, d, tmax, time = world_rays(seed=5 + moving)
    jt, jp, jh = (np.asarray(x) for x in jisect.all_quadrics_test(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        time=jnp.asarray(time)))
    tt, tp, th = (x.numpy() for x in tisect.all_quadrics_test(
        ts, _t(o), _t(d), _t(tmax), _t(time)))
    oo, od = _object_space(ts, o, d, time)
    seam = seam_lanes(ts.quad_type.numpy(), ts.quad_params.numpy(), oo, od,
                      tmax).any(1)
    assert seam.mean() <= MAX_SEAM_SHARE
    assert np.array_equal(th[~seam], jh[~seam])
    both = th & jh & ~seam
    assert 0.2 < both.mean() < 0.9
    assert np.array_equal(tp[both], jp[both])
    np.testing.assert_allclose(tt[both], jt[both],
                               rtol=1e-4 if moving else 1e-5)
    rel = np.abs(tt[both] - jt[both]) / np.abs(jt[both])
    assert (rel <= 1e-5).mean() >= 0.995
    # every type was hit on some lane
    hit_types = ts.prim_type[torch.from_numpy(tp[both]).long()]
    assert set(hit_types.tolist()) == set(TYPES.values())


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_make_hit_matches_jax(scenes, moving):
    """make_hit on pbrt_tpu's own intersection of the same rays: the
    geometric and shading normals, uv and uv_density of every type."""
    js, ts = scenes[moving]
    o, d, _, time = world_rays(seed=9 + moving)
    jray = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d),
                          time=jnp.asarray(time))
    t, prim, u, v, found = jisect.intersect(js, jray)
    jh = jisect.make_hit(js, jray, t, prim, u, v, found)
    tray = tgeom.Ray.make(_t(o), _t(d), time=_t(time))
    # (a ray_diff makes the port compute uv_density without textures)
    th = tisect.make_hit(ts, tray, _t(np.asarray(t)),
                         _t(np.asarray(prim)), _t(np.asarray(found)),
                         ray_diff=(tray.o, tray.d, tray.o, tray.d))
    hit = np.asarray(found)
    oo, od = _object_space(ts, o, d, time)
    seam = seam_lanes(ts.quad_type.numpy(), ts.quad_params.numpy(), oo, od,
                      np.full(B, 1e30, np.float32)).any(1)
    ok = hit & ~seam
    assert ok.mean() > 0.2
    for f, tol in (("ng", 1e-5), ("ns", 1e-5), ("uv", 1e-4), ("p", 1e-5)):
        np.testing.assert_allclose(getattr(th, f).numpy()[ok],
                                   np.asarray(getattr(jh, f))[ok],
                                   rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(th.uv_density.numpy()[ok],
                               np.asarray(jh.uv_density)[ok], rtol=1e-6)
    types = ts.prim_type[th.prim].numpy()[ok]
    assert set(types.tolist()) == set(TYPES.values())


def test_disk_ignores_innerradius_as_in_jax():
    """(q): a disk's innerradius is stored but not clipped, and its v is
    rhit / r, in both packages (pbrt: (r - rhit) / (r - ri))."""
    r, h, ri = 0.6, 0.1, 0.25
    par = np.array([[[r, h, ri, 2 * np.pi]]], np.float32)
    q = np.array([[tir.PRIM_DISK]], np.int32)
    o = np.array([[[0.1, 0.05, 2.0]]], np.float32)      # through the hole
    d = np.array([[[0.0, 0.0, -1.0]]], np.float32)
    for ts in (lambda: jisect._quadric_ts(*map(jnp.asarray, (q, par, o, d))),
               lambda: tisect._quadric_ts(*map(_t, (q, par, o, d)), KINDS)):
        t0, _, ok = ts()
        assert bool(np.asarray(ok)[0, 0])
        np.testing.assert_allclose(np.asarray(t0)[0, 0], 1.9, rtol=1e-6)
    ph = np.array([[0.3, 0.0, h]], np.float32)
    qt = np.array([tir.PRIM_DISK], np.int32)
    jv = np.asarray(jisect.quadric_uv(jnp.asarray(qt), jnp.asarray(par[0]),
                                      jnp.asarray(ph))[1])
    tv = tisect.quadric_uv(_t(qt), _t(par[0]), _t(ph), KINDS)[1].numpy()
    np.testing.assert_allclose(tv, 0.3 / r, rtol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


@pytest.mark.parametrize("name", ["cylinder", "cone", "paraboloid"])
def test_v_is_the_spheres_for_every_type_as_in_jax(name):
    """(r): a cylinder's, cone's and paraboloid's v is the sphere's
    arccos(z / r) / pi, as in pbrt_tpu (pbrt: (z - zmin) / (zmax - zmin))."""
    rs = np.random.RandomState(3)
    par = np.broadcast_to(_params(name), (64, 4)).copy()
    ph = rs.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    qt = np.full(64, TYPES[name], np.int32)
    tv = tisect.quadric_uv(_t(qt), _t(par), _t(ph), KINDS)[1].numpy()
    zc = np.clip(ph[:, 2] / par[:, 0], -1 + 1e-6, 1 - 1e-6)
    np.testing.assert_allclose(tv, np.arccos(zc) / np.pi, rtol=1e-6)
    jv = np.asarray(jisect.quadric_uv(jnp.asarray(qt), jnp.asarray(par),
                                      jnp.asarray(ph))[1])
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_uv_gradient_guards_keep_gradients_finite():
    """At the guards' points (the axis, where atan2 and the disk's sqrt
    have infinite derivatives; a pole, where arccos does) the gradient of
    a loss that uses uv, and of one that does not, stays finite."""
    ph = torch.tensor([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5], [0.0, 0.0, 0.1],
                       [0.3, 0.2, 0.1]], requires_grad=True)
    par = torch.tensor([[0.5, -0.5, 0.5, 2 * np.pi]] * 4)
    for qtype in TYPES.values():
        qt = torch.full((4,), qtype, dtype=torch.int32)
        u, v = tisect.quadric_uv(qt, par, ph, KINDS)
        n = tisect.quadric_normal_obj(qt, par, ph, KINDS)
        for loss in ((u + v).sum(), (0 * u + 0 * v).sum() + n.sum()):
            g, = torch.autograd.grad(loss, ph, retain_graph=True)
            assert torch.isfinite(g).all(), qtype


def test_tr_walk_switches_media_at_quadric_interfaces():
    """intersect_tr_walk through material-less quadric interfaces of ink:
    the medium switch takes each type's own normal (quadric_normal_obj),
    so the optical depth and blocked lanes equal pbrt_tpu's."""
    text = scene_text(medium=True)
    js = JAPI().parse_string(text).scene
    ts = TAPI("cpu").parse_string(text).scene
    o, d, _, _ = world_rays(seed=21, n=1024)
    dist = np.full(1024, 6.0, np.float32)
    cand = np.ones(1024, bool)
    cur = np.full(1024, -1, np.int32)
    jb, jo, _ = jisect.intersect_tr_walk(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
        jnp.asarray(cand), jnp.asarray(cur), jnp.full(1024, 550.0))
    tb, to, _ = tisect.intersect_tr_walk(
        ts, _t(o), _t(d), _t(dist), _t(cand), _t(cur),
        torch.full((1024,), 550.0))
    assert not np.asarray(jb).any() and not tb.any()
    jo = np.asarray(jo)
    inside = jo[:, 0] > 0
    assert 0.2 < inside.mean() < 0.95
    close = np.isclose(to.numpy(), jo, rtol=1e-4, atol=1e-5).all(1)
    assert close.mean() >= 0.995
