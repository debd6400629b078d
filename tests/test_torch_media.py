"""The port's participating media (media/presets.py, media/media.py), the
parser's media tables and the shadow-transmittance walk
(ops/intersect.py::intersect_tr_walk) against pbrt_tpu on the same inputs
(CPU).

pbrt_tpu's functions run eagerly (its 64-step tracking loops are Python
loops, slow to compile as one program) or, where they hold a fori_loop,
jitted.

Tolerances, each with the figure measured on the CPU:
- the presets, the parsed media tables and the camera medium: equal;
- the counter-based samples, the media kinds' discrete outcomes
  (interacted, live, blocked) and the grid lookups: equal;
- continuous outputs: within 1e-5 relative plus 1e-6 of the largest
  value (measured <= 1.2e-6 absolute): the same f32 formulas, whose
  matrix products and 31-bin means may round in another order;
- HG: the phase function integrates to 1 over the sphere within 1e-4
  (f64 quadrature), and hg_sample's pdf is hg_p at the sampled
  direction within 1e-5.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.media import media as jmed
from pbrt_tpu.media import presets as jpre
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu_torch.media import media as tmed
from pbrt_tpu_torch.media import presets as tpre
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.scene import ir as tir
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {n: os.path.join(ROOT, "scenes", n + ".pbrt")
          for n in ("volpath_bench", "smoke_glass")}
B = 2048
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    scale = max(float(np.abs(b).max()), 1e-30) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def rays():
    """Rays through the unit cube's neighbourhood, segment lengths, the
    samples' pixel ids and sample indices (uint32 in pbrt_tpu, int64
    words in the port)."""
    rs = np.random.RandomState(51)
    o = rs.uniform(-1.5, 1.5, (B, 3)).astype(np.float32)
    d = rs.randn(B, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rs.uniform(0.1, 4.0, B).astype(np.float32)
    pid = rs.randint(0, 1 << 20, B).astype(np.uint32)
    sidx = rs.randint(0, 64, B).astype(np.uint32)
    return dict(o=o, d=d, tmax=tmax, pid=pid, sidx=sidx)


def _args(r):
    """(pbrt_tpu's, the port's) (o, d, tmax, pixel_id, sample_idx)."""
    j = tuple(jnp.asarray(r[k]) for k in ("o", "d", "tmax", "pid", "sidx"))
    t = (_t(r["o"]), _t(r["d"]), _t(r["tmax"]),
         _t(r["pid"].astype(np.int64)), _t(r["sidx"].astype(np.int64)))
    return j, t


SIGMA_A = np.linspace(0.05, 0.5, 31).astype(np.float32)
SIGMA_S = np.linspace(1.0, 0.1, 31).astype(np.float32)
DENSITY = np.random.RandomState(52).uniform(0, 2, (4, 5, 6)).astype(
    np.float32)
M2W = np.diag([2.0, 3.0, 2.5, 1.0])
M2W[:3, 3] = [-1.0, -1.5, -1.0]


def _media(kind):
    if kind == "homogeneous":
        return (jmed.make_homogeneous(SIGMA_A, SIGMA_S, 0.3),
                tmed.make_homogeneous(SIGMA_A, SIGMA_S, 0.3))
    if kind == "grid":
        return (jmed.make_grid(SIGMA_A, SIGMA_S, 0.3, DENSITY, M2W),
                tmed.make_grid(SIGMA_A, SIGMA_S, 0.3, DENSITY, M2W))
    return jmed.no_medium(), tmed.no_medium()


def test_presets_match_jax():
    assert tpre.MEASURED_SS == jpre.MEASURED_SS
    for name in list(jpre.MEASURED_SS) + ["skin1", "WHOLEMILK", "nothing"]:
        a = tpre.get_medium_scattering_properties(name)
        b = jpre.get_medium_scattering_properties(name)
        assert (a is None) == (b is None), name
        if a is not None:
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("g", [-0.6, 0.0, 0.0005, 0.3, 0.9])
def test_hg_matches_jax(g):
    """hg_p and hg_sample against pbrt_tpu; the phase function's
    normalization and sampling pdf.  (For g < 0 both packages divide by
    max(2 g, -1e-6) in hg_sample, which sends every sample to cos = +-1:
    pbrt_tpu's form, kept.)"""
    rs = np.random.RandomState(53)
    cos = rs.uniform(-1, 1, B).astype(np.float32)
    _close(tmed.hg_p(torch.tensor(g), _t(cos)), jmed.hg_p(g, cos))
    wo = rs.randn(B, 3).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u1, u2 = rs.rand(2, B).astype(np.float32)
    twi, tpdf = tmed.hg_sample(torch.tensor(g), _t(wo), _t(u1), _t(u2))
    jwi, jpdf = jmed.hg_sample(jnp.float32(g), jnp.asarray(wo),
                               jnp.asarray(u1), jnp.asarray(u2))
    _close(twi, jwi, atol=1e-5)
    _close(tpdf, jpdf)
    # the sampled pdf is the phase function at the sampled direction
    cos_s = (twi * -_t(wo)).sum(-1)
    _close(tpdf, tmed.hg_p(torch.tensor(g), cos_s), rtol=1e-4, atol=1e-5)
    # 2 pi * integral over cos of p: 1
    c = np.linspace(-1, 1, 200001)
    p = tmed.hg_p(torch.tensor(g, dtype=torch.float64),
                  torch.from_numpy(c)).numpy()
    assert abs(2 * np.pi * np.trapezoid(p, c) - 1) < 1e-4


@pytest.mark.parametrize("kind", ["homogeneous", "grid", "none"])
def test_sample_distance_and_transmittance_match_jax(rays, kind):
    jm, tm = _media(kind)
    (jo, jd, jt, jp, js), (to, td, tt, tp, ts) = _args(rays)
    t_t, i_t, w_t = tmed.sample_distance(tm, to, td, tt, tp, ts, 0x9000)
    t_j, i_j, w_j = jmed.sample_distance(jm, jo, jd, jt, jp, js, 0x9000)
    assert np.array_equal(_np(i_t), np.asarray(i_j))
    _close(t_t, t_j)
    _close(torch.broadcast_to(w_t, (B, 31)), jnp.broadcast_to(w_j, (B, 31)))
    tr_t = tmed.transmittance(tm, to, td, tt, tp, ts, 0x9080)
    tr_j = jmed.transmittance(jm, jo, jd, jt, jp, js, 0x9080)
    _close(tr_t, tr_j)
    if kind == "grid":
        assert 0.1 < float(np.asarray(i_j).mean()) < 0.9
        assert float(_np(tr_t).min()) < 0.5
        _close(tmed.density_at(tm, to), jmed.density_at(jm, jo))
        for a, b in zip(tmed._grid_span(tm, to, td, tt),
                        jmed._grid_span(jm, jo, jd, jt)):
            _close(a, b, atol=1e-5)


def _lane_tables(rays):
    """A two-medium table (the grid above and a 3x2x4 grid) and each
    lane's medium."""
    g2 = np.random.RandomState(54).uniform(0, 3, (3, 2, 4)).astype(
        np.float32)
    dens = np.zeros((2, 4, 5, 6), np.float32)
    dens[0] = DENSITY
    dens[1, :3, :2, :4] = g2
    dims = np.array([[4, 5, 6], [3, 2, 4]], np.int32)
    w2m = np.stack([np.linalg.inv(M2W), np.linalg.inv(np.diag(
        [1.5, 1.0, 2.0, 1.0]))]).astype(np.float32)
    inv_maxd = np.array([1 / DENSITY.max(), 1 / g2.max()], np.float32)
    mk = (np.arange(B) % 2).astype(np.int32)
    st = np.array([1.2, 3.0], np.float32)[mk]
    return dens, dims, w2m, inv_maxd, mk, st


def test_lane_media_match_jax(rays):
    """The per-lane forms: free flight in homogeneous lanes (vacuum
    lanes too), Tr, the medium-space transform and span, the trilinear
    lookup, delta and ratio tracking through each lane's own grid."""
    (jo, jd, jt, jp, js), (to, td, tt, tp, ts) = _args(rays)
    rs = np.random.RandomState(55)
    sa = rs.uniform(0, 0.5, (B, 31)).astype(np.float32)
    ss = rs.uniform(0, 1.5, (B, 31)).astype(np.float32)
    sa[::7] = ss[::7] = 0.0                               # vacuum lanes
    out_t = tmed.sample_distance_lanes(_t(sa), _t(ss), tt, tp, ts, 0x9100)
    out_j = jmed.sample_distance_lanes(jnp.asarray(sa), jnp.asarray(ss), jt,
                                       jp, js, 0x9100)
    assert np.array_equal(_np(out_t[1]), np.asarray(out_j[1]))
    _close(out_t[0], out_j[0])
    _close(out_t[2], out_j[2])
    _close(tmed.transmittance_lanes(_t(sa + ss), tt),
           jmed.transmittance_lanes(jnp.asarray(sa + ss), jt))
    dens, dims, w2m, imd, mk, st = _lane_tables(rays)
    T = [_t(x) for x in (dens, dims, w2m[mk], imd[mk], st)]
    J = [jnp.asarray(x) for x in (dens, dims, w2m[mk], imd[mk], st)]
    tmk, jmk = _t(mk.astype(np.int64)), jnp.asarray(mk)
    om_t, dm_t = tmed._to_medium_lanes(T[2], to, td)
    om_j, dm_j = jmed._to_medium_lanes(J[2], jo, jd)
    _close(om_t, om_j)
    _close(dm_t, dm_j)
    for a, b in zip(tmed._grid_span_m(om_t, dm_t, tt),
                    jmed._grid_span_m(om_j, dm_j, jt)):
        _close(a, b, atol=1e-5)
    _close(tmed.density_at_lanes(T[0], T[1], tmk, om_t),
           jmed.density_at_lanes(J[0], J[1], jmk, om_j))
    tg = tmed.sample_distance_grid_lanes(*T, to, td, tt, tmk, tp, ts, 0x9208)
    jg = jax.jit(jmed.sample_distance_grid_lanes, static_argnums=11)(
        *J, jo, jd, jt, jmk, jp, js, 0x9208)
    assert np.array_equal(_np(tg[1]), np.asarray(jg[1]))
    assert 0.1 < float(_np(tg[1]).mean()) < 0.9
    _close(tg[0], jg[0])
    tr_t = tmed.ratio_tr_lanes(*T, to, td, tt, tmk, tp, ts, 0x7440)
    tr_j = jax.jit(jmed.ratio_tr_lanes, static_argnums=11)(
        *J, jo, jd, jt, jmk, jp, js, 0x7440)
    _close(tr_t, tr_j)
    assert float(_np(tr_t).min()) < 0.5


def test_early_exit_gives_every_step_result(rays, monkeypatch):
    """The tracking loops' early exit (a host sync every TRACK_CHECK
    steps) returns what running every step returns."""
    _, (to, td, tt, tp, ts) = _args(rays)
    _, tm = _media("grid")
    dens, dims, w2m, imd, mk, st = _lane_tables(rays)
    T = [_t(x) for x in (dens, dims, w2m[mk], imd[mk], st)]
    tmk = _t(mk.astype(np.int64))

    def run():
        return (tmed.sample_distance(tm, to, td, tt, tp, ts, 0x9000)[:2]
                + (tmed.transmittance(tm, to, td, tt, tp, ts, 0x9080),)
                + tmed.sample_distance_grid_lanes(*T, to, td, tt, tmk, tp, ts,
                                                  0x9208)
                + (tmed.ratio_tr_lanes(*T, to, td, tt, tmk, tp, ts, 0x7440),))

    steps = []
    inner = tmed._live
    monkeypatch.setattr(tmed, "_live", lambda live, k: (
        steps.append(k), inner(live, k))[1])
    early = run()
    monkeypatch.setattr(tmed, "_live", lambda live, k: True)
    full = run()
    # the early exit stopped some loops before their last step
    assert min(steps) < tmed.LANE_TRACK_STEPS - 1
    assert len(steps) < 2 * (tmed.MAX_TRACK_STEPS + tmed.LANE_TRACK_STEPS)
    for a, b in zip(early, full):
        assert torch.equal(a, b)


def test_lane_track_steps_truncate_as_in_jax(rays, monkeypatch):
    """LANE_TRACK_STEPS = 32 (pbrt_tpu/media/media.py:299, kept): in a
    grid thick enough to need more majorant steps, ratio tracking stops
    after 32 with the lanes still live, so Tr is higher than with more
    steps, as in pbrt_tpu."""
    assert tmed.LANE_TRACK_STEPS == jmed.LANE_TRACK_STEPS == 32
    (jo, jd, jt, jp, js), (to, td, tt, tp, ts) = _args(rays)
    dens, dims, w2m, imd, mk, _ = _lane_tables(rays)
    st = np.full(B, 40.0, np.float32)          # ~40 flights a unit
    T = [_t(x) for x in (dens, dims, w2m[mk], imd[mk], st)]
    J = [jnp.asarray(x) for x in (dens, dims, w2m[mk], imd[mk], st)]
    tmk = _t(mk.astype(np.int64))
    tr = tmed.ratio_tr_lanes(*T, to, td, tt, tmk, tp, ts, 0x7440)
    _close(tr, jax.jit(jmed.ratio_tr_lanes, static_argnums=11)(
        *J, jo, jd, jt, jnp.asarray(mk), jp, js, 0x7440))
    monkeypatch.setattr(tmed, "LANE_TRACK_STEPS", 512)
    tr_long = tmed.ratio_tr_lanes(*T, to, td, tt, tmk, tp, ts, 0x7440)
    cut = (tr - tr_long).abs() > 1e-6
    assert cut.any() and (tr[cut] > tr_long[cut]).all()


@pytest.fixture(scope="module")
def jobs():
    return {n: (jparse(p), tparse(p, device="cpu")) for n, p in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_media_tables_match_jax(jobs, name):
    """The parser's media on the two media scenes: every media column,
    the camera medium and the bound names equal pbrt_tpu's, in its
    primitive order."""
    jj, tj = jobs[name]
    for k in tir.MEDIA_COLUMNS:
        a, b = np.asarray(getattr(jj.scene, k)), getattr(tj.scene, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("has_prim_media", "has_grid_media", "camera_medium"):
        assert getattr(jj.scene, k) == getattr(tj.scene, k), k
    assert tj.prim_media_names == jj.prim_media_names
    assert tj.scene.has_prim_media
    assert tj.scene.camera_medium == (0 if name == "volpath_bench" else -1)
    assert tj.scene.has_grid_media == (name == "smoke_glass")


PRESET_SCENE = """LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective"
WorldBegin
MakeNamedMedium "milk" "string type" "homogeneous" "string preset" "Skimmilk"
    "float scale" [2.5] "float g" [0.4]
MakeNamedMedium "ink" "string type" "homogeneous" "rgb sigma_a" [1 2 3]
    "string preset" "Ketchup"
Translate 0.5 0 0
MakeNamedMedium "grid" "string type" "grid" "integer nx" [2] "integer ny" [1]
    "integer nz" [1] "float density" [0.5 2] "point p0" [-1 -1 -1]
    "point p1" [1 2 1]
MakeNamedMedium "unused" "string type" "homogeneous"
AttributeBegin
MediumInterface "milk" "ink"
Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
MediumInterface "grid"
Shape "sphere" "float radius" [0.5]
MediumInterface "nowhere" ""
Shape "sphere" "float radius" [0.25]
AttributeEnd
WorldEnd
"""


def test_presets_scale_and_grid_ctm_parse_like_jax():
    """A preset with scale, a preset overridden by sigma_a, a grid made
    under a translation, an interface naming an unknown medium (vacuum,
    with a warning) and a medium no interface binds."""
    js = JAPI().parse_string(PRESET_SCENE)
    ts = TAPI("cpu").parse_string(PRESET_SCENE)
    for k in tir.MEDIA_COLUMNS:
        a, b = np.asarray(getattr(js.scene, k)), getattr(ts.scene, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert ts.prim_media_names == js.prim_media_names == ("milk", "ink",
                                                          "grid")
    assert sorted(ts.media) == ["grid", "ink", "milk", "unused"]


def _walk_inputs(scene_np_dev, n=B, seed=56):
    """Shadow segments from points around the smoke sphere toward points
    on the far side, half of them starting inside it."""
    rs = np.random.RandomState(seed)
    org = rs.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    org[::2] *= 0.5
    to = rs.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    to[:, 2] = 3.9
    d = to - org
    dist = np.linalg.norm(d, axis=-1).astype(np.float32)
    wi = (d / dist[:, None]).astype(np.float32)
    cur = np.where(np.linalg.norm(org, axis=-1) < 1.0, 0, -1).astype(np.int32)
    cand = rs.rand(n) < 0.9
    pid = rs.randint(0, 1 << 16, n).astype(np.uint32)
    sidx = rs.randint(0, 32, n).astype(np.uint32)
    return org, wi, dist * 0.999, cand, cur, pid, sidx


@pytest.mark.parametrize("pixels", [True, False], ids=["ratio", "no-ids"])
def test_tr_walk_matches_jax(jobs, pixels):
    """intersect_tr_walk on smoke_glass.pbrt (a grid inside a glass
    sphere, the area light's own mesh excluded as the sampled light):
    the same blocked lanes, optical depth and ratio-tracked Tr.  Without
    pixel ids the grid counts as homogeneous at its unscaled sigma_t
    (pbrt_tpu/ops/intersect.py:806-809, kept): tr_ratio is 1 and the
    optical depth holds the grid lanes' sigma_t * length."""
    jj, tj = jobs["smoke_glass"]
    org, wi, dist, cand, cur, pid, sidx = _walk_inputs(None)
    ign = np.full(B, int(np.asarray(jj.scene.prim_light).max()), np.int32)
    kw_j = dict(ignore_light=jnp.asarray(ign))
    kw_t = dict(ignore_light=_t(ign.astype(np.int64)))
    if pixels:
        kw_j.update(pixel_id=jnp.asarray(pid), sample_idx=jnp.asarray(sidx))
        kw_t.update(pixel_id=_t(pid.astype(np.int64)),
                    sample_idx=_t(sidx.astype(np.int64)))
    jb, jo, jr = jisect.intersect_tr_walk(
        jj.scene, jnp.asarray(org), jnp.asarray(wi), jnp.asarray(dist),
        jnp.asarray(cand), jnp.asarray(cur), jnp.full(B, 550.0), **kw_j)
    tb, to, tr = tisect.intersect_tr_walk(
        tj.scene, _t(org), _t(wi), _t(dist), _t(cand), _t(cur),
        torch.full((B,), 550.0), **kw_t)
    assert np.array_equal(_np(tb), np.asarray(jb))
    _close(to, jo)
    _close(tr, jr)
    assert 0.05 < float(_np(tb).mean()) < 0.95
    if pixels:
        assert float(_np(tr).min()) < 0.9
    else:
        assert (_np(tr) == 1.0).all() and float(_np(to).max()) > 0.1


def test_tr_walk_truncation_contract():
    """tests/test_media_interface.py's five nested material-less ink
    shells: 10 crossings with max_crossings 12 give the exact optical
    depth 1.0; max_crossings 4 stops after 4 (0.45, never more than the
    exact depth), in both packages."""
    shells = "\n".join(
        f'AttributeBegin\nMaterial ""\nMediumInterface "ink" ""\n'
        f'Shape "sphere" "float radius" [{0.2 + 0.15 * i}]\n'
        f'AttributeEnd' for i in range(5))
    src = (
        'LookAt 0 0 -4  0 0 0  0 1 0\nCamera "perspective"\n'
        'Film "image" "integer xresolution" [4] '
        '"integer yresolution" [4]\n'
        'Integrator "volpath"\nWorldBegin\n'
        'MakeNamedMedium "ink" "string type" "homogeneous" '
        '"color sigma_a" [1 1 1] "color sigma_s" [0 0 0]\n'
        + shells + '\n'
        'AttributeBegin\nAreaLightSource "area" "color L" [5 5 5]\n'
        'Translate 0 0 6\n'
        'Shape "trianglemesh" "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]'
        ' "integer indices" [0 1 2 2 3 0]\nAttributeEnd\nWorldEnd\n')
    js, ts = JAPI().parse_string(src).scene, TAPI("cpu").parse_string(
        src).scene
    n = 8
    org = np.tile(np.float32([[0, 0, -3]]), (n, 1))
    wi = np.tile(np.float32([[0, 0, 1]]), (n, 1))
    args_j = (jnp.asarray(org), jnp.asarray(wi), jnp.full(n, 6.0),
              jnp.ones(n, bool), jnp.full(n, -1, jnp.int32),
              jnp.full(n, 550.0))
    args_t = (_t(org), _t(wi), torch.full((n,), 6.0),
              torch.ones(n, dtype=torch.bool),
              torch.full((n,), -1, dtype=torch.int32), torch.full((n,), 550.0))
    opt = {}
    for mc in (12, 4):
        jb, jo, _ = jisect.intersect_tr_walk(js, *args_j, max_crossings=mc)
        tb, to, _ = tisect.intersect_tr_walk(ts, *args_t, max_crossings=mc)
        assert not _np(tb).any() and not np.asarray(jb).any()
        _close(to, jo)
        opt[mc] = float(_np(to)[0, 0])
    assert abs(opt[12] - 1.0) < 5e-3 and abs(opt[4] - 0.45) < 5e-3
    assert opt[4] < opt[12] + 1e-6


def test_occluded_matches_jax(jobs):
    """The shadow test of the scene-medium path and of whitted and ao:
    the same occluded lanes as pbrt_tpu's occluded."""
    jj, tj = jobs["volpath_bench"]
    rs = np.random.RandomState(57)
    o = rs.uniform(0.2, 4.8, (B, 3)).astype(np.float32)
    d = rs.randn(B, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rs.uniform(0.5, 6.0, B).astype(np.float32)
    from pbrt_tpu.core import geometry as jgeom
    from pbrt_tpu_torch.core import geometry as tgeom
    jo = jisect.occluded(jj.scene, jgeom.Ray.make(
        jnp.asarray(o), jnp.asarray(d), tmax=jnp.asarray(tmax)))
    to = tisect.occluded(tj.scene, tgeom.Ray.make(_t(o), _t(d),
                                                  tmax=_t(tmax)))
    assert np.array_equal(_np(to), np.asarray(jo))
    assert 0.05 < float(_np(to).mean()) < 0.95
