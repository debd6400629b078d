"""The port's lights against pbrt_tpu's on the same inputs (CPU), and
the lights slice as a whole.

The scene is pbrt_tpu_torch/scenes/cornell_lights.pbrt, which binds every
light kind: parsed by pbrt_tpu and carried into the port by
`scene_from_jax`, so both packages compute on the same tables.  The
port's own parse of it must give the same tables bit for bit (the
selection cdfs and pmfs, the env map's cdfs: host numpy float64 cast to
float32 in both).

Tolerances: the same f32 formulas in another framework differ by a few
ulps (libm sqrt, acos, atan2, cos), so continuous outputs agree within
1e-4 relative plus 1e-6 of the output's largest value.  Two places are
discrete:
- env-map cells: a direction's (row, column) comes from acos / atan2 of
  a direction that differs by ulps, so a lane whose direction lies on a
  cell boundary may land in the neighbouring cell in one package.  Such
  lanes are found by computing each package's cell with its own
  operations; they must be under 0.5% of the lanes (measured: none in
  65,536 lanes of sampled, random and sky-sampled directions each), and
  every other lane is held at the tolerance above.
- light selection: the same f32 comparisons of the same uniforms with
  the same cdfs, so the picked lights are equal lane for lane.

The slice: the scene at 16x16, 2 spp, depth 3 through both CLIs'
`run_job` (pbrt_tpu's pass unfused with its light, BSDF, intersect and
sampler functions jitted one by one, as in test_torch_materials_render.py):
the same counter-based Sobol' samples and the same paths but where the
two intersectors pick another triangle at an edge, an env-map cell or a
lobe choice flips at a rounding tie: image mean within 1e-4 relative,
>= 97% of pixels within 1e-3 relative and >= 99% within 1e-2 (measured
1.2e-7, 1.0 and 1.0; 99.6% of pixels within 1e-5).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.lights import distrib as jdistrib
from pbrt_tpu.lights import hosek as jhosek
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.core import spectrum as tspec
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.lights import distrib as tdistrib
from pbrt_tpu_torch.lights import hosek as thosek
from pbrt_tpu_torch.lights import lights as tlights
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_core import tensors_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_DIR = os.path.join(ROOT, "pbrt_tpu_torch", "scenes")
SCENE = os.path.join(SCENE_DIR, "cornell_lights.pbrt")
SKY = os.path.join(SCENE_DIR, "textures", "sky.exr")
# the arguments the committed sky was made with (the scene's comment)
SKY_ARGS = dict(resolution=128, turbidity=3.0, albedo=0.5,
                elevation_deg=10.0)
N = 4096
RTOL, ATOL = 1e-4, 1e-6
CELL_FLIP_SHARE = 5e-3
DEV = "cpu"
# the scene's lights in file order
NAMES = ("ceiling", "sphere", "point", "spot", "gonio", "projection",
         "distant", "sky")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, mask=None, rtol=RTOL, atol=ATOL):
    """|a - b| <= rtol |b| + atol max|b| (on mask)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    scale = max(float(np.abs(b).max()), 1e-30) if b.size else 1.0
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale)


def _t(x):
    return x if torch.is_tensor(x) else torch.from_numpy(np.array(x))


# one XLA program each, not an eager compile of each operation
_jsample_li = jax.jit(jlights.sample_li)
_jpdf_li_area = jax.jit(jlights.pdf_li_area)
_jsample_env = jax.jit(jlights.sample_env_direction)
_jpdf_inf = jax.jit(jlights.pdf_li_infinite)
_jenv_le = jax.jit(jlights.env_le)
_jdelta_scale = jax.jit(jlights.delta_emit_scale)


def _carry(js):
    arrays = {k: np.asarray(getattr(js, k)) for k in tir.JAX_ARRAYS}
    statics = {k: getattr(js, k) for k in tir.JAX_STATICS}
    return tir.scene_from_jax(arrays, statics, DEV)


@pytest.fixture(scope="module")
def scenes():
    js = JAPI().parse_file(SCENE).scene
    return js, _carry(js)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _points(rs, n):
    """Points inside the box, a few inside the sphere light."""
    p = rs.uniform(0.05, 4.95, (n, 3)).astype(np.float32)
    p[::97] = np.float32([1.1, 3.7, 0.35]) + rs.uniform(
        -0.15, 0.15, (len(p[::97]), 3)).astype(np.float32)
    return p


def _cell_flips(ts, js, wi_t, wi_j):
    """Lanes whose env-map cell differs between the packages: the port's
    cell of its direction against pbrt_tpu's of its own (the index
    arithmetic of pbrt_tpu/lights/lights.py::_env_radiance)."""
    yt, xt, _ = tlights._env_cell(ts, _t(wi_t))
    dl = jnp.asarray(wi_j) @ js.env_to_light[:3, :3].T
    He, We = js.env_map.shape[:2]
    xj = jnp.clip((jgeom.spherical_phi(dl) * (0.5 / jnp.pi) * We)
                  .astype(jnp.int32), 0, We - 1)
    yj = jnp.clip((jgeom.spherical_theta(dl) / jnp.pi * He)
                  .astype(jnp.int32), 0, He - 1)
    return (yt.numpy() != np.asarray(yj)) | (xt.numpy() != np.asarray(xj))


# ---------------------------------------------------------------------------
# the scene's tables
# ---------------------------------------------------------------------------

def test_lights_scene_parses_like_jax(scenes):
    """The port's parse equals the JAX parse carried across, bit for bit:
    every light column, the power and spatial cdfs and pmfs, the env
    map and its cdfs; env_lum is the builder's f32 luminance product."""
    js, ts = scenes
    tp = tparse(SCENE, device=DEV).scene
    for f in tp.__dataclass_fields__:
        x, y = getattr(tp, f), getattr(ts, f)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and tensors_equal(x, y), f
        else:
            assert x == y, f
    assert tp.light_kinds == tuple(range(7)) and tp.n_lights == 8
    assert tp.has_mesh_lights and tp.has_sphere_lights and tp.has_infinite
    assert tp.inf_light_idx == 7 and tp.env_map.shape == (128, 256, 31)
    lum = np.asarray(js.env_map) @ jspec.CIE_Y.astype(np.float32)
    assert np.array_equal(tp.env_lum.numpy(), lum)
    assert [int(t) for t in tp.light_type] == [2, 2, 0, 4, 5, 6, 1, 3]
    assert tp.light_quad[1] >= 0 and tp.light_quad[0] < 0
    # the sky's power is estimated from its L and scale alone, not its
    # map (pbrt_tpu/lights/distrib.py:48-49): it takes 99% of the power
    # strategy's picks though the map is dim
    assert float(tp.light_power_pmf[7]) > 0.99


# ---------------------------------------------------------------------------
# sample_li and the pdfs
# ---------------------------------------------------------------------------

def _sample_inputs(seed, lights):
    rs = np.random.RandomState(seed)
    p = _points(rs, N)
    n = _unit(rs, N)
    u1, u2 = rs.rand(2, N).astype(np.float32)
    return p, n, u1, u2, np.asarray(lights, np.int32)


@pytest.mark.parametrize("which", list(NAMES) + ["mixed"])
def test_sample_li_matches_jax(scenes, which):
    js, ts = scenes
    rs = np.random.RandomState(21)
    lights = (rs.randint(0, 8, N) if which == "mixed"
              else np.full(N, NAMES.index(which)))
    p, n, u1, u2, l = _sample_inputs(22 + len(which), lights)
    jo = _jsample_li(js, *(jnp.asarray(x) for x in (l, p, n, u1, u2)))
    to = tlights.sample_li(ts, *(_t(x) for x in (l, p, n, u1, u2)))
    keep = ~_cell_flips(ts, js, to[0], jo[0]) | (l != 7)
    assert (~keep).mean() < CELL_FLIP_SHARE
    for a, b in zip(to[:4], jo[:4]):
        _close(a, b, keep)
    assert np.array_equal(to[4].numpy(), np.asarray(jo[4]))
    li = to[1].numpy()
    assert np.isfinite(li).all() and (li > 0).any()


def test_pdf_li_area_matches_jax(scenes):
    """Mesh lanes (dist^2 / |cos| A) and sphere lanes (the cone), and
    lanes of no light."""
    js, ts = scenes
    rs = np.random.RandomState(31)
    light = rs.choice([-1, 0, 1], N).astype(np.int32)
    p = _points(rs, N)
    wi, ng = _unit(rs, N), _unit(rs, N)
    t = rs.uniform(0.1, 6, N).astype(np.float32)
    args = (light, p, wi, t, ng)
    _close(tlights.pdf_li_area(ts, *(_t(x) for x in args)),
           _jpdf_li_area(js, *(jnp.asarray(x) for x in args)))


def test_env_sampling_matches_jax(scenes):
    """sample_env_direction, pdf_li_infinite and env_le: the same row and
    column searches, so sampled directions agree but for rounding; a
    direction's cell may flip only on a cell boundary."""
    js, ts = scenes
    rs = np.random.RandomState(41)
    u1, u2 = rs.rand(2, N).astype(np.float32)
    jw, jp = _jsample_env(js, jnp.asarray(u1),
                                          jnp.asarray(u2))
    tw, tp = tlights.sample_env_direction(ts, _t(u1), _t(u2))
    _close(tw, jw)
    _close(tp, jp)
    d = _unit(rs, N)
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], [0, 0, -1],
             [-1, 0, 0], [0.6, 0.8, 0], [0, 0.6, -0.8]]       # poles, axes
    keep = ~_cell_flips(ts, js, d, d)
    assert (~keep).mean() < CELL_FLIP_SHARE
    _close(tlights.pdf_li_infinite(ts, _t(d)),
           _jpdf_inf(js, jnp.asarray(d)), keep)
    _close(tlights.env_le(ts, _t(d)), _jenv_le(js, jnp.asarray(d)),
           keep, rtol=0, atol=0)
    # the sampled directions' own pdf
    keep = ~_cell_flips(ts, js, tw, jw)
    assert (~keep).mean() < CELL_FLIP_SHARE
    _close(tlights.pdf_li_infinite(ts, tw),
           _jpdf_inf(js, jw), keep)
    assert (tp > 0).float().mean() > 0.99


def test_delta_emit_scale_and_area_le_match_jax(scenes):
    js, ts = scenes
    rs = np.random.RandomState(51)
    l = rs.randint(0, 8, N).astype(np.int32)
    w, ng, wo = _unit(rs, N), _unit(rs, N), _unit(rs, N)
    _close(tlights.delta_emit_scale(ts, _t(l), _t(w)),
           _jdelta_scale(js, jnp.asarray(l), jnp.asarray(w)))
    hl = rs.randint(-1, 8, N).astype(np.int32)
    _close(tlights.area_le(ts, _t(hl), _t(ng), _t(wo)),
           jlights.area_le(js, jnp.asarray(hl), jnp.asarray(ng),
                           jnp.asarray(wo)), rtol=0, atol=0)


@pytest.mark.parametrize("strategy", ["uniform", "power", "spatial"])
def test_light_selection_matches_jax(scenes, strategy):
    js, ts = scenes
    rs = np.random.RandomState(61)
    p = rs.uniform(-0.5, 5.5, (N, 3)).astype(np.float32)   # some outside
    u = rs.rand(N).astype(np.float32)
    jl, jpdf = jdistrib.select_light(js, strategy, jnp.asarray(p),
                                     jnp.asarray(u))
    tl, tpdf = tdistrib.select_light(ts, strategy, _t(p), _t(u))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tpdf.numpy(), np.asarray(jpdf))
    hl = rs.randint(-1, 8, N).astype(np.int32)
    assert np.array_equal(
        tdistrib.selection_pdf(ts, strategy, _t(p), _t(hl)).numpy(),
        np.asarray(jdistrib.selection_pdf(js, strategy, jnp.asarray(p),
                                          jnp.asarray(hl))))
    assert len(set(tl.tolist())) >= 5


# scenes of one light kind: sample_li's single-kind branch (no type
# column) and its area-light halves alone
ONE_KIND = {
    "sphere": 'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [4 4 4]\n'
              'Translate 1 2 1\nShape "sphere" "float radius" [.4]\n'
              'AttributeEnd',
    "constant_sky": 'LightSource "infinite" "rgb L" [.5 .6 .7]',
    "spot": 'LightSource "spot" "rgb I" [5 5 5] "point from" [2 2 4] '
            '"point to" [2 2 0] "float coneangle" [30]',
    "gonio": 'AttributeBegin\nTranslate 2 2 3\nLightSource "goniometric" '
             '"string mapname" "textures/floor.png" "rgb I" [3 3 3]\n'
             'AttributeEnd',
    "distant": 'LightSource "distant" "blackbody L" [5500 2 3000 1]',
}
BOX = ('Material "matte"\nShape "trianglemesh" "point P" '
       '[0 0 0 4 0 0 4 4 0 0 4 0] "integer indices" [0 1 2 2 3 0]\n')


@pytest.mark.parametrize("kind", list(ONE_KIND))
def test_single_kind_scenes_match_jax(kind):
    text = f"WorldBegin\n{BOX}{ONE_KIND[kind]}\nWorldEnd\n"
    js = JAPI().parse_string(text, scene_dir=SCENE_DIR).scene
    ts = _carry(js)
    tp = TAPI(DEV).parse_string(text, scene_dir=SCENE_DIR).scene
    for k in tir.LIGHT_COLUMNS:
        assert torch.equal(getattr(tp, k), getattr(ts, k)), k
    assert len(ts.light_kinds) == 1
    rs = np.random.RandomState(71)
    p = rs.uniform(0.05, 3.95, (N, 3)).astype(np.float32)
    n = _unit(rs, N)
    u1, u2 = rs.rand(2, N).astype(np.float32)
    l = np.zeros(N, np.int32)
    args = (l, p, n, u1, u2)
    jo = jlights.sample_li(js, *(jnp.asarray(x) for x in args))
    to = tlights.sample_li(ts, *(_t(x) for x in args))
    for a, b in zip(to[:4], jo[:4]):
        _close(a, b)
    assert np.array_equal(to[4].numpy(), np.asarray(jo[4]))


# ---------------------------------------------------------------------------
# the sky model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sun", [True, False])
def test_sky_image_matches_jax(sun):
    kw = dict(resolution=24, turbidity=4.5, albedo=0.3, elevation_deg=3.0,
              with_sun=sun)
    assert np.array_equal(thosek.make_sky_image(**kw),
                          jhosek.make_sky_image(**kw))
    st = thosek.sky_model_state(0.4, 2.2, 0.1)
    sj = jhosek.sky_model_state(0.4, 2.2, 0.1)
    for k in ("configs", "radiances"):
        assert np.array_equal(st[k], sj[k])
    th, ga = np.meshgrid(np.linspace(0, 1.5, 7), np.linspace(0, 3, 5))
    lam = np.linspace(330, 710, 5)[:, None]
    assert np.array_equal(thosek.solar_radiance(st, th, ga, lam),
                          jhosek.solar_radiance(sj, th, ga, lam))


def test_committed_sky_is_a_fresh_one(tmp_path):
    img = thosek.make_sky_image(**SKY_ARGS)
    assert img.shape == (128, 256, 3) and img[:64].min() > 0
    assert not img[64:].any()                    # below the horizon
    fresh = tio.write_exr(str(tmp_path / "sky.exr"), img, compression="zip")
    with open(fresh, "rb") as f, open(SKY, "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# recorded deviations, reproduced (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def test_env_tables_use_the_last_infinite_light():
    """With two infinite lights, env_le and the env tables are the last
    one's, while inf_light_idx (the escaped rays' MIS) is the first's, as
    in pbrt_tpu/scene/ir.py:808-815."""
    text = (f"WorldBegin\n{BOX}LightSource \"infinite\" \"rgb L\" [1 1 1]\n"
            'LightSource "infinite" "rgb L" [.2 .3 .4]\nWorldEnd\n')
    js = JAPI().parse_string(text).scene
    tp = TAPI(DEV).parse_string(text).scene
    assert tp.inf_light_idx == js.inf_light_idx == 0
    assert torch.equal(tp.env_map[0, 0], tp.light_L[1])
    assert np.array_equal(tp.env_map.numpy(), np.asarray(js.env_map))


def test_point_inside_sphere_light_has_zero_pdf(scenes):
    """A point inside a sphere light samples it with pdf 0
    (pbrt_tpu/lights/lights.py:117), where the reference samples its
    area."""
    js, ts = scenes
    # N lanes (the shape the JAX functions were compiled for above)
    p = np.tile(np.float32([[1.1, 3.7, 0.35], [1.2, 3.65, 0.4],
                            [1.1, 3.7, 1.5]]), (N // 2, 1))[:N]
    l = np.ones(N, np.int32)
    u = np.full(N, 0.3, np.float32)
    args = (l, p, p, u, u)
    tpdf = tlights.sample_li(ts, *(_t(x) for x in args))[2].numpy()
    jpdf = np.asarray(_jsample_li(js, *(jnp.asarray(x) for x in args))[2])
    assert (tpdf[:2] == 0).all() and (jpdf[:2] == 0).all()
    assert tpdf[2] > 0 and np.isclose(tpdf[2], jpdf[2], rtol=RTOL)


def test_blackbody_is_wien_normalized_times_scale():
    """A blackbody parameter is the spectrum normalized to 1 at Wien's
    peak times its scale, summed over pairs
    (pbrt_tpu/core/spectrum.py:417-425)."""
    bb = tspec.blackbody_spectrum(6500.0, 2.0)
    assert np.array_equal(bb, jspec.blackbody_spectrum(6500.0, 2.0))
    lam_max = 2.8977721e-3 / 6500.0 * 1e9
    assert np.isclose(tspec.blackbody_normalized([lam_max], 6500.0)[0], 1.0)
    text = (f'WorldBegin\n{BOX}LightSource "point" "blackbody I" '
            "[6500 2 3000 0.5]\nWorldEnd\n")
    tp = TAPI(DEV).parse_string(text).scene
    ref = (tspec.blackbody_spectrum(6500.0, 2.0)
           + tspec.blackbody_spectrum(3000.0, 0.5)).astype(np.float32)
    assert np.array_equal(tp.light_L[0].numpy(), ref)


# ---------------------------------------------------------------------------
# shadow rays toward sphere lights (intersect.nee_ignore_light, trace_pair)
# ---------------------------------------------------------------------------

EXCLUSION = """WorldBegin
Material "matte"
AttributeBegin
AreaLightSource "diffuse" "rgb L" [2 2 2]
Shape "trianglemesh" "point P" [-1 -1 2 1 -1 2 1 1 2 -1 1 2
    -1 -1 1 1 -1 1 1 1 1 -1 1 1] "integer indices" [0 1 2 2 3 0 4 5 6 6 7 4]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "rgb L" [5 5 5]
Translate 6 0 3
Shape "sphere" "float radius" [.5]
AttributeEnd
Shape "trianglemesh" "point P" [5 -1 1.5 7 -1 1.5 7 1 1.5 5 1 1.5]
    "integer indices" [0 1 2 2 3 0]
LightSource "point" "rgb I" [1 1 1] "point from" [0 0 5]
WorldEnd
"""


@pytest.fixture(scope="module")
def exclusion_scenes():
    js = JAPI().parse_string(EXCLUSION).scene
    return js, _carry(js)


def test_nee_ignore_light_only_for_sphere_lights(exclusion_scenes):
    """-1 for the mesh light (0), the sphere light's id for it (1), -1
    for the point light (2); None in a scene without sphere lights."""
    js, ts = exclusion_scenes
    l = np.asarray([0, 1, 2, 1, -1], np.int32)
    got = tisect.nee_ignore_light(ts, _t(l))
    assert got.tolist() == [-1, 1, -1, 1, -1]
    assert np.array_equal(got.numpy(), np.asarray(
        jisect.nee_ignore_light(js, jnp.asarray(l))))
    assert tisect.nee_ignore_light(ts, None) is None
    no_spheres = _carry(JAPI().parse_string(
        f"WorldBegin\n{BOX}LightSource \"point\" \"rgb I\" [1 1 1]\n"
        "WorldEnd\n").scene)
    assert tisect.nee_ignore_light(no_spheres, _t(l)) is None


def _shadow(ts, js, o, d, tmax, ignore):
    """The occluded flags of shadow rays o + t d, t < tmax, through both
    packages' trace_pair (with one closest-hit ray beside them)."""
    o, d = np.float32(o), np.float32(d)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.float32(tmax)
    nr = tgeom.Ray.make(_t(np.float32([[0, 0, -1]])),
                        _t(np.float32([[0, 0, 1]])))
    sr = tgeom.Ray.make(_t(o), _t(d), tmax=_t(tmax))
    ign = None if ignore is None else _t(np.asarray(ignore, np.int64))
    _, occ = tisect.trace_pair(ts, nr, sr, ignore_light=ign)
    jn = jgeom.Ray.make(jnp.asarray([[0.0, 0, -1]]), jnp.asarray([[0.0, 0,
                                                                   1]]))
    jsr = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d),
                         tmax=jnp.asarray(tmax))
    _, jocc = jax.jit(jisect.trace_pair)(
        js, jn, jsr, ignore_light=None if ignore is None
        else jnp.asarray(np.asarray(ignore, np.int32)))
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    return occ.tolist()


def test_mesh_light_faces_still_occlude(exclusion_scenes):
    """A shadow ray toward the mesh light's upper quad passes its lower
    quad, which belongs to the same light: it occludes (the exclusion is
    for sphere lights only), and a ray that ends short of it does not."""
    js, ts = exclusion_scenes
    l = np.asarray([0, 0])
    ign = tisect.nee_ignore_light(ts, _t(l)).tolist()
    assert ign == [-1, -1]
    occ = _shadow(ts, js, [[0.2, 0.1, 0.0], [0.2, 0.1, 0.0]],
                  [[0, 0, 1], [0, 0, 1]], [1.998, 0.9], ign)
    assert occ == [True, False]


def test_blocker_before_sphere_light_occludes(exclusion_scenes):
    """Toward the sphere light (centre (6, 0, 3), r 0.5): a ray through
    the quad at z = 1.5 is occluded; a ray that misses the quad but
    reaches into the light's sphere (its sample distance is approximate)
    is not, as its one hit is the ignored light; without the exclusion
    that hit would occlude."""
    js, ts = exclusion_scenes
    o = [[6.0, 0.0, 0.0], [6.0, 3.0, 0.0]]
    c = np.float32([6.0, 0.0, 3.0])
    d = c - np.float32(o)
    dist = np.linalg.norm(d, axis=-1)
    ign = [1, 1]
    assert _shadow(ts, js, o, d, dist, ign) == [True, False]
    assert _shadow(ts, js, o, d, dist, None) == [True, True]


# ---------------------------------------------------------------------------
# the slice: the lights scene through both CLIs
# ---------------------------------------------------------------------------

def _jax_render(jj, spp, depth):
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpath, "sample_dim", jit(jsamp.sample_dim,
                                            static_argnums=0))
        for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                     "bump_shading_normal"):
            mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
        for name in ("sample_li", "pdf_li_area", "pdf_li_infinite",
                     "area_le", "env_le"):
            mp.setattr(jlights, name, jit(getattr(jlights, name)))
        for name in ("select_light", "selection_pdf"):
            mp.setattr(jdistrib, name, jit(getattr(jdistrib, name),
                                           static_argnums=1))
        mp.setattr(jisect, "trace_pair", jit(jisect.trace_pair))
        mp.setattr(jisect, "intersect_full", jit(
            jisect.intersect_full, static_argnames=("presorted",)))
        # render's per-pass jit: the pass runs unfused
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        film, _ = jcli.run_job(jj, spp=spp, max_depth=depth, quiet=True)
    return np.asarray(jfilm.develop_spectral(film))


def test_lights_scene_renders_like_jax():
    """cornell_lights.pbrt (every light kind, spatial selection, the sky
    map, the sphere light's shadow exclusion) at 16x16, 2 spp, depth 3."""
    jj, tj = jparse(SCENE), tparse(SCENE, device=DEV)
    for j in (jj, tj):
        j.film_width = j.film_height = 16
    assert tj.integrator_params["lightsamplestrategy"] == "spatial"
    tf, _ = tcli.run_job(tj, spp=2, max_depth=3)
    ti = tfilm.develop_spectral(tf).numpy()
    assert np.isfinite(ti).all() and (ti >= 0).all() and ti.mean() > 0
    ji = _jax_render(jj, 2, 3)
    assert abs(ti.mean() / ji.mean() - 1) < 1e-4
    tl, jl = ti.sum(-1), ji.sum(-1)
    diff = np.abs(tl - jl)
    assert (diff <= 1e-3 * np.abs(jl)).mean() >= 0.97
    assert (diff <= 1e-2 * np.abs(jl)).mean() >= 0.99


def test_unbounded_shadow_rays_hit_as_bounded_ones(scenes):
    """Rays of tmax 1e30 (distant and infinite samples' shadow rays)
    through the sort key, K1's entry t and K2's initial t_best: no NaN,
    and the same hits (and closest-hit t) as the same rays cut at 100,
    beyond the scene, on any-hit and closest-hit lanes."""
    _, ts = scenes
    rs = np.random.RandomState(91)
    n = 2048
    o = _t(_points(rs, n))
    d = _t(_unit(rs, n))
    found = []
    for tmax in (1e30, 100.0):
        ray = tgeom.Ray.make(o, d, tmax=torch.full((n,), tmax))
        amask = torch.arange(n) % 2 == 0
        t, prim, hit = tisect.intersect(ts, ray, anyhit_mask=amask)
        assert not torch.isnan(t).any()
        found.append((prim, hit, torch.where(amask | ~hit, 0.0, t)))
    for a, b in zip(*found):
        assert torch.equal(a, b)
    assert 0.5 < float(found[0][1].float().mean()) < 1.0
