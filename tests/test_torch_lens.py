"""The port's lens cameras (realistic, omni with microlens arrays,
realisticEye), the orthographic and environment cameras, lenstool, the
parser's and CLI's camera kinds, and the lens renders, against pbrt_tpu
on the same inputs (CPU).

Tolerances, each with the figure measured on this CPU:
- the lens readers, lenstool's JSON and every array of a built camera
  but its exit pupil: equal (the same f64 host code, cast to f32);
  film_distance exactly;
- the exit pupil: within one sample spacing, pad = 2 rear_r /
  sqrt(2048), of pbrt_tpu's, valid zones equal (measured: equal bit for
  bit on every camera here);
- traced and generated rays, on the lanes both keep: spherical stacks
  within 2e-6 (measured 4.8e-7 on origins in metres, 3.0e-7 on unit
  directions); the biconic stack within 1e-4 on directions (measured
  1.5e-5: its Newton steps take forward differences at eps = 1e-6, so an
  ulp of the sag, which XLA and torch round apart in sqrt and rsqrt,
  becomes ~ulp / 1e-6 in the slope) and 2e-6 on origins; the eye (mm)
  within 1e-5 on origins (measured 1.9e-6) and 5e-6 on directions;
  weights within 1e-5 relative.  A lane that one package keeps and the
  other kills must lie within f32 rounding of an edge (relative margin
  < 1e-5 to an aperture, or to total internal reflection, traced again
  in f64); none did here;
- the lens render (24x24, 8 spp, singlet, the emissive quad of
  tests/test_lens.py) and spectralpath with chromatic aberration (16x16,
  2 spp, 4 bands): image means within 1e-5 relative (measured 0, both);
- the orthographic and environment cameras: within 2e-6.

pbrt_tpu's exit-pupil traces (32 zones a camera) run through a jitted
`trace_lenses_from_film`, and its trace_paths is jitted as in
test_torch_integrators.py: eagerly they cost ~10 s a camera.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import lens as jlens
from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.integrators import spectralpath as jspec
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu.scene import ir as jir
from pbrt_tpu.tools import lenstool as jlenstool
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu_torch.cameras import lens as tlens
from pbrt_tpu_torch.cameras import projective as tproj
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.core import transform as ttfm
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import spectralpath as tspec
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import lenstool as tlenstool
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENSES = os.path.join(ROOT, "pbrt_tpu_torch", "scenes", "lenses")
DGAUSS = os.path.join(LENSES, "dgauss.50mm.dat")
EYE = os.path.join(LENSES, "eye5.txt")
CORNELL_LENS = os.path.join(ROOT, "pbrt_tpu_torch", "scenes",
                            "cornell_lens.pbrt")
SINGLET_DAT = "# f=50mm biconvex singlet\n50 4 1.5 20\n-50 0 1 20\n"
BICONIC = {"surfaces": [
    {"radius": [50, 60], "thickness": 4, "ior": 1.5, "semi_aperture": 10,
     "conic_constant": [-0.5, 0.3],
     "aspheric_coefficients": [1e-6, -1e-9]},
    {"radius": 0, "thickness": 2, "ior": 1, "semi_aperture": 4},
    {"radius": -50, "thickness": 0, "ior": 1, "semi_aperture": 10,
     "aspheric_coefficients": [2e-6]}]}
# the eye's media (tests/test_lens.py), the cornea's dispersive
EYE_IORS = [np.linspace(1.39, 1.37, 31).astype(np.float32)] + [
    np.full(31, v, np.float32) for v in (1.337, 1.42, 1.336)]
EYE_KW = dict(film_distance=16.32, retina_radius=12.0, retina_semi_diam=4.0,
              film_diag=8.0, ior_spectra=EYE_IORS, pupil_diameter=4.0,
              diffraction=True)
# a microlens array at cell scale: 64x64 lenslets of 0.39 mm on the 35 mm
# film (tests/test_lens.py's near-collimating choice), 0.4 mm from it
MICRO = [{"radius": 0.25, "thickness": 0.4, "ior": 1.5,
          "semi_aperture": 0.2, "conic_constant": 0.0}]
TOL = {"sphere": (2e-6, 2e-6), "biconic": (2e-6, 1e-4), "eye": (1e-5, 5e-6)}
B = 4096           # rays a parity test (one shape: pbrt_tpu's eager ops
#                    compile once for all of them)

_JIT_TRACE = jax.jit(jlens.trace_lenses_from_film)


def _jax_build(*args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlens, "trace_lenses_from_film", _JIT_TRACE)
        return jlens.build_lens_camera(*args, **kw)


def _arrays(jc):
    return ({k: None if getattr(jc, k) is None else np.asarray(getattr(jc, k))
             for k in tlens.TENSOR_FIELDS + tlens.ML_FIELDS},
            {k: getattr(jc, k) for k in tlens.STATIC_FIELDS})


def _from_jax(jc):
    return tlens.lens_camera_from_jax(*_arrays(jc), DEV)


@pytest.fixture(scope="module")
def lens_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lenses")
    (d / "singlet.dat").write_text(SINGLET_DAT)
    (d / "biconic.json").write_text(json.dumps(BICONIC))
    tlenstool.convert(str(d / "singlet.dat"), str(d / "singlet.json"))
    tlenstool.insert_microlens(str(d / "singlet.json"), str(d / "ml.json"),
                               64, 64, MICRO)
    j = json.loads((d / "ml.json").read_text())
    # jitter every lenslet by up to 20 um (offsets are in metres)
    j["microlens"]["offsets"] = np.random.RandomState(21).uniform(
        -2e-5, 2e-5, (64 * 64, 2)).tolist()
    (d / "ml_offsets.json").write_text(json.dumps(j))
    return d


@pytest.fixture(scope="module")
def cams(lens_files):
    """{name: (pbrt_tpu's camera, the port's own build, stack kind)}."""
    d = lens_files
    look = ([2.5, -4.5, 2.5], [2.5, 2.5, 2.5], [0, 0, 1])
    specs = {
        "singlet": ("realistic", jlens.read_dat_lens(str(d / "singlet.dat")),
                    dict(focus_distance=1e6, film_diag=0.035), "sphere"),
        "dgauss": ("realistic", jlens.read_dat_lens(DGAUSS, 8.0),
                   dict(focus_distance=7.0, film_diag=0.035), "sphere"),
        "biconic": ("omni", jlens.read_json_lens(str(d / "biconic.json"))[0],
                    dict(focus_distance=1e6, film_diag=0.035), "biconic"),
        "eye": ("realisticEye", jlens.read_eye_spec(EYE)[1], EYE_KW, "eye"),
    }
    out = {}
    for name, (kind, surfs, kw, stack) in specs.items():
        xf = (look if name == "dgauss" else None)
        jx = jtfm.look_at(*xf) if xf else jtfm.Transform()
        tx = ttfm.look_at(*xf) if xf else ttfm.Transform()
        out[name] = (_jax_build(kind, jx, surfs, **kw),
                     tlens.build_lens_camera(kind, tx, surfs, device=DEV,
                                             **kw), stack)
    # omni with the microlens array: pbrt_tpu's attaches the array to the
    # singlet's build (the exit pupil is the main stack's alone)
    surfs, _ = jlens.read_json_lens(str(d / "singlet.json"))
    jbase = _jax_build("omni", jtfm.Transform(), surfs, focus_distance=1e6,
                       film_diag=0.035)
    for f in ("ml.json", "ml_offsets.json"):
        surfs, micro = jlens.read_json_lens(str(d / f))
        for R in (0, 1):
            name = f"omni_r{R}" + ("_offsets" if "offsets" in f else "")
            jc = jlens._attach_microlens(jbase, micro, 0.001, R)
            tc = tlens.build_lens_camera(
                "omni", ttfm.Transform(), surfs, focus_distance=1e6,
                film_diag=0.035, microlens=micro,
                microlens_sensor_offset=0.001, microlens_sim_radius=R,
                device=DEV)
            out[name] = (jc, tc, "sphere")
    return out


def test_lens_readers_and_lenstool_equal_jax(lens_files, tmp_path):
    """The readers field for field, the JSON conic constant's 1e-3 scale
    included (Queue 3 (b)), and lenstool's files byte for byte."""
    d = lens_files
    for path, ap in ((d / "singlet.dat", 1.0), (DGAUSS, 8.0)):
        assert tlens.read_dat_lens(str(path), ap) == \
            jlens.read_dat_lens(str(path), ap)
    for f in ("biconic.json", "ml.json", "ml_offsets.json"):
        t, j = tlens.read_json_lens(str(d / f)), jlens.read_json_lens(
            str(d / f))
        assert t == j, f
    assert tlens.read_json_lens(str(d / "biconic.json"))[0][0][
        "conic_x"] == -0.5e-3
    for scaling in (1.0, 1e-3):
        assert tlens.read_eye_spec(EYE, scaling) == \
            jlens.read_eye_spec(EYE, scaling)
    for tool, tag in ((tlenstool, "t"), (jlenstool, "j")):
        tool.convert(str(d / "singlet.dat"), str(tmp_path / f"{tag}.json"))
        tool.insert_microlens(str(tmp_path / f"{tag}.json"),
                              str(tmp_path / f"{tag}_ml.json"), 8, 4)
    for f in (".json", "_ml.json"):
        assert (tmp_path / f"t{f}").read_bytes() == \
            (tmp_path / f"j{f}").read_bytes()
    assert tlenstool.main(["convert", str(d / "singlet.dat"),
                           str(tmp_path / "cli.json")]) == 0
    assert (tmp_path / "cli.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()


def _pad(jc):
    return 2.0 * float(jc.aperture[0]) / np.sqrt(2048)


@pytest.mark.parametrize("name", ["singlet", "dgauss", "biconic", "eye",
                                  "omni_r0", "omni_r1_offsets"])
def test_build_lens_camera_matches_jax(cams, name):
    jc, tc, _ = cams[name]
    for k in tlens.STATIC_FIELDS:
        assert getattr(tc, k) == getattr(jc, k), k
    for k in tlens.TENSOR_FIELDS + tlens.ML_FIELDS:
        a, b = getattr(jc, k), getattr(tc, k)
        if a is None:
            assert b is None, k
            continue
        a = np.array(a)
        assert b.dtype == torch.from_numpy(a).dtype and b.shape == a.shape, k
        if k != "pupil_bounds":
            assert np.array_equal(b.numpy(), a), k
    assert float(tc.film_distance) == float(jc.film_distance)
    assert tc.eta_idx_host == tuple(np.asarray(jc.eta_idx))
    assert tc.is_stop_host == tuple(np.asarray(jc.is_stop))


@pytest.mark.parametrize("name", ["singlet", "dgauss", "biconic", "eye",
                                  "omni_r0"])
def test_exit_pupil_within_one_sample_of_jax(cams, name):
    """The port traces all 32 zones in one batch of 65,536 rays; a lane
    that grazes an edge moves a zone's bound by at most one sample plus
    pad."""
    jc, tc, _ = cams[name]
    assert np.array_equal(tc.pupil_valid.numpy(), np.asarray(jc.pupil_valid))
    err = np.abs(tc.pupil_bounds.numpy() - np.asarray(jc.pupil_bounds))
    assert err.max() <= _pad(jc), err.max()
    assert tc.pupil_valid.any()


def _edge_margin(tc, o, d, wl):
    """Each lane's least relative distance, traced in f64 through the
    port's stack, to an aperture's rim (|r^2 - a^2| / a^2) or to total
    internal reflection (|1 - sin^2 t|), over the surfaces it reaches."""
    cam = dataclasses.replace(tc, **{
        k: getattr(tc, k).double() for k in tlens.TENSOR_FIELDS
        if getattr(tc, k).is_floating_point()})
    o, d, wl = o.double(), d.double(), wl.double()
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    margin = torch.full((o.shape[0],), np.inf, dtype=torch.float64)
    for si in range(cam.n_surfaces):
        kind = cam.surface_kinds[si]
        t, n, ok = tlens._intersect_surface(
            o, d, cam.z_pos[si], cam.curv_x[si], cam.curv_y[si],
            cam.conic_x[si], cam.conic_y[si], cam.asph[si], kind)
        p = o + t[:, None] * d
        a2 = cam.aperture[si] ** 2
        m = (p[:, 0] ** 2 + p[:, 1] ** 2 - a2).abs() / a2
        ok = ok & (p[:, 0] ** 2 + p[:, 1] ** 2 <= a2)
        if kind != "flat":
            ratio = tlens._eta_at(cam, si, wl)
            if si + 1 < cam.n_surfaces:
                ratio = ratio / tlens._eta_at(cam, si + 1, wl)
            cos_i = tgeom.dot(n, -d)
            m = torch.minimum(m, (1 - ratio ** 2 * (1 - cos_i ** 2)).abs())
            can, wt = tgeom.refract(-d, n, ratio * torch.ones_like(wl))
            d = torch.where(can[:, None], tgeom.normalize(wt), d)
            ok = ok & can
        margin = torch.where(alive, torch.minimum(margin, m), margin)
        o = p
        alive = alive & ok
    return margin


def _rear_rays(jc, n, seed):
    """Rays from film points at rear-disk samples (compute_exit_pupil's
    kind), f32 numpy."""
    rs = np.random.RandomState(seed)
    half = 0.5 * float(jc.film_diag)
    rear_r, rear_z = float(jc.aperture[0]), float(jc.z_pos[0])
    o = np.zeros((n, 3))
    o[:, :2] = rs.uniform(-half, half, (n, 2)) * 0.7
    if jc.kind == "realisticEye":
        rr = float(jc.retina_radius)
        o[:, 2] = rr - np.sqrt(rr * rr - (o[:, :2] ** 2).sum(-1))
    rear = np.stack([rs.uniform(-rear_r, rear_r, n),
                     rs.uniform(-rear_r, rear_r, n), np.full(n, rear_z)], -1)
    d = rear - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _check_lanes(tc, jv, tv, o, d, wl):
    differ = jv != tv
    if differ.any():
        m = _edge_margin(tc, torch.from_numpy(o[differ]),
                         torch.from_numpy(d[differ]),
                         torch.from_numpy(wl[differ]))
        assert (m < 1e-5).all(), m
    return jv & tv


@pytest.mark.parametrize("name,wl", [
    ("singlet", 550.0), ("dgauss", 550.0), ("biconic", 550.0),
    ("eye", 550.0), ("dgauss_ca", 420.0), ("dgauss_ca", 680.0)])
def test_trace_lenses_from_film_matches_jax(cams, name, wl):
    """Camera-space rays through the stack; the eye's with HURB at its
    pupil (per-lane key bits), chromatic aberration on the dgauss lens at
    420 and 680 nm (the dispersion moves the exit directions apart)."""
    base = name.replace("_ca", "")
    jc, _, stack = cams[base]
    if name.endswith("_ca"):
        jc = jc.replace(ca_enabled=True)
    tc = _from_jax(jc)
    o, d = _rear_rays(jc, B, 31)
    wls = np.full(B, wl, np.float32)
    key = np.random.RandomState(32).randint(0, 2 ** 32, B, dtype=np.uint64)
    jkey = jnp.asarray(key.astype(np.uint32)) if base == "eye" else None
    tkey = torch.from_numpy(key.astype(np.int64)) if base == "eye" else None
    jo, jd, jv = (np.asarray(x) for x in jlens.trace_lenses_from_film(
        jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(wls), jkey))
    to, td, tv = (x.numpy() for x in tlens.trace_lenses_from_film(
        tc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(wls),
        tkey))
    both = _check_lanes(tc, jv, tv, o, d, wls)
    assert both.sum() > 200, both.sum()
    tol_o, tol_d = TOL[stack]
    np.testing.assert_allclose(to[both], jo[both], rtol=0, atol=tol_o)
    np.testing.assert_allclose(td[both], jd[both], rtol=0, atol=tol_d)
    if name.endswith("_ca"):
        plain = tlens.trace_lenses_from_film(
            _from_jax(cams[base][0]), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(wls))
        keep = both & plain[2].numpy()
        assert np.abs(td[keep] - plain[1].numpy()[keep]).max() > 1e-5


@pytest.mark.parametrize("name,wl", [
    ("dgauss", None), ("dgauss", 450.0), ("biconic", None), ("eye", None),
    ("eye", 650.0), ("omni_r0", None), ("omni_r0_offsets", None),
    ("omni_r1", None), ("omni_r1_offsets", 500.0)])
def test_generate_rays_matches_jax(cams, name, wl):
    """World rays, weights and dead lanes of generate_rays on pbrt_tpu's
    camera (its exit pupil), for the exit-pupil path (realistic, omni
    without an array, the eye with HURB and its curved retina) and the
    microlens path at simulation radius 0 and 1, with and without
    per-lens offsets."""
    jc, _, stack = cams[name]
    tc = _from_jax(jc)
    W, H = 48, 32
    rs = np.random.RandomState(33)
    pf = (rs.rand(B, 2) * [W, H]).astype(np.float32)
    ul = rs.rand(B, 2).astype(np.float32)
    ut = rs.rand(B).astype(np.float32)
    jr, jw = jlens.generate_rays(jc, jnp.asarray(pf), jnp.asarray(ul),
                                 jnp.asarray(ut), width=W, height=H,
                                 wavelength=wl)
    tr, tw = tlens.generate_rays(tc, torch.from_numpy(pf),
                                 torch.from_numpy(ul), torch.from_numpy(ut),
                                 width=W, height=H, wavelength=wl)
    jv, tv = np.asarray(jr.tmax) > 0, tr.tmax.numpy() > 0
    assert np.array_equal(jv, np.asarray(jw) > 0)
    assert np.array_equal(tv, tw.numpy() > 0)
    differ = jv != tv
    assert differ.sum() == 0, differ.sum()
    assert jv.sum() > 100, jv.sum()
    tol_o, tol_d = TOL[stack]
    np.testing.assert_allclose(tr.o.numpy()[jv], np.asarray(jr.o)[jv],
                               rtol=0, atol=tol_o * 10)
    np.testing.assert_allclose(tr.d.numpy()[jv], np.asarray(jr.d)[jv],
                               rtol=0, atol=tol_d)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    for k in ("wavelength", "time"):
        assert np.array_equal(getattr(tr, k).numpy(),
                              np.asarray(getattr(jr, k))), k


@pytest.mark.parametrize("kind,lens_radius", [
    ("orthographic", 0.0), ("orthographic", 0.05), ("environment", 0.0)])
def test_projective_rays_match_jax(kind, lens_radius):
    W, H = 40, 24
    jx = jtfm.look_at([1, 2, -3], [0, 0, 0], [0, 1, 0])
    tx = ttfm.look_at([1, 2, -3], [0, 0, 0], [0, 1, 0])
    if kind == "orthographic":
        jc = jproj.make_orthographic(jx, W, H, lens_radius=lens_radius,
                                     focal_distance=2.0)
        tc = tproj.make_orthographic(tx, W, H, lens_radius=lens_radius,
                                     focal_distance=2.0, device=DEV)
    else:
        jc = jproj.make_environment(jx, W, H)
        tc = tproj.make_environment(tx, W, H, device=DEV)
    assert tc.kind == jc.kind
    for k in ("cam_to_world", "raster_to_camera", "camera_to_raster"):
        assert np.array_equal(getattr(tc, k).numpy(),
                              np.asarray(getattr(jc, k))), k
    rs = np.random.RandomState(34)
    pf = (rs.rand(1024, 2) * [W, H]).astype(np.float32)
    ul = rs.rand(1024, 2).astype(np.float32)
    jr, jw = jproj.generate_rays(jc, jnp.asarray(pf), jnp.asarray(ul),
                                 width=W, height=H, wavelength=480.0)
    tr, tw = tproj.generate_rays(tc, torch.from_numpy(pf),
                                 torch.from_numpy(ul), width=W, height=H,
                                 wavelength=480.0)
    for k in ("o", "d"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=0,
                                   atol=2e-6)
    assert (tr.wavelength == 480.0).all() and (tw == 1).all()


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _quad_scenes():
    """tests/test_lens.py's emissive quad, 2 m in front of the camera."""
    out = []
    for ir, kw in ((jir, {}), (tir, {"device": DEV})):
        b = ir.SceneBuilder()
        black = b.add_material(ir.MaterialSpec())
        li = b.add_area_light(np.full(31, 20.0, np.float32))
        b.add_triangle_mesh([[-1, -1, 2], [1, -1, 2], [1, 1, 2],
                             [-1, 1, 2]], [[0, 2, 1], [2, 0, 3]], black,
                            light_id=li)
        out.append(b.build(**kw))
    return out


_JIT_GEN = jax.jit(jlens.generate_rays, static_argnames=("width", "height"))


def _jax_render(scene, cam, W, H, spp, trace):
    """pbrt_tpu's render, pass by pass, its camera, trace_paths and
    sampler jitted (the same functions, compiled once)."""
    cfg = JCfg("sobol", 0, spp)
    film = jfilm.make_film(W, H, "box")
    ids = jnp.arange(W * H, dtype=jnp.uint32)
    for s in range(spp):
        ray, w, pf, pid, sidx = jpath.camera_rays_for_pixels(
            cam, W, H, cfg, ids, s, _JIT_GEN)
        film = jfilm.add_samples(film, pf, trace(scene, ray, pid, sidx, cfg,
                                                 max_depth=1), w)
    return np.asarray(jfilm.develop_spectral(film))


@pytest.fixture(scope="module")
def jit_jax():
    with pytest.MonkeyPatch.context() as mp:
        sample_dim = jax.jit(jsamp.sample_dim, static_argnums=0)
        # spectralpath imports it from the sampler module at call time
        mp.setattr(jpath, "sample_dim", sample_dim)
        mp.setattr(jsamp, "sample_dim", sample_dim)
        mp.setattr(jpath, "trace_paths", jax.jit(
            jpath.trace_paths, static_argnums=4,
            static_argnames=("max_depth",)))
        yield


def test_lens_render_matches_jax(cams, jit_jax):
    js, ts = _quad_scenes()
    jc = cams["singlet"][0]
    ji = _jax_render(js, jc, 24, 24, 8, jpath.trace_paths)
    tf = tpath.render(ts, _from_jax(jc),
                      tfilm.make_film(24, 24, "box", device=DEV),
                      TCfg("sobol", 0, 8), 8, max_depth=1)
    ti = tfilm.develop_spectral(tf).numpy()
    assert ti.max() > 1.0 and np.isfinite(ti).all() and (ti >= 0).all()
    assert abs(ti.mean() / ji.mean() - 1) < 1e-5, (ti.mean(), ji.mean())


def test_spectralpath_ca_matches_jax(cams, jit_jax):
    """4 bands, each regenerating its rays at its centre wavelength
    through the singlet with chromatic aberration on."""
    js, ts = _quad_scenes()
    jc = cams["singlet"][0].replace(ca_enabled=True)
    W = H = 16
    ji = _jax_render(js, jc, W, H, 2, jspec.make_trace_spectral(
        4, camera=jc, generate_rays=_JIT_GEN, width=W, height=H))
    tc = _from_jax(jc)
    tf = tpath.render(ts, tc, tfilm.make_film(W, H, "box", device=DEV),
                      TCfg("sobol", 0, 2), 2, max_depth=1,
                      trace_fn=tspec.make_trace_spectral(
                          4, camera=tc, width=W, height=H))
    ti = tfilm.develop_spectral(tf).numpy()
    assert ti.max() > 1.0 and np.isfinite(ti).all() and (ti >= 0).all()
    assert abs(ti.mean() / ji.mean() - 1) < 1e-5, (ti.mean(), ji.mean())


# ---------------------------------------------------------------------------
# the parser and the CLI
# ---------------------------------------------------------------------------

CAMERA_SCENE = """LookAt 0 0 -5  0 0 0  0 1 0
{camera}
Film "image" "integer xresolution" [8] "integer yresolution" [8]
    "float diagonal" [30]
WorldBegin
AreaLightSource "diffuse" "rgb L" [1 1 1]
Shape "trianglemesh" "point P" [-1 -1 0 1 -1 0 1 1 0] "integer indices" [0 1 2]
WorldEnd
"""
CAMERAS = {
    # chromaticAberrationEnabled is not among the keys the JAX parser
    # carries (Queue 3 (a)); no filmdistance: its default 70 mm, so the
    # paraxial focus is never used (Queue 3 (c))
    "realistic": f'Camera "realistic" "string lensfile" ["{DGAUSS}"] '
                 '"float aperturediameter" [6] '
                 '"bool chromaticAberrationEnabled" ["true"]',
    "realistic_focus": f'Camera "realistic" "string lensfile" ["{DGAUSS}"]'
                       ' "float filmdistance" [0] "float focaldistance" [7]',
    "omni": 'Camera "omni" "string lensfile" ["{ml}"] '
            '"float filmdistance" [40]',
    # ior1..4 and diffractionEnabled are not carried either: IoR 1 in
    # every medium (Queue 3 (a))
    "realisticEye": f'Camera "realisticEye" "string lensfile" ["{EYE}"] '
                    '"float ior1" [1.377] "bool diffractionEnabled" ["true"]',
    "humaneye": f'Camera "humaneye" "string lensfile" ["{EYE}"]',
    "orthographic": 'Camera "orthographic" "float lensradius" [0.1] '
                    '"float focaldistance" [3]',
    "environment": 'Camera "environment"',
}


@pytest.mark.parametrize("name", list(CAMERAS))
def test_parser_and_cli_cameras_match_jax(lens_files, name):
    """Each Camera kind parses to pbrt_tpu's job settings, and the CLI's
    build_camera makes pbrt_tpu's camera from them."""
    text = CAMERA_SCENE.format(camera=CAMERAS[name].replace(
        "{ml}", str(lens_files / "ml.json")))
    jj, tj = JAPI().parse_string(text), TAPI(DEV).parse_string(text)
    assert tj.camera_kind == jj.camera_kind
    assert tj.film_diagonal == jj.film_diagonal == 30.0
    jp, tp = dict(jj.camera_params), dict(tj.camera_params)
    assert (jp.pop("screenwindow") is None) and tp.pop("screenwindow") is None
    assert tp == jp
    if name in ("orthographic", "environment"):
        jc, tc = jcli.build_camera(jj, 8, 8), tcli.build_camera(tj, 8, 8, DEV)
        assert tc.kind == jc.kind == name
        for k in ("cam_to_world", "raster_to_camera", "camera_to_raster"):
            assert np.array_equal(getattr(tc, k).numpy(),
                                  np.asarray(getattr(jc, k))), k
        assert np.float32(tc.lens_radius) == np.asarray(jc.lens_radius)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlens, "trace_lenses_from_film", _JIT_TRACE)
        jc = jcli.build_camera(jj, 8, 8)
    tc = tcli.build_camera(tj, 8, 8, DEV)
    for k in tlens.STATIC_FIELDS:
        assert getattr(tc, k) == getattr(jc, k), k
    for k in tlens.TENSOR_FIELDS:
        a, b = np.asarray(getattr(jc, k)), getattr(tc, k).numpy()
        if k == "pupil_bounds":
            assert np.abs(a - b).max() <= _pad(jc)
        else:
            assert np.array_equal(a, b), k
    assert not tc.ca_enabled and not tc.diffraction
    if name == "realistic":
        assert float(tc.film_distance) == np.float32(0.07)
    if name in ("realisticEye", "humaneye"):
        assert (tc.ior_spectra == 1).all() and tc.kind == "realisticEye"


def test_cli_renders_cornell_lens_on_cpu(tmp_path):
    """pbrt_tpu_torch/scenes/cornell_lens.pbrt (realistic dgauss, no
    Sampler line, mitchell filter) at 16x16 through the CLI."""
    text = open(CORNELL_LENS).read().replace(
        '"integer xresolution" [256] "integer yresolution" [256]',
        '"integer xresolution" [16] "integer yresolution" [16]').replace(
        '"lenses/', f'"{LENSES}/')
    scene = tmp_path / "cornell_lens16.pbrt"
    scene.write_text(text)
    out = str(tmp_path / "out.exr")
    assert tcli.main([str(scene), "--cpu", "--quick", "--quiet", "-o",
                      out]) == 0
    img, flag = tio.read_dat(str(tmp_path / "out.dat"))
    assert flag == "v3" and img.shape == (16, 16, 31)
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0
    job = tparse(str(scene), device=DEV)
    assert (job.camera_kind, job.sampler_kind, job.filter_name) == \
        ("realistic", "halton", "mitchell")
    with pytest.raises(NotImplementedError, match="realistic"):
        tcli.run_job(job, spp=1, sampler_override="refsobol")


def test_lens_camera_without_card_raises(lens_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlens.build_lens_camera(
            "realistic", ttfm.Transform(),
            tlens.read_dat_lens(str(lens_files / "singlet.dat")))
