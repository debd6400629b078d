"""The port's .pbrt tokenizer, parser and CLI against pbrt_tpu's (CPU).

Tolerances: exact.  Tokens, scene columns (the port's SceneData against
`scene_from_jax` of pbrt_tpu's parse), job settings and the bytes of the
.dat and sidecar files are compared for equality: both packages run the
same host code (f64 numpy transforms, the same BVH builders, the same
f64 section tables) on the same text.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.parser import tokenizer as jtok
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.parser import tokenizer as ttok
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_core import tensors_equal
from test_torch_lighttracer import jax_light_render
from test_torch_volpath import assert_renders_alike

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")
MOTION = os.path.join(ROOT, "pbrt_tpu_torch", "scenes", "cornell_motion.pbrt")
SCENE_FILES = sorted(glob.glob(os.path.join(ROOT, "scenes", "*.pbrt"))) \
    + [MOTION]


def jax_arrays(js):
    return ({k: np.asarray(getattr(js, k)) for k in tir.JAX_ARRAYS},
            {k: getattr(js, k) for k in tir.JAX_STATICS})


def assert_scene_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert tensors_equal(x, y), f
        else:
            assert x == y, f


def small_film(path, tmp_path, res=16):
    """A copy of a scene file with its film cut to res x res."""
    text = open(path).read().replace(
        '"integer xresolution" [256] "integer yresolution" [256]',
        f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    out = tmp_path / os.path.basename(path)
    out.write_text(text)
    return str(out)


@pytest.mark.parametrize("path", SCENE_FILES, ids=os.path.basename)
def test_tokens_equal_jax(path):
    assert list(ttok.tokenize_file(path)) == list(jtok.tokenize_file(path))


@pytest.fixture(scope="module")
def jobs():
    return {name: (jparse(path), tparse(path, device=DEV))
            for name, path in (("bench", BENCH), ("motion", MOTION))}


@pytest.mark.parametrize("name", ["bench", "motion"])
def test_scene_equals_scene_from_jax(jobs, name):
    jj, tj = jobs[name]
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    DEV))
    motion = name == "motion"
    assert jj.scene.dense_motion == jj.scene.has_animated_quads == motion
    assert tj.scene.dense_motion == tj.scene.has_animated_quads == motion
    chunk = tj.scene.dense_chunk
    assert tj.scene.dense_w.shape == (48, 16, (16 if motion else 4) * chunk)
    assert bool(tj.scene.tri_motion.any()) == motion


@pytest.mark.parametrize("name", ["bench", "motion"])
def test_job_settings_equal_jax(jobs, name):
    jj, tj = jobs[name]
    assert np.array_equal(jj.cam_to_world.m, tj.cam_to_world.m)
    assert jj.cam_to_world1 is None and tj.cam_to_world1 is None
    for k in ("film_width", "film_height", "film_filename", "film_scale",
              "spectral_flag", "crop_window", "filter_name", "filter_params", "sampler_kind", "spp", "integrator_kind",
              "instance_names", "material_names", "max_sample_luminance"):
        assert getattr(jj, k) == getattr(tj, k), k
    for k in ("maxdepth", "rrthreshold", "lightsamplestrategy"):
        assert jj.integrator_params[k] == tj.integrator_params[k], k
    for k in ("fov", "lensradius", "focaldistance", "shutteropen",
              "shutterclose"):
        assert jj.camera_params[k] == tj.camera_params[k], k


# tests/test_motion_blur.py's mesh-motion scene, with an area light in
# place of its distant light (distant lights are not ported)
MOTION_TEXT = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
    "float shutteropen" [0] "float shutterclose" [1]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "rgb L" [3 3 3]
ReverseOrientation
Shape "trianglemesh" "point P" [-4 -4 6  4 -4 6  4 4 6  -4 4 6]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
Material "matte" "rgb Kd" [.8 .8 .8]
TransformBegin
ActiveTransform EndTime
Translate 2 0 0.5
Rotate 25 0 0 1
ActiveTransform All
Shape "trianglemesh" "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
    "integer indices" [0 1 2 2 3 0] "float uv" [0 0 1 0 1 1 0 1]
TransformEnd
Shape "trianglemesh" "point P" [-3 -3 -2  3 -3 -2  3 3 -2  -3 3 -2]
    "integer indices" [0 1 2 2 3 0]
AttributeBegin
Material "glass" "float eta" [1.33]
Translate 0 1 0
Scale 0.5 0.5 0.5
ActiveTransform EndTime
Rotate 40 1 0 0
Translate 0 0 1
ActiveTransform All
Shape "sphere" "float radius" [0.8]
AttributeEnd
WorldEnd
"""


def test_motion_text_parses_like_jax():
    """Mesh and sphere motion (ActiveTransform EndTime inside
    TransformBegin/End and AttributeBegin/End), ReverseOrientation, uvs,
    an area light and glass: the same scene and sidecar names."""
    jj = JAPI().parse_string(MOTION_TEXT)
    tj = TAPI(DEV).parse_string(MOTION_TEXT)
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    DEV))
    assert tj.scene.has_animated_mesh and tj.scene.has_animated_quads
    assert jj.instance_names == tj.instance_names
    assert jj.material_names == tj.material_names


def test_camera_keyframes_parse_like_jax():
    text = MOTION_TEXT.replace(
        "LookAt 0 0 5  0 0 0  0 1 0",
        "LookAt 0 0 5  0 0 0  0 1 0\nActiveTransform EndTime\n"
        "Translate 0.5 0 0\nActiveTransform All")
    jj = JAPI().parse_string(text)
    tj = TAPI(DEV).parse_string(text)
    assert np.array_equal(jj.cam_to_world.m, tj.cam_to_world.m)
    assert np.array_equal(jj.cam_to_world1.m, tj.cam_to_world1.m)


@pytest.mark.parametrize("snippet,name", [
    ('AreaLightSource "goniometric"\nShape "disk"', "goniometric"),
    ('AreaLightSource "goniometric"', "goniometric"),
])
def test_unported_world_directives_raise(snippet, name, caplog):
    """Once raised: an area light of another kind is a diffuse area light,
    as pbrt_tpu parses it, with a warning naming the kind."""
    text = (f'WorldBegin\n{snippet}\nShape "sphere" "float radius" [1]\n'
            "WorldEnd\n")
    jj, tj = JAPI().parse_string(text), TAPI(DEV).parse_string(text)
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    DEV))
    assert tj.scene.n_lights == jj.scene.n_lights >= 1
    assert any(name in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("snippet", [
    'Material "hair"',
    'Texture "t" "spectrum" "ptex" "string filename" "x.ptx"\n'
    'Material "matte" "texture Kd" "t"',
    'MakeNamedMaterial "m" "string type" "hair"\nNamedMaterial "m"',
    'Material "fourier"',
    'Material "subsurface"',
    'Material "kdsubsurface"',
    'Material "nosuchmaterial"',
], ids=["hair", "ptex", "named-hair", "fourier", "subsurface",
        "kdsubsurface", "unknown"])
def test_material_directives_parse_like_jax(snippet):
    """The materials and texture the port once rejected parse as pbrt_tpu
    parses them: a ptex or fourier file that cannot be read falls back
    (0.5, matte) and an unknown material is matte, with a warning."""
    text = (f"WorldBegin\n{snippet}\nShape \"sphere\" \"float radius\" "
            "[1]\nWorldEnd\n")
    jj, tj = JAPI().parse_string(text), TAPI(DEV).parse_string(text)
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    DEV))


@pytest.mark.parametrize("snippet,name", [
    ('Camera "fisheye"', "fisheye"),
    ('Camera "thinlens"', "thinlens"),
    ('PixelFilter "lanczos"', "lanczos"),
    ('Film "rgb"', "rgb"),
    ("TransformTimes 0 2", "TransformTimes"),
])
def test_unported_options_raise(snippet, name, caplog):
    """An unknown PixelFilter (lanczos) raises, as in pbrt_tpu.  The rest
    once raised and now parse as pbrt_tpu parses them, with a warning
    naming them: another camera kind is kept by name and renders as
    perspective (the CLI's build_camera, both packages), a Film's name is
    dropped, TransformTimes is recorded and read nowhere."""
    if name == "lanczos":
        with pytest.raises(NotImplementedError, match=name):
            TAPI(DEV).parse_string(snippet + "\n")
        return
    text = (f'{snippet} "float fov" [50] "integer xresolution" [24]\n'
            if name in ("rgb", "fisheye") else snippet + "\n")
    text += 'WorldBegin\nShape "sphere" "float radius" [1]\nWorldEnd\n'
    japi, tapi = JAPI(), TAPI(DEV)
    jj, tj = japi.parse_string(text), tapi.parse_string(text)
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    DEV))
    for k in ("camera_kind", "film_width", "film_height", "film_filename"):
        assert getattr(jj, k) == getattr(tj, k), k
    for k in ("fov", "lensradius", "focaldistance"):
        assert jj.camera_params[k] == tj.camera_params[k], k
    assert japi.transform_times == tapi.transform_times
    assert any(name in r.getMessage() for r in caplog.records)
    if name in ("fisheye", "thinlens"):
        jc = jcli.build_camera(jj, 8, 8)
        tc = tcli.build_camera(tj, 8, 8, DEV)
        assert type(tc).__name__ == type(jc).__name__
        assert np.array_equal(tc.raster_to_camera.numpy(),
                              np.asarray(jc.raster_to_camera))


def test_unported_integrator_raises_at_render():
    """Integrator "bdpt", once unported, renders the motion scene (8x8,
    1 spp, depth 1) through run_job as pbrt_tpu's does: image mean within
    1e-4, >= 97% of pixels within 1e-3 (test_torch_volpath's tolerance)."""
    text = MOTION_TEXT.replace('WorldBegin',
                               'Sampler "sobol"\nIntegrator "bdpt"\n'
                               'WorldBegin')
    jj, job = JAPI().parse_string(text), TAPI(DEV).parse_string(text)
    for j in (jj, job):
        j.film_width = j.film_height = 8
    assert job.integrator_kind == "bdpt" and job.scene.dense_motion
    film, _ = tcli.run_job(job, spp=1, max_depth=1)
    assert_renders_alike(tfilm.develop_spectral(film).numpy(),
                         jax_light_render(jj, 1, 1))


def test_cli_renders_on_cpu_and_writes_outputs(tmp_path):
    scene = small_film(BENCH, tmp_path)
    out = str(tmp_path / "out.exr")
    assert tcli.main([scene, "--cpu", "--quick", "--quiet", "-o", out]) == 0
    for suffix in (".exr", ".dat", "_mesh.txt", "_materials.txt"):
        assert os.path.getsize(str(tmp_path / "out") + suffix) > 0, suffix
    img, flag = tio.read_dat(str(tmp_path / "out.dat"))
    assert flag == "v3" and img.shape == (16, 16, 31)
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0


def test_cli_without_card_raises(tmp_path, monkeypatch):
    """No --cpu and no visible card: the CLI raises and renders nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = small_film(BENCH, tmp_path)
    out = str(tmp_path / "out.exr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([scene, "--quick", "--quiet", "-o", out])
    assert not os.path.exists(out)


@pytest.mark.parametrize("name", ["bench", "motion"])
def test_write_outputs_bytes_equal_jax(jobs, tmp_path, name):
    """The .dat (at a film scale of 2) and the sidecars are byte-identical
    to pbrt_tpu's for the same film contents."""
    jj, tj = (dataclasses.replace(j, film_scale=2.0) for j in jobs[name])
    rs = np.random.RandomState(31)
    W, H = 12, 10
    raw = rs.rand(H, W, 31).astype(np.float32)
    weighted = rs.rand(H, W, 31).astype(np.float32)
    weight = rs.rand(H, W).astype(np.float32) + 0.5
    jf = jfilm.make_film(W, H).replace(raw=raw, weighted=weighted,
                                       weight=weight)
    tf = dataclasses.replace(tfilm.make_film(W, H, device=DEV),
                             raw=torch.from_numpy(raw),
                             weighted=torch.from_numpy(weighted),
                             weight=torch.from_numpy(weight))
    jout = jcli.write_outputs(jj, jf, str(tmp_path / "jax.exr"), quiet=True)
    tout = tcli.write_outputs(tj, tf, str(tmp_path / "port.exr"), quiet=True)
    assert [os.path.basename(p).replace("jax", "") for p in jout] == \
        [os.path.basename(p).replace("port", "") for p in tout]
    for a, b in zip(jout[1:], tout[1:]):          # .dat, _mesh, _materials
        assert open(a, "rb").read() == open(b, "rb").read(), b


FLOOR_PNG = os.path.join(ROOT, "pbrt_tpu_torch", "scenes", "textures",
                         "floor.png")
# every ported material, texture and named-material form, one a scene
MATERIAL_SNIPPETS = {
    "none": 'Material ""',
    "none_named": 'Material "none"',
    "matte_sigma_checker": (
        'Texture "c" "spectrum" "checkerboard" "float uscale" [4] '
        '"float vscale" [2] "float udelta" [.5] "rgb tex1" [.9 .1 .1] '
        '"rgb tex2" [.1 .1 .9]\n'
        'Texture "s" "float" "constant" "float value" [12]\n'
        'Material "matte" "texture Kd" "c" "texture sigma" "s"'),
    "matte_bump_float_kd": (
        'Texture "w" "float" "wrinkled" "float scale" [3]\n'
        'Texture "f" "float" "fbm"\n'
        'Material "matte" "texture Kd" "f" "texture bumpmap" "w"'),
    "plastic_beckmann_image": (
        f'Texture "img" "color" "imagemap" "string filename" "{FLOOR_PNG}" '
        '"float uscale" [2] "float vscale" [3] "float udelta" [.25] '
        '"float vdelta" [.5]\n'
        'Material "plastic" "rgb Kd" [.2 .3 .4] "texture Ks" "img" '
        '"float roughness" [.2] "string distribution" "beckmann" '
        '"bool remaproughness" "false"'),
    "imagemap_missing": (
        'Texture "img" "spectrum" "imagemap" "string filename" '
        '"no_such.png"\nMaterial "matte" "texture Kd" "img"'),
    "folded_textures": (
        'Texture "a" "spectrum" "constant" "rgb value" [.2 .4 .6]\n'
        'Texture "b" "spectrum" "scale" "texture tex1" "a" '
        '"rgb tex2" [.5 .5 .5]\n'
        'Texture "m" "spectrum" "mix" "texture tex1" "a" "texture tex2" "b" '
        '"float amount" [.3]\n'
        'Texture "u" "spectrum" "uv" "float uscale" [2]\n'
        'Texture "d" "spectrum" "dots" "rgb inside" [1 1 0]\n'
        'Texture "mb" "spectrum" "marble" "float scale" [2]\n'
        'Texture "wd" "spectrum" "windy"\n'
        'Texture "x" "spectrum" "scale" "texture tex1" "u"\n'
        'Material "substrate" "texture Kd" "m" "texture Ks" "x" '
        '"float uroughness" [.05] "float vroughness" [.2]'),
    "glass_rough": ('Material "glass" "float uroughness" [.1] '
                    '"float vroughness" [.2] "float index" [1.7]'),
    "glass_smooth": 'Material "glass" "float eta" [1.33] "rgb Kr" [.9 .9 .9]',
    "metal_default": 'Material "metal"',
    "metal_custom": ('Material "metal" "rgb eta" [.2 .9 1.1] '
                     '"rgb k" [3.9 2.4 2.2] "float uroughness" [.03] '
                     '"float vroughness" [.1] "string distribution" '
                     '"beckmann"'),
    "uber": ('Material "uber" "rgb Kd" [.6 .5 .2] "rgb Ks" [.3 .3 .3] '
             '"rgb Kr" [.1 .1 .1] "rgb Kt" [.2 .2 .2] '
             '"rgb opacity" [.5 .6 .7] "float roughness" [.05] '
             '"float eta" [1.4]'),
    "translucent": ('Texture "u" "spectrum" "uv"\n'
                    'Material "translucent" "texture Kd" "u" '
                    '"rgb reflect" [.4 .4 .4] "rgb transmit" [.6 .6 .6] '
                    '"float roughness" [.2]'),
    "retroreflective": ('Material "retroreflective" "rgb Kd" [.3 .3 .3] '
                        '"rgb Ks" [.6 .6 .6] "float roughness" [.2]'),
    "disney": ('Material "disney" "rgb color" [.8 .3 .3] '
               '"float metallic" [.3] "float speculartint" [.2] '
               '"float sheen" [.4] "float sheentint" [.6] '
               '"float clearcoat" [.8] "float clearcoatgloss" [.7] '
               '"float spectrans" [.4] "float anisotropic" [.5] '
               '"float roughness" [.3] "float eta" [1.6]'),
    "named_and_mix": (
        'MakeNamedMaterial "a" "string type" "plastic" "rgb Kd" [.5 .1 .1]\n'
        'MakeNamedMaterial "b" "string type" "metal"\n'
        'NamedMaterial "b"\n'
        'Shape "trianglemesh" "point P" [0 0 1 1 0 1 1 1 1] '
        '"integer indices" [0 1 2]\n'
        'NamedMaterial "nope"\n'
        'Material "mix" "string namedmaterial1" "a" '
        '"string namedmaterial2" "b" "rgb amount" [.2 .3 .4]'),
    "mix_unknown": ('Material "mix" "string namedmaterial1" "x" '
                    '"string namedmaterial2" "y"'),
}


def _material_scene(snippet):
    return ("WorldBegin\n" + snippet + "\n"
            'Shape "trianglemesh" "point P" [0 0 0 1 0 0 1 1 0 0 1 0] '
            '"integer indices" [0 1 2 2 3 0] "float uv" [0 0 1 0 1 1 0 1]\n'
            "WorldEnd\n")


@pytest.mark.parametrize("name", sorted(MATERIAL_SNIPPETS))
def test_material_strings_parse_like_jax(name):
    """Each Material / Texture / MakeNamedMaterial / NamedMaterial form:
    the same material, texture and static columns (scene_from_jax of
    pbrt_tpu's parse, the conductor spectra, opacity and the Beckmann
    flag read from its packed table) and sidecar names."""
    text = _material_scene(MATERIAL_SNIPPETS[name])
    jj = JAPI().parse_string(text)
    tj = TAPI(DEV).parse_string(text)
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    DEV))
    assert jj.material_names == tj.material_names
    for k in ("eta_spec", "k_spec", "opacity"):
        assert np.array_equal(getattr(tj.scene, "mat_" + k).numpy(),
                              np.asarray(getattr(jj.scene, "mat_" + k))), k


def test_named_material_sidecars_equal_jax(tmp_path):
    """The _materials.txt / _mesh.txt sidecars of a scene with named
    materials are byte-identical to pbrt_tpu's."""
    text = _material_scene(MATERIAL_SNIPPETS["named_and_mix"])
    jj = JAPI().parse_string(text)
    tj = TAPI(DEV).parse_string(text)
    W, H = 4, 3
    jf = jfilm.make_film(W, H)
    tf = tfilm.make_film(W, H, device=DEV)
    jout = jcli.write_outputs(jj, jf, str(tmp_path / "jax.exr"), quiet=True)
    tout = tcli.write_outputs(tj, tf, str(tmp_path / "port.exr"), quiet=True)
    for a, b in zip(jout[-2:], tout[-2:]):
        assert open(a, "rb").read() == open(b, "rb").read(), b
    assert b" a\n" in open(tout[-1], "rb").read()


def test_bilerp_folds_to_the_corner_mean_where_jax_raises():
    """pbrt_tpu's bilerp folding formats its corner names with
    f"v{i:02d}" over strings and raises ValueError
    (pbrt_tpu/parser/api.py:453); the port folds to the mean of the four
    corners, the folding that code intends."""
    snippet = ('Texture "bl" "spectrum" "bilerp" "rgb v00" [.8 0 0] '
               '"rgb v11" [0 0 .4]\nMaterial "matte" "texture Kd" "bl"')
    with pytest.raises(ValueError):
        JAPI().parse_string(_material_scene(snippet))
    tj = TAPI(DEV).parse_string(_material_scene(snippet))
    from pbrt_tpu_torch.core import spectrum as tspec
    want = (tspec.from_rgb_np(np.array([.8, 0, 0]), "illuminant")
            + tspec.from_rgb_np(np.array([0, 0, .4]), "illuminant")) / 4
    np.testing.assert_allclose(tj.scene.mat_kd[-1].numpy(), want, rtol=1e-6)
    assert int(tj.scene.mat_kd_tex[-1]) == -1


# ---------------------------------------------------------------------------
# lights and their spectra (exact: the same host code on the same text)
# ---------------------------------------------------------------------------

LIGHT_DIR = os.path.join(ROOT, "pbrt_tpu_torch", "scenes")
LIGHT_FLOOR = ('Shape "trianglemesh" "point P" [0 0 0 4 0 0 4 4 0 0 4 0] '
               '"integer indices" [0 1 2 2 3 0]\n')
LIGHT_SPECTRA = {
    "rgb": '"rgb I" [.4 .5 .6]',
    "xyz": '"xyz I" [.4 .5 .6]',
    "blackbody": '"blackbody I" [2700 3 6500 .5]',
    "inline": '"spectrum I" [400 1 450 2 500 1.5 700 3]',
    "spd_file": '"spectrum I" "textures/cie_illuminant_a.spd"',
}
LIGHT_SNIPPETS = {
    "point": 'Translate 1 2 3\nLightSource "point" "rgb I" [2 2 2] '
             '"point from" [.5 0 1]',
    "spot": 'LightSource "spot" "rgb I" [5 5 5] "point from" [2 2 4] '
            '"point to" [1 2 0] "float coneangle" [25] '
            '"float conedeltaangle" [7] "float scale" [2]',
    "distant": 'LightSource "distant" "xyz L" [1 1.1 1.2] '
               '"point from" [0 -5 5] "point to" [0 0 0]',
    "infinite": 'LightSource "infinite" "rgb L" [.3 .4 .5]',
    "exinfinite_map": 'Rotate -90 1 0 0\nLightSource "exinfinite" '
                      '"string mapname" "textures/sky.exr" '
                      '"blackbody L" [6500 1]',
    "goniometric": 'Translate 2 2 3\nRotate 30 1 0 0\nLightSource '
                   '"goniometric" "string mapname" "textures/floor.png" '
                   '"spectrum I" [400 2 700 3]',
    "projection": 'Translate 2 2 3\nLightSource "projection" '
                  '"string mapname" "textures/floor.png" "float fov" [35]',
    "sphere_area": 'AreaLightSource "diffuse" "blackbody L" [4000 3]\n'
                   'Translate 1 1 1\nScale 2 2 2\n'
                   'Shape "sphere" "float radius" [.25]',
    "unknown": 'LightSource "sunsky" "rgb L" [1 1 1]',
}


def _light_scenes(snippet):
    text = f"WorldBegin\n{LIGHT_FLOOR}{snippet}\nWorldEnd\n"
    return (JAPI().parse_string(text, scene_dir=LIGHT_DIR).scene,
            TAPI(DEV).parse_string(text, scene_dir=LIGHT_DIR).scene)


@pytest.mark.parametrize("kind", sorted(LIGHT_SPECTRA))
def test_light_spectra_parse_like_jax(kind):
    """rgb, xyz, blackbody pairs, inline spectra and an .spd file next to
    the scene: the light's spectrum equals pbrt_tpu's bit for bit."""
    js, ts = _light_scenes(f'LightSource "point" {LIGHT_SPECTRA[kind]}')
    assert np.array_equal(ts.light_L.numpy(), np.asarray(js.light_L))
    assert ts.light_L.abs().sum() > 0


@pytest.mark.parametrize("kind", sorted(LIGHT_SNIPPETS))
def test_light_sources_parse_like_jax(kind):
    """Each LightSource kind (and a sphere area light) gives pbrt_tpu's
    light columns, selection and env tables and statics, column for
    column; an unknown light is skipped, as in pbrt_tpu."""
    js, ts = _light_scenes(LIGHT_SNIPPETS[kind])
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), DEV))
    for k in tir.LIGHT_COLUMNS:
        assert np.array_equal(getattr(ts, k).numpy(),
                              np.asarray(getattr(js, k))), k
    assert ts.n_lights == (0 if kind == "unknown" else 1)
