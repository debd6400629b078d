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

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")
MOTION = os.path.join(ROOT, "pbrt_tpu_torch", "scenes", "cornell_motion.pbrt")
SCENE_FILES = sorted(glob.glob(os.path.join(ROOT, "scenes", "*.pbrt"))) \
    + [MOTION]


def jax_arrays(js):
    return ({k: np.asarray(getattr(js, k)) for k in tir.JAX_COLUMNS},
            {k: getattr(js, k) for k in tir.JAX_STATICS})


def assert_scene_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert torch.equal(x, y), f
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
    ('LightSource "distant" "rgb L" [3 3 3]', "LightSource"),
    ('Texture "t" "spectrum" "checkerboard"', "Texture"),
    ('MakeNamedMaterial "m" "string type" "matte"', "MakeNamedMaterial"),
    ('Material "metal"', "metal"),
    ('Material "matte" "texture Kd" "t"', "texture parameter"),
    ('Shape "cylinder"', "cylinder"),
    ('AreaLightSource "goniometric"', "goniometric"),
])
def test_unported_world_directives_raise(snippet, name):
    text = f"WorldBegin\n{snippet}\nWorldEnd\n"
    with pytest.raises(NotImplementedError, match=name):
        TAPI(DEV).parse_string(text)


@pytest.mark.parametrize("snippet,name", [
    ('Camera "fisheye"', "fisheye"),
    ('Accelerator "kdtree"', "Accelerator"),
    ('PixelFilter "lanczos"', "lanczos"),
    ('Film "rgb"', "rgb"),
    ("TransformTimes 0 2", "TransformTimes"),
])
def test_unported_options_raise(snippet, name):
    with pytest.raises(NotImplementedError, match=name):
        TAPI(DEV).parse_string(snippet + "\n")


def test_unported_integrator_raises_at_render():
    text = MOTION_TEXT.replace('WorldBegin',
                               'Sampler "sobol"\nIntegrator "bdpt"\n'
                               'WorldBegin')
    job = TAPI(DEV).parse_string(text)
    with pytest.raises(NotImplementedError, match="bdpt"):
        tcli.run_job(job, spp=1, max_depth=1)


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
