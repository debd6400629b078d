"""The port's ptex textures (textures/ptex.py, the TEX_PTEX lookup, the
per-primitive face index and Hit.face on every intersection route, the
parser's Texture "ptex") against pbrt_tpu's on the CPU.

Tolerances: the file reader and writer and bake_atlas are the same numpy
code (bit for bit); the lookup is the same bilinear fetch of the same
atlas (within 1e-6); Hit.face is an integer column, equal on every lane;
the render: test_torch_volpath.assert_renders_alike.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.textures import ptex as jptex
from pbrt_tpu.textures import textures as jtex
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.textures import ptex as tptex
from pbrt_tpu_torch.textures import textures as ttex
from pbrt_tpu_torch.tools import skin_scene
from test_torch_bssrdf import render_pair
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import assert_scene_equal, jax_arrays
from test_torch_volpath import assert_renders_alike

WALL = 6              # the wall's quads a side: 72 faces


def _faces(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.uniform(0, 1, (4 << (i % 2), 8, 3)).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("dt", [tptex.DT_FLOAT, tptex.DT_UINT8,
                                tptex.DT_UINT16], ids=["f32", "u8", "u16"])
def test_io_and_atlas_bit_for_bit(tmp_path, dt):
    faces = _faces(40)
    a, b = str(tmp_path / "t.ptx"), str(tmp_path / "j.ptx")
    tptex.write_ptex(a, faces, datatype=dt)
    jptex.write_ptex(b, faces, datatype=dt)
    assert open(a, "rb").read() == open(b, "rb").read()
    rt, rj = tptex.read_ptex(a), jptex.read_ptex(a)
    assert len(rt["faces"]) == 40
    for x, y in zip(rt["faces"], rj["faces"]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(tptex.bake_atlas(rt["faces"]),
                    jptex.bake_atlas(rj["faces"])):
        assert np.array_equal(x, y)


def test_ptex_lookup_matches_jax():
    """eval_texture's TEX_PTEX case beside an image texture (the cases'
    order), at seeded uv (outside [0, 1] too: clamped) and faces (past
    the atlas too: clamped to the last tile)."""
    rs = np.random.RandomState(2)
    atlas, tpr, tile = tptex.bake_atlas(_faces(70, 1))
    img = rs.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    tables = []
    for mod in (ttex, jtex):
        reg = mod.TextureTable()
        reg.add(mod.TEX_IMAGE, image=img)
        reg.add(mod.TEX_PTEX, image=atlas, p5=float(tpr), p6=float(tile))
        tables.append(reg.arrays())
    for x, y in zip(*tables):
        assert np.array_equal(x, y)
    B = 2048
    idx = rs.randint(-1, 3, B).astype(np.int32)
    uv = rs.uniform(-0.2, 1.2, (B, 2)).astype(np.float32)
    face = rs.randint(0, 80, B).astype(np.int32)
    p = rs.uniform(-1, 1, (B, 3)).astype(np.float32)
    kinds = (ttex.TEX_IMAGE, ttex.TEX_PTEX)
    out_t = ttex.eval_texture(*(torch.from_numpy(a) for a in tables[0]),
                              torch.from_numpy(idx), torch.from_numpy(uv),
                              torch.from_numpy(p), kinds=kinds,
                              face=torch.from_numpy(face)).numpy()
    out_j = np.asarray(jtex.eval_texture(
        *(jnp.asarray(a) for a in tables[1]), jnp.asarray(idx),
        jnp.asarray(uv), jnp.asarray(p), kinds=kinds,
        face=jnp.asarray(face)))
    assert np.abs(out_t - out_j).max() <= 1e-6


def _scene(tmp_path, accel=""):
    """The skin scene's ptex back wall (WALL x WALL quads, one colour a
    face) in an open box, under a point light."""
    path = str(tmp_path / "wall.ptx")
    tptex.write_ptex(path, skin_scene.wall_faces(2 * WALL * WALL, 0))
    v, f = skin_scene.grid_wall(WALL)
    return f"""{accel}
LookAt 2.5 -4.5 2.5  2.5 2.5 2.5  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Sampler "sobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "point" "rgb I" [20 20 20] "point from" [2.5 1 4]
Texture "wallptex" "spectrum" "ptex" "string filename" "{path}"
Material "matte" "texture Kd" "wallptex"
Shape "trianglemesh" "point P" [{skin_scene._floats(v)}]
  "integer indices" [{skin_scene._ints(f)}]
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "trianglemesh" "point P" [0 0 0 5 0 0 5 5 0 0 5 0]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def test_parsed_scene_equals_scene_from_jax(tmp_path, caplog):
    src = _scene(tmp_path)
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    ts = tj.scene
    assert ts.has_ptex and ttex.TEX_PTEX in ts.tex_kinds
    assert sorted(ts.prim_face.tolist()) == sorted(
        list(range(2 * WALL * WALL)) + [0, 1])
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(jj.scene), "cpu"))
    # a file that cannot be read: the 0.5 constant, with pbrt_tpu's warning
    bad = src.replace(str(tmp_path / "wall.ptx"), "missing.ptx")
    js = JAPI().parse_string(bad).scene
    with caplog.at_level("WARNING"):
        ts = TAPI("cpu").parse_string(bad).scene
    assert "unusable" in caplog.text and not ts.has_ptex
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), "cpu"))


@pytest.mark.parametrize("route", ["dense", "bvh", "kdtree"])
def test_hit_face_on_every_route(tmp_path, route):
    """make_hit fills Hit.face from the primitive's face index on the
    dense kernels' route and on the BVH and kd walks (the port's scene
    parsed under lowered caps), equal to pbrt_tpu's Hit.face."""
    src = _scene(tmp_path, 'Accelerator "kdtree"' if route == "kdtree"
                 else "")
    jj = JAPI().parse_string(src)
    with pytest.MonkeyPatch.context() as mp:
        if route != "dense":
            mp.setattr(tir, "MAX_DENSE_PRIMS", 10)
        ts = TAPI("cpu").parse_string(src).scene
    assert ts.use_dense == (route == "dense")
    assert ts.use_kd == (route == "kdtree")
    rs = np.random.RandomState(1)
    n = 512
    o = np.tile(np.float32([[2.5, -4.5, 2.5]]), (n, 1))
    tgt = np.stack([rs.uniform(0.05, 4.95, n), np.full(n, 5.0),
                    rs.uniform(0.05, 4.95, n)], -1)
    tgt[: n // 4, 1] = rs.uniform(0.5, 4.5, n // 4)     # the floor
    tgt[: n // 4, 2] = 0.0
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    jh = jisect.intersect_full(jj.scene, jgeom.Ray.make(jnp.asarray(o),
                                                        jnp.asarray(d)))
    th = tisect.intersect_full(ts, tgeom.Ray.make(torch.from_numpy(o),
                                                  torch.from_numpy(d)))
    assert bool(th.valid.all())
    assert np.array_equal(th.prim.numpy(), np.asarray(jh.prim))
    assert np.array_equal(th.face.numpy(), np.asarray(jh.face))
    assert len(set(th.face.tolist())) > WALL * WALL


def test_per_face_ptex_renders_like_jax(tmp_path):
    """The wall's faces through the path integrator's gather
    (gather_materials(face=hit.face))."""
    assert_renders_alike(*render_pair(_scene(tmp_path)))
