"""The port's shapes and the rest of the scene format against pbrt_tpu's,
on the CPU: the shape modules (PLY, Loop subdivision, curves, NURBS and
the hyperboloid), the parser's shapes and directives (plymesh,
loopsubdiv, heightfield, curve, nurbs, hyperboloid, the quadrics,
ObjectBegin / ObjectInstance, CoordinateSystem / CoordSysTransform,
Accelerator), and the Film's cropwindow and maxsampleluminance and the
integrator's rrthreshold through `render`.

The scene is the shapes cell's (`tools/shapes_scene.py`) at a small size:
level-1 blobs, 2 instances, a 6 x 6 heightfield, a level-1 loopsubdiv,
2,999 primitives.

Tolerances:
- the shape modules: arrays equal (`np.array_equal`): both packages run
  the same numpy code;
- the parsed scene, through `scene_from_jax` of pbrt_tpu's parse: every
  column equal, the quadric transforms included (both compose the same
  f64 transforms and round them to f32 once);
- renders (16x16, 2 spp, depth 3; pbrt_tpu's pass unfused with its
  pieces jitted, test_torch_volpath.jax_render): test_torch_volpath's
  image tolerance, mean within 1e-4 relative, >= 97% of pixels within
  1e-3 and >= 99% within 1e-2 (the same samples, so the same paths but
  where the two intersectors part at a rounding tie);
- the metadata integrator's "mesh" ids: equal on >= 99% of pixels.
"""
import logging
import os
import tempfile

import numpy as np
import pytest
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.shapes import curve as jcurve
from pbrt_tpu.shapes import nurbs as jnurbs
from pbrt_tpu.shapes import ply as jply
from pbrt_tpu.shapes import subdiv as jsubdiv
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.shapes import curve as tcurve
from pbrt_tpu_torch.shapes import nurbs as tnurbs
from pbrt_tpu_torch.shapes import ply as tply
from pbrt_tpu_torch.shapes import subdiv as tsubdiv
from pbrt_tpu_torch.tools import pbrt as tcli
from pbrt_tpu_torch.tools import shapes_scene
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import assert_scene_equal, jax_arrays
from test_torch_volpath import assert_renders_alike, jax_render

SMALL = dict(level=1, instances=2, field=6, subdiv=1, res=16, spp=2)
SPP, DEPTH = 2, 3


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the shape modules
# ---------------------------------------------------------------------------

def _binary_ply(path, V, counts, idx):
    """tests/test_ply.py's writer: float32 xyz, uchar / int32 lists."""
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(V)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(counts)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(np.asarray(V, np.float32).tobytes())
        for n, row in zip(counts, idx):
            f.write(np.uint8(n).tobytes()
                    + np.asarray(row[:n], np.int32).tobytes())


@pytest.mark.parametrize("case", ["triangles", "quads", "quads+triangle",
                                  "ascii", "ascii-normals-uv"])
def test_read_ply_equals_jax(tmp_path, case):
    """tests/test_ply.py's cases: the binary fast path, a quad fan, the
    per-face loop a non-uniform face list takes, and ascii files."""
    rng = np.random.RandomState(0)
    V = rng.rand(50, 3).astype(np.float32)
    p = str(tmp_path / "m.ply")
    if case == "triangles":
        _binary_ply(p, V, [3] * 40, rng.randint(0, 50, (40, 3)))
    elif case.startswith("quads"):
        counts = [4] * 7 + ([3] if case == "quads+triangle" else [])
        _binary_ply(p, V, counts, rng.randint(0, 50, (len(counts), 4)))
    else:
        F = (np.arange(30).reshape(10, 3) % 20).astype(np.int64)
        extra = ({} if case == "ascii" else
                 dict(norms=rng.rand(50, 3), uvs=rng.rand(50, 2)))
        jply.write_ply(p, V, F, **extra)
    _equal(tply.read_ply(p), jply.read_ply(p))


@pytest.mark.parametrize("normals", [False, True])
def test_binary_write_ply_reads_back_in_jax(tmp_path, normals):
    """The port's binary writer (the shapes scene's blob): pbrt_tpu's
    reader returns the float32 values and the faces exactly."""
    v, f, n = shapes_scene.blob(2, seed=3)
    p = str(tmp_path / "b.ply")
    tply.write_ply(p, v, f, norms=n if normals else None, binary=True)
    jv, jf, jn, juv = jply.read_ply(p)
    assert np.array_equal(jv, v.astype(np.float32).astype(np.float64))
    assert np.array_equal(jf, f) and juv is None
    assert (jn is None) == (not normals)
    if normals:
        assert np.array_equal(jn, n.astype(np.float32).astype(np.float64))
    _equal(tply.read_ply(p), (jv, jf, jn, juv))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_loop_subdivide_equals_jax(levels):
    """An icosahedron and an open fan (boundary rules), levels 1-3."""
    v, f = shapes_scene.icosahedron()
    _equal(tsubdiv.loop_subdivide(v, f, levels),
           jsubdiv.loop_subdivide(v, f, levels))
    fan = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0.3], [0, 1, 0],
                    [-1, 0.2, 0.1]], np.float64)
    ff = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4]])
    _equal(tsubdiv.loop_subdivide(fan, ff, levels),
           jsubdiv.loop_subdivide(fan, ff, levels))


def test_curves_equal_jax():
    """tests/test_curve.py's cases and curve_from_params' bases."""
    cp = np.array([[0, 0, 0], [1, 0, 0], [2, 1, 0], [3, 1, 1]], float)
    u = np.linspace(0, 1, 9)
    assert np.array_equal(tcurve.bezier_eval(cp, u),
                          jcurve.bezier_eval(cp, u))
    assert np.array_equal(tcurve.bspline_to_bezier(cp),
                          jcurve.bspline_to_bezier(cp))
    for args, kw in (((cp, 0.2, 0.4, "flat"), dict(n_segments=4)),
                     ((cp, 0.1, 0.1, "cylinder"),
                      dict(n_segments=4, n_sides=6)),
                     ((cp, 0.1, 0.3, "ribbon"),
                      dict(normal0=np.array([0.0, 1.0, 0.0])))):
        _equal(tcurve.tessellate_curve(*args, **kw),
               jcurve.tessellate_curve(*args, **kw))
    P = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0], [4, 0, 0],
                  [5, 1, 0], [6, 1, 1]], float)
    for kw in (dict(basis="bspline", width0=0.1, width1=0.1),
               dict(basis="bezier", width0=0.2, width1=0.05,
                    curve_type="cylinder"),
               dict(degree=2, width0=0.1, width1=0.1)):
        _equal(tcurve.curve_from_params(P, **kw),
               jcurve.curve_from_params(P, **kw))


def test_nurbs_and_hyperboloid_equal_jax():
    """tests/test_nurbs.py's cases: the basis, a linear and a rational
    patch, and the hyperboloid at a full and a partial sweep."""
    knots = [0, 0, 0, 0, 1, 2, 3, 3, 3, 3]
    u = np.linspace(0, 3, 50)
    assert np.array_equal(tnurbs._basis_functions(u, 4, knots),
                          jnurbs._basis_functions(u, 4, knots))
    lin = [0, 0, 1, 1]
    P = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 1]], float)
    _equal(tnurbs.tessellate_nurbs(2, 2, 2, 2, lin, lin, 0, 1, 0, 1, P=P),
           jnurbs.tessellate_nurbs(2, 2, 2, 2, lin, lin, 0, 1, 0, 1, P=P))
    w = np.sqrt(2) / 2
    Pw = np.array([[1, 0, 0, 1], [w, w, 0, w], [0, 1, 0, 1]] * 2, float)
    k3 = [0, 0, 0, 1, 1, 1]
    _equal(tnurbs.tessellate_nurbs(3, 2, 3, 2, k3, lin, 0, 1, 0, 1, Pw=Pw),
           jnurbs.tessellate_nurbs(3, 2, 3, 2, k3, lin, 0, 1, 0, 1, Pw=Pw))
    for p1, p2, phimax in (([1, 0, -1], [1, 0, 1], 2 * np.pi),
                           ([0.4, 0, 0], [0.2, 0.3, 1.1], np.radians(250))):
        _equal(tnurbs.tessellate_hyperboloid(p1, p2, phimax),
               jnurbs.tessellate_hyperboloid(p1, p2, phimax))


# ---------------------------------------------------------------------------
# the parser on the shapes scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("shapes")
    return shapes_scene.write_shapes_scene(str(d), **SMALL)


def _jobs(path, edit=None, apis=None):
    text = open(path).read()
    if edit is not None:
        text = edit(text)
    d = os.path.dirname(path)
    ja, ta = apis or (JAPI(), TAPI("cpu"))
    return ja.parse_string(text, d), ta.parse_string(text, d)


def test_shapes_scene_parses_like_jax(small_scene):
    ja, ta = JAPI(), TAPI("cpu")
    jj, tj = _jobs(small_scene, apis=(ja, ta))
    s = tj.scene
    assert_scene_equal(s, tir.scene_from_jax(*jax_arrays(jj.scene), "cpu"))
    # every quadric type, the clip on, and the blob's two instances
    assert sorted(s.quad_type.tolist()) == [1, 2, 3, 4, 5]
    assert s.clip_quadrics and s.n_quadrics == 5
    assert jj.instance_names == tj.instance_names
    assert list(tj.instance_names.values()).count("blob") == 2
    assert tj.instance_names[7] == "plymesh_7"   # the object's own id
    assert 7 not in set(s.prim_instance.tolist())
    assert {8, 9} <= set(s.prim_instance.tolist())
    assert ja.accel_kind == ta.accel_kind == "bvh"
    assert ja.named_coord_systems.keys() == ta.named_coord_systems.keys()
    for k, v in ja.named_coord_systems.items():
        assert all(np.array_equal(a.m, b.m)
                   for a, b in zip(v, ta.named_coord_systems[k])), k


def test_directives_parse_like_jax():
    """Object instances with a quadric and a reversed mesh, a camera
    coordinate system, an unknown system (warns), mesh motion inside
    ObjectBegin (warns, the second keyframe dropped), quadric and mesh
    motion outside it, and the defaults of each quadric."""
    text = """LookAt 0 0 5  0 0 0  0 1 0
CoordinateSystem "eye"
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
ObjectBegin "thing"
ReverseOrientation
Shape "trianglemesh" "point P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
Translate 0 0 1
Shape "disk" "float innerradius" [0.5]
ActiveTransform EndTime
Translate 0.5 0 0
ActiveTransform All
Shape "trianglemesh" "point P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
ObjectEnd
AttributeBegin
Translate 1 0 0
Rotate 30 0 0 1
ObjectInstance "thing"
AttributeEnd
Scale -1 1 1
ObjectInstance "thing"
ObjectInstance "nothing"
CoordSysTransform "camera"
Translate 0 0 -3
Shape "cylinder"
CoordSysTransform "world"
CoordSysTransform "nowhere"
Shape "cone"
Shape "paraboloid"
Shape "sphere" "float zmin" [-0.5]
ActiveTransform EndTime
Translate 0 1 0
ActiveTransform All
Shape "cylinder" "float radius" [0.3]
Shape "trianglemesh" "point P" [0 0 2 1 0 2 0 1 2] "integer indices" [0 1 2]
WorldEnd
"""
    jj = JAPI().parse_string(text)
    tj = TAPI("cpu").parse_string(text)
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    "cpu"))
    assert jj.instance_names == tj.instance_names
    assert tj.scene.has_animated_quads and tj.scene.has_animated_mesh
    assert tj.scene.n_quadrics == 2 + 5


def test_unknown_directive_and_shape_warn_and_skip(caplog):
    """A directive and a shape kind neither package knows: a warning,
    and the scene pbrt_tpu parses (the unknown shape still takes its
    instance id and its area light, as there)."""
    text = """Film "image" "integer xresolution" [8] "integer yresolution" [8]
MakeSomething "x" "float a" [1]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "rgb L" [1 1 1]
Shape "teapot" "float size" [2]
AttributeEnd
Shape "sphere"
WorldEnd
"""
    with caplog.at_level(logging.WARNING):
        tj = TAPI("cpu").parse_string(text)
    jj = JAPI().parse_string(text)
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "MakeSomething" in msgs and "teapot" in msgs
    assert_scene_equal(tj.scene, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                    "cpu"))
    assert jj.instance_names == tj.instance_names == {1: "teapot_1",
                                                      2: "sphere_2"}
    assert tj.scene.n_lights == 1


def test_cli_writes_instance_names(small_scene, tmp_path):
    """_mesh.txt carries the instance ids (a blob per ObjectInstance),
    byte for byte pbrt_tpu's; --cropwindow is accepted and not used, as
    by pbrt_tpu's CLI (Queue 3 (t))."""
    jj, _ = _jobs(small_scene)
    out_t = str(tmp_path / "t.exr")
    assert tcli.main([small_scene, "--cpu", "--quiet", "--spp", "1",
                      "--maxdepth", "1", "--cropwindow", "0", "0.5", "0",
                      "0.5", "-o", out_t]) == 0
    jcli.write_outputs(jj, jfilm.make_film(16, 16), str(tmp_path / "j.exr"),
                       quiet=True)
    mesh_t = open(str(tmp_path / "t_mesh.txt")).read()
    assert mesh_t == open(str(tmp_path / "j_mesh.txt")).read()
    assert mesh_t.count(" blob\n") == 2
    lum = tio.read_dat(str(tmp_path / "t.dat"))[0].sum(-1)
    assert lum[8:].max() > 0 and lum[:, 8:].max() > 0   # nothing cropped


# ---------------------------------------------------------------------------
# renders against pbrt_tpu's
# ---------------------------------------------------------------------------

def _crop_clamp_rr(text):
    return (text.replace('"integer yresolution" [16]',
                         '"integer yresolution" [16] "float cropwindow" '
                         '[0.2 0.75 0.1 0.6] "float maxsampleluminance" '
                         '[0.5]')
            .replace('"integer maxdepth" [5]',
                     '"integer maxdepth" [5] "float rrthreshold" [0.25]'))


def _metadata_mesh(text):
    return text.replace('Integrator "path" "integer maxdepth" [5]',
                        'Integrator "metadata" "string strategy" "mesh"')


@pytest.mark.parametrize("edit", [None, _crop_clamp_rr, _metadata_mesh],
                         ids=["path", "crop-clamp-rrthreshold",
                              "metadata-mesh"])
def test_shapes_scene_renders_like_jax(small_scene, edit, caplog):
    jj, tj = _jobs(small_scene, edit)
    with caplog.at_level(logging.WARNING):
        tf, _ = tcli.run_job(tj, spp=SPP, max_depth=DEPTH)
    ti = tfilm.develop_spectral(tf).numpy()
    ji = jax_render(jj, SPP, DEPTH)
    if edit is _metadata_mesh:
        assert (ti == ti[..., :1]).all()
        ids = np.rint(ti[..., 0])
        assert (ids == np.rint(ji[..., 0])).mean() >= 0.99
        # both blob instances and the walls show (the heightfield hides
        # the floor, shape 1)
        assert {2, 3, 4, 5, 8, 9} <= set(ids.ravel().tolist())
        return
    assert_renders_alike(ti, ji)
    if edit is _crop_clamp_rr:
        # (s): rrthreshold is read and not used, as in pbrt_tpu
        assert "rrthreshold 0.25 is ignored" in caplog.text
        lum = ti.sum(-1)
        inside = np.zeros((16, 16), bool)
        inside[2:10, 4:12] = True           # rows ceil(1.6)..ceil(9.6)
        assert (lum[~inside] == 0).all() and (lum[inside] > 0).mean() > 0.9


def test_crop_and_clamp_against_the_full_render(small_scene):
    """The crop's pixels are the full render's (a box filter of radius
    0.5: each sample stays in its pixel); the clamp lowers the brightest
    samples only; rrthreshold changes nothing."""
    _, full = _jobs(small_scene)
    _, crop = _jobs(small_scene, lambda t: t.replace(
        '"integer yresolution" [16]',
        '"integer yresolution" [16] "float cropwindow" [0.2 0.75 0.1 0.6]'))
    _, clamp = _jobs(small_scene, lambda t: t.replace(
        '"integer yresolution" [16]',
        '"integer yresolution" [16] "float maxsampleluminance" [0.5]'))
    _, rr = _jobs(small_scene, lambda t: t.replace(
        '"integer maxdepth" [5]',
        '"integer maxdepth" [5] "float rrthreshold" [0.25]'))
    img = {k: tfilm.develop_spectral(tcli.run_job(j, spp=SPP,
                                                  max_depth=DEPTH)[0])
           for k, j in (("full", full), ("crop", crop), ("clamp", clamp),
                        ("rr", rr))}
    assert torch.equal(img["rr"], img["full"])
    c, f = img["crop"][2:10, 4:12], img["full"][2:10, 4:12]
    assert torch.allclose(c, f, rtol=1e-5, atol=1e-7)
    lum_f, lum_c = img["full"].sum(-1), img["clamp"].sum(-1)
    assert (lum_c <= lum_f * (1 + 1e-6)).all() and (lum_c < lum_f).any()


def test_disk_area_light_gets_no_light_geometry_as_in_jax():
    """(u): an AreaLightSource on a quadric other than a sphere gets no
    light geometry (light_quad -1, area 0): NEE never reaches it, and
    the disk is bright only where a camera ray hits it directly; the
    port renders what pbrt_tpu does."""
    text = """LookAt 0 -3 2  0 0 0.3  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "sobol" "integer pixelsamples" [2]
WorldBegin
Material "matte" "rgb Kd" [.7 .7 .7]
Shape "trianglemesh" "point P" [-3 -3 0 3 -3 0 3 3 0 -3 3 0]
    "integer indices" [0 1 2 2 3 0]
AttributeBegin
Translate 0 0 1
Rotate 180 1 0 0
AreaLightSource "diffuse" "rgb L" [4 4 4]
Shape "disk" "float radius" [0.5] "float innerradius" [0.2]
AttributeEnd
WorldEnd
"""
    jj, tj = JAPI().parse_string(text), TAPI("cpu").parse_string(text)
    s = tj.scene
    assert s.light_quad.tolist() == [-1] and s.light_area.tolist() == [0.0]
    tf, _ = tcli.run_job(tj, spp=SPP, max_depth=DEPTH)
    ti = tfilm.develop_spectral(tf).numpy()
    assert_renders_alike(ti, jax_render(jj, SPP, DEPTH))


def test_full_cell_reaches_k1s_bitonic_sort():
    """The shapes cell at its defaults: 162,962 triangles in 319 chunks of
    512, and kernel_workloads.bitonic_batch gives tiles of more hit
    chunks than K1 orders by counting (the plain lists here; the kernel's
    on the card, test_torch_cuda_kernels.py); QUEUE_RANK_MAX mirrors the
    kernel's kRankMax."""
    import re
    from pbrt_tpu_torch.ops import dense_intersect as dense
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    src = open(os.path.join(os.path.dirname(dense.__file__), "..", "csrc",
                            "dense_queue.cu")).read()
    assert re.search(r"constexpr int kRankMax = (\d+);", src).group(1) == \
        str(dense.QUEUE_RANK_MAX)
    with tempfile.TemporaryDirectory() as d:
        sc = parse_scene(shapes_scene.write_shapes_scene(d), "cpu").scene
    assert int((sc.prim_type == tir.PRIM_TRIANGLE).sum()) == 162962
    assert sc.dense_chunk == 512 and sc.dense_w.shape[0] == 319
    r16, tmax, _ = kw.bitonic_batch(sc)
    _, na = dense.tile_chunk_lists_plain(r16, tmax, sc.dense_cb)
    assert (na > dense.QUEUE_RANK_MAX).sum() > 0
