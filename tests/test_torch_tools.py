"""The port's tools against pbrt_tpu's (CPU): the stats report, the CLI's
--cat / --toply and its stats and checkpoint flags, imgtool, obj2pbrt,
cyhair2pbrt and bsdftest.

Tolerances: the host tools are the same numpy on the same inputs, so
their files and their standard output are held equal (paths aside; a
PNG's pixels, which each package encodes its own way);
the spilled .ply files read back equal; bsdftest's printed albedo,
valid and transmitted fractions within 1e-4 of pbrt_tpu's (both print
4 decimals of the same RandomState(0) samples) and the same status.
"""
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image

from pbrt_tpu.film import io as jio
from pbrt_tpu.shapes.ply import read_ply as jread_ply
from pbrt_tpu.tools import bsdftest as jbsdf
from pbrt_tpu.tools import cyhair2pbrt as jhair
from pbrt_tpu.tools import imgtool as jimg
from pbrt_tpu.tools import obj2pbrt as jobj
from pbrt_tpu.tools import pbrt as jcli
from pbrt_tpu.utils import stats as jstats
from pbrt_tpu_torch.film import io as tio
from pbrt_tpu_torch.shapes.ply import read_ply as tread_ply
from pbrt_tpu_torch.tools import bsdftest as tbsdf
from pbrt_tpu_torch.tools import cyhair2pbrt as thair
from pbrt_tpu_torch.tools import imgtool as timg
from pbrt_tpu_torch.tools import obj2pbrt as tobj
from pbrt_tpu_torch.tools import pbrt as tcli
from pbrt_tpu_torch.utils import stats as tstats
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import small_film

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "scenes", "cornell_bench.pbrt")


def both(capsys, jfn, tfn):
    """Run pbrt_tpu's and the port's version; returns their (return
    value, stdout) pairs."""
    jr = jfn()
    jout = capsys.readouterr().out
    tr = tfn()
    tout = capsys.readouterr().out
    return (jr, jout), (tr, tout)


def fill(s, module):
    module.count_scene(s, 6062, 1, 37)
    s.add("Integrator/Camera rays traced", 131072)
    s.add("Intersections/Regular ray intersection tests", 412345)
    s.add("Intersections/Shadow ray intersection tests", 298765)
    s.add("Integrator/Path vertices shaded", 401234)
    s.ratios["Integrator/Path length"] = (401234.0, 131072.0)
    s.times.update({"Rendering": 12.3456, "Parsing + scene compile": 0.789,
                    "Film output": 0.0123})


def test_stats_report_is_text_identical():
    jl, tl = [], []
    j, t = jstats.Stats(), tstats.Stats()
    fill(j, jstats)
    fill(t, tstats)
    j.report(out=jl.append)
    t.report(out=tl.append)
    assert tl == jl and any("131,072" in line for line in tl)
    with t.phase("Extra"):
        pass
    assert t.times["Extra"] >= 0.0


@pytest.mark.parametrize("toply", [False, True], ids=["cat", "toply"])
@pytest.mark.parametrize("scene", ["bench", "include"])
def test_cat_and_toply_equal_jax(tmp_path, toply, scene):
    if scene == "bench":
        path = BENCH
    else:
        # tests/test_tools.py's scene: an Include inside an attribute
        (tmp_path / "inc.pbrt").write_text(
            'Shape "trianglemesh" "integer indices" [0 1 2]\n'
            '  "point P" [0 0 0  1 0 0  0 1 0] "float uv" [0 0 1 0 0 1]\n')
        path = str(tmp_path / "s.pbrt")
        with open(path, "w") as f:
            f.write('Film "image" "integer xresolution" [4]\n'
                    'WorldBegin\nAttributeBegin\n'
                    'Material "matte" "color Kd" [.5 .5 .5]\n'
                    'Include "inc.pbrt"\nAttributeEnd\nWorldEnd\n')
    flag = ["--toply"] if toply else ["--cat"]
    outs = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        d = tmp_path / name
        d.mkdir()
        out = str(d / "cat.pbrt")
        assert cli.main([path] + flag + ["--outfile", out]) == 0
        outs[name] = (open(out).read(), sorted(p for p in os.listdir(d)
                                               if p.endswith(".ply")))
    assert outs["t"] == outs["j"]
    text, plys = outs["t"]
    assert "Include" not in text and ("plymesh" in text) == toply
    assert len(plys) == (text.count("plymesh") if toply else 0)
    for p in plys:
        for a, b in zip(tread_ply(str(tmp_path / "t" / p)),
                        jread_ply(str(tmp_path / "j" / p))):
            assert (a is None and b is None) or np.array_equal(a, b), p


def test_cat_to_stdout_equals_jax(capsys):
    (jr, jout), (tr, tout) = both(capsys, lambda: jcli.main([BENCH, "--cat"]),
                                  lambda: tcli.main([BENCH, "--cat"]))
    assert jr == tr == 0 and tout == jout and "WorldBegin" in tout


def test_cli_stats_and_checkpoint(tmp_path, capsys):
    """The CLI's checkpoint and stats report on the CPU (16x16, 1 spp):
    the camera rays counted, the report printed; a second run with the
    same checkpoint renders nothing and writes the same outputs."""
    scene = small_film(BENCH, tmp_path)
    cp = str(tmp_path / "film.ckpt")
    outs = []
    for i in range(2):
        out = str(tmp_path / f"out{i}.exr")
        assert tcli.main([scene, "--cpu", "--spp", "1", "--maxdepth", "2",
                          "--nthreads", "4", "--checkpoint", cp,
                          "--checkpoint-interval", "0", "-o", out]) == 0
        outs.append((out, capsys.readouterr().out))
    text = outs[0][1]
    assert re.search(r"Camera rays traced\s+256\b", text), text
    for name in ("Statistics:", "Regular ray intersection tests",
                 "Shadow ray intersection tests", "Path length",
                 "Profile (wall clock)", "Rendering", "Scene"):
        assert name in text, name
    assert "[1/1 passes" in text
    assert "Camera rays traced" not in outs[1][1]
    assert open(outs[0][0], "rb").read() == open(outs[1][0], "rb").read()
    assert open(outs[0][0][:-4] + ".dat", "rb").read() == open(
        outs[1][0][:-4] + ".dat", "rb").read()


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    d = tmp_path_factory.mktemp("img")
    rs = np.random.RandomState(0)
    img = rs.rand(16, 12, 3).astype(np.float32) * 2
    img[3, 4] = 40.0                          # a spike
    a, b = str(d / "a.exr"), str(d / "b.exr")
    jio.write_exr(a, img)
    jio.write_exr(b, img * 1.2)
    return a, b


@pytest.mark.parametrize("args", [
    ["--tonemap"], ["--scale", "2", "--flipy", "--repeatpix", "2"],
    ["--despike", "1.5", "--preservecolors"], ["--bloomlevel", "0.5",
                                               "--bloomwidth", "3"]],
    ids=["tonemap", "scale-flip-repeat", "despike-preserve", "bloom"])
@pytest.mark.parametrize("ext", [".exr", ".png"])
def test_imgtool_convert_equals_jax(image, tmp_path, capsys, args, ext):
    a, _ = image
    jo, to = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    (jr, jout), (tr, tout) = both(
        capsys, lambda: jimg.main(["convert", a, jo] + args),
        lambda: timg.main(["convert", a, to] + args))
    assert jr == tr == 0 and tout.replace(to, jo) == jout
    if ext == ".png":
        # pbrt_tpu encodes through PIL, the port by its own zlib writer:
        # the same 8-bit pixels in other bytes
        assert np.array_equal(np.asarray(Image.open(to)),
                              np.asarray(Image.open(jo)))
    else:
        assert open(to, "rb").read() == open(jo, "rb").read()


@pytest.mark.parametrize("cmd", ["info", "cat", "diff", "diff-tol",
                                 "diff-same", "assemble"])
def test_imgtool_reports_equal_jax(image, tmp_path, capsys, cmd):
    a, b = image
    jo, to = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    args = {"info": ["info", a], "cat": ["cat", a],
            "diff": ["diff", a, b, "--outfile", "{o}"],
            "diff-tol": ["diff", a, b, "--difftol", "50"],
            "diff-same": ["diff", a, a],
            "assemble": ["assemble", "{o}", a, b]}[cmd]
    (jr, jout), (tr, tout) = both(
        capsys, lambda: jimg.main([x.format(o=jo) for x in args]),
        lambda: timg.main([x.format(o=to) for x in args]))
    assert tr == jr and tout.replace(to, jo) == jout
    assert jr == (1 if cmd == "diff" else 0)
    if "{o}" in args:
        assert open(to, "rb").read() == open(jo, "rb").read()


def test_imgtool_makesky_equals_jax(tmp_path, capsys):
    jo, to = str(tmp_path / "j.pfm"), str(tmp_path / "t.pfm")
    args = ["--resolution", "16", "--elevation", "40", "--turbidity", "4"]
    (jr, jout), (tr, tout) = both(
        capsys, lambda: jimg.main(["makesky", jo] + args),
        lambda: timg.main(["makesky", to] + args))
    assert jr == tr == 0 and tout.replace(to, jo) == jout
    assert open(to, "rb").read() == open(jo, "rb").read()
    assert tio.read_pfm(to).shape == (16, 32, 3)


def test_obj2pbrt_equals_jax(tmp_path, capsys):
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\n"
        "newmtl shiny\nKd 0.2 0.2 0.2\nKs 0.5 0.5 0.5\nNs 40\n"
        "newmtl lamp\nKe 4 4 4\n"
        "newmtl wood\nmap_Kd wood.png\n")
    obj = tmp_path / "m.obj"
    obj.write_text("mtllib m.mtl\n# a comment\n"
                   "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
                   "vn 0 0 1\nvn 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
                   "f 1 2 3\nusemtl red\nf 1/1/1 2/2/1 3/3/1 4/1/2\n"
                   "usemtl shiny\nf -5//1 -4//1 -1//2\n"
                   "usemtl lamp\nf 2/2 3/3 5/1\nusemtl wood\nf 3 4 5\n")
    jo, to = str(tmp_path / "j.pbrt"), str(tmp_path / "t.pbrt")
    (jr, jout), (tr, tout) = both(capsys, lambda: jobj.main([str(obj), jo]),
                                  lambda: tobj.main([str(obj), to]))
    assert jr == tr == 0 and tout.replace(to, jo) == jout
    assert open(to).read() == open(jo).read()


@pytest.mark.parametrize("flags", [2, 2 | 1 | 4 | 8 | 16],
                         ids=["points", "every-array"])
def test_cyhair2pbrt_equals_jax(tmp_path, capsys, flags):
    n_strands, segs = 3, np.array([2, 5, 3], "<u2")
    n_points = int((segs + 1).sum())
    rs = np.random.RandomState(3)
    data = b"HAIR" + struct.pack("<III", n_strands, n_points, flags)
    data += struct.pack("<If", 3, 0.1) + struct.pack("<f", 0.0)
    data += struct.pack("<fff", 0.8, 0.7, 0.6) + b"\x00" * 88
    if flags & 1:
        data += segs.tobytes()
    data += rs.rand(n_points * 3).astype("<f4").tobytes()
    for bit, n in ((4, 1), (8, 1), (16, 3)):
        if flags & bit:
            data += rs.rand(n_points * n).astype("<f4").tobytes()
    hair = tmp_path / "h.hair"
    hair.write_bytes(data)
    jo, to = str(tmp_path / "j.pbrt"), str(tmp_path / "t.pbrt")
    (jr, jout), (tr, tout) = both(
        capsys, lambda: jhair.main([str(hair), jo, "--maxstrands", "2"]),
        lambda: thair.main([str(hair), to, "--maxstrands", "2"]))
    assert jr == tr == 0 and tout.replace(to, jo) == jout
    assert open(to).read() == open(jo).read()
    assert 'Shape "curve"' in open(to).read()


def _numbers(text):
    get = (lambda name: float(re.search(name + r"\s*:\s*([-\d.e+]+)",
                                        text).group(1)))
    return (get("valid sample fraction"), get("hemispherical albedo"),
            get("transmitted fraction"), "PASS" in text)


@pytest.mark.parametrize("material", sorted(tbsdf.MATERIALS))
def test_bsdftest_matches_jax(capsys, material):
    args = ["--material", material, "--samples", "20000", "--cpu"]
    (jr, jout), (tr, tout) = both(capsys, lambda: jbsdf.main(args),
                                  lambda: tbsdf.main(args))
    assert tr == jr == 0
    jn, tn = _numbers(jout), _numbers(tout)
    assert tn[3] and jn[3]
    np.testing.assert_allclose(tn[:3], jn[:3], rtol=0, atol=1e-4)
