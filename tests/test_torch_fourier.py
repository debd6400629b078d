"""The port's fourier BSDF (materials/fourier.py, its bsdf branches, the
parser's Material "fourier" and renders) against pbrt_tpu's on the CPU.

Tables: tests/test_fourier.py's DC-only Lambertian table, and the skin
scene's (tools/skin_scene.py fourier_table): 3 channels, 5 Fourier
orders, so that the phi marginal is not flat.

Tolerances:
- the file reader and writer, bake_grid and bake_cr_tables are the same
  numpy code: bit for bit;
- eval_grid (a trilinear lookup) within 1e-5 relative of the batch's
  largest value;
- sample_grid_cr inverts the Catmull-Rom interpolant by 12 Newton
  steps, each dividing by the interpolant's value: sampled directions
  within 1e-4 on >= 99.9% of the lanes (a lane whose Newton iterate
  lands on a bisection boundary may take the other side), and each
  package's pdf_grid_cr at the other's direction within 1e-4 relative
  (a floor of 1e-6 of the batch's largest).  Measured: eval within
  2.6e-7 of the largest, pdf_grid_cr 1.3e-5, directions within 5.6e-6
  but on one lane of 4,096 of the 5-order table (5.5e-3), each pdf at
  the other's sample 1.6e-5;
- renders: test_torch_volpath.assert_renders_alike.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.materials import fourier as jfour
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.materials import fourier as tfour
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from pbrt_tpu_torch.tools import skin_scene
from test_torch_bssrdf import render_pair
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import assert_scene_equal, jax_arrays
from test_torch_volpath import assert_renders_alike

B = 4096
RHO = 0.6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fourier")
    mu = np.linspace(-1.0, 1.0, 24)
    coeffs = [[np.array([RHO / np.pi * abs(mi)], np.float32)
               if mi * mo < 0 else np.zeros(1, np.float32)
               for mo in mu] for mi in mu]
    lam = str(d / "lambert.bsdf")
    tfour.write_bsdf(lam, mu, coeffs, n_channels=1, eta=1.0)
    lobe = str(d / "lobe.bsdf")
    tfour.write_bsdf(lobe, *skin_scene.fourier_table(), n_channels=3,
                     eta=1.5)
    return dict(lambert=lam, lobe=lobe)


@pytest.fixture(scope="module")
def baked(files):
    """{name: (grid, a0, lum)} of both tables, baked by the port."""
    out = {}
    for k, path in files.items():
        g = tfour.bake_grid(tfour.read_bsdf(path))
        out[k] = (g,) + tfour.bake_cr_tables(g)
    return out


@pytest.mark.parametrize("name", ["lambert", "lobe"])
def test_reader_and_bakes_bit_for_bit(files, baked, name):
    a, b = tfour.read_bsdf(files[name]), jfour.read_bsdf(files[name])
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    g = jfour.bake_grid(b)
    assert np.array_equal(baked[name][0], g)
    for x, y in zip(baked[name][1:], jfour.bake_cr_tables(g)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the writer: pbrt_tpu's file of the same table is the same bytes
    if name == "lambert":
        return
    p2 = files[name] + ".jax"
    jfour.write_bsdf(p2, *skin_scene.fourier_table(), n_channels=3, eta=1.5)
    assert open(p2, "rb").read() == open(files[name], "rb").read()


def _dirs(rs, n, hemi=None):
    v = rs.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if hemi is not None:
        v[:, 2] = hemi * np.abs(v[:, 2])
    return v.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(b) + 1e-6 * np.abs(b).max())


@pytest.mark.parametrize("name", ["lambert", "lobe"])
def test_device_lookups_match_jax(baked, name, monkeypatch):
    for f in ("eval_grid", "sample_grid_cr", "pdf_grid_cr"):
        monkeypatch.setattr(jfour, f, jax.jit(getattr(jfour, f)))
    grid, a0, lum = baked[name]
    rs = np.random.RandomState(4)
    wo, wi = _dirs(rs, B), _dirs(rs, B)
    u = rs.uniform(0, 1, (3, B)).astype(np.float32)
    T = {k: torch.from_numpy(v) for k, v in
         dict(grid=grid, a0=a0, lum=lum, wo=wo, wi=wi).items()}
    J = {k: jnp.asarray(v) for k, v in
         dict(grid=grid, a0=a0, lum=lum, wo=wo, wi=wi).items()}
    e_t = tfour.eval_grid(T["grid"], T["wo"], T["wi"]).numpy()
    e_j = np.asarray(jfour.eval_grid(J["grid"], J["wo"], J["wi"]))
    assert np.abs(e_t - e_j).max() <= 1e-5 * np.abs(e_j).max()
    assert _rel(tfour.pdf_grid_cr(T["a0"], T["lum"], T["wo"], T["wi"]),
                jfour.pdf_grid_cr(J["a0"], J["lum"], J["wo"], J["wi"])
                ).max() <= 1e-4
    ut = [torch.from_numpy(x) for x in u]
    uj = [jnp.asarray(x) for x in u]
    s_t = tfour.sample_grid_cr(T["a0"], T["lum"], T["wo"], *ut).numpy()
    s_j = np.array(jfour.sample_grid_cr(J["a0"], J["lum"], J["wo"], *uj))
    close = np.abs(s_t - s_j).max(-1) <= 1e-4
    assert close.mean() >= 0.999, close.mean()
    # each package's density at the other's sample
    assert _rel(tfour.pdf_grid_cr(T["a0"], T["lum"], T["wo"],
                                  torch.from_numpy(s_j)),
                jfour.pdf_grid_cr(J["a0"], J["lum"], J["wo"],
                                  jnp.asarray(s_j))).max() <= 1e-4


def _params(lib, baked, n, eta):
    """A MaterialParams of n fourier lanes over both lattices."""
    grids = np.stack([baked["lambert"][0], baked["lobe"][0]])
    a0 = np.stack([baked["lambert"][1], baked["lobe"][1]])
    lum = np.stack([baked["lambert"][2], baked["lobe"][2]])
    fid = (np.arange(n) % 2).astype(np.int32)
    z = np.zeros((n, 31), np.float32)
    if lib == "torch":
        t = torch.from_numpy
        return tbsdf.MaterialParams(
            type=torch.full((n,), tir.MAT_FOURIER), kd=t(z), ks=t(z),
            kr=t(z), kt=t(z), rough_u=torch.zeros(n), rough_v=torch.zeros(n),
            eta=torch.full((n,), eta), sigma=torch.zeros(n),
            fourier_grid=t(grids), fourier_id=t(fid), fourier_a0=t(a0),
            fourier_lum=t(lum), families=(tir.MAT_FOURIER,))
    j = jnp.asarray
    return jbsdf.MaterialParams(
        type=jnp.full(n, tir.MAT_FOURIER, jnp.int32), kd=j(z), ks=j(z),
        kr=j(z), kt=j(z), rough_u=jnp.zeros(n), rough_v=jnp.zeros(n),
        eta=jnp.full(n, eta), eta_spec=j(z) + 1.0, k_spec=j(z),
        sigma=jnp.zeros(n), opacity=j(z) + 1.0, fourier_grid=j(grids),
        fourier_id=j(fid), fourier_a0=j(a0), fourier_lum=j(lum),
        families=(tir.MAT_FOURIER,))


def test_bsdf_dispatch_matches_jax(baked, monkeypatch):
    """eval_f, pdf_f and sample_f on fourier lanes of two lattices (one
    unrolled lookup a lattice): the same values, and the sampled lanes'
    transmitted flags."""
    n = 1024
    for name in ("eval_f", "pdf_f", "sample_f"):
        monkeypatch.setattr(jbsdf, name, jax.jit(getattr(jbsdf, name)))
    rs = np.random.RandomState(9)
    wo, wi = _dirs(rs, n, hemi=1), _dirs(rs, n)
    us = rs.uniform(0, 1, (3, n)).astype(np.float32)
    tp, jp = _params("torch", baked, n, 1.5), _params("jax", baked, n, 1.5)
    f_t = tbsdf.eval_f(tp, torch.from_numpy(wo), torch.from_numpy(wi))
    f_j = jbsdf.eval_f(jp, jnp.asarray(wo), jnp.asarray(wi))
    assert np.abs(f_t.numpy() - np.asarray(f_j)).max() <= \
        1e-5 * np.abs(np.asarray(f_j)).max()
    assert _rel(tbsdf.pdf_f(tp, torch.from_numpy(wo), torch.from_numpy(wi)),
                jbsdf.pdf_f(jp, jnp.asarray(wo), jnp.asarray(wi))).max() \
        <= 1e-4
    st = tbsdf.sample_f(tp, torch.from_numpy(wo),
                        *(torch.from_numpy(u) for u in us))
    sj = jbsdf.sample_f(jp, jnp.asarray(wo), *(jnp.asarray(u) for u in us))
    close = np.abs(st[0].numpy() - np.asarray(sj[0])).max(-1) <= 1e-4
    assert close.mean() >= 0.999
    assert np.array_equal(st[4].numpy()[close], np.asarray(sj[4])[close])
    assert _rel(st[2].numpy()[close], np.asarray(sj[2])[close]).max() <= 1e-4


SPHERE = """
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [%d] "integer yresolution" [%d]
Sampler "sobol" "integer pixelsamples" [%d]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
AreaLightSource "area" "color L" [10 10 10]
Shape "trianglemesh" "point P" [-3 3 -3  3 3 -3  3 3 3  -3 3 3]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
%s
Shape "sphere" "float radius" [1]
WorldEnd
"""


def test_parsed_scene_equals_scene_from_jax(files, caplog):
    src = (SPHERE % (8, 8, 1, 'Material "fourier" "string bsdffile" "%s"\n'
                     'Shape "sphere" "float radius" [.5]\n'
                     'Material "fourier" "string bsdffile" "%s"'
                     % (files["lambert"], files["lobe"])))
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    ts = tj.scene
    assert ts.has_fourier and ts.fourier_grid.shape == (2, 64, 64, 64, 3)
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(jj.scene), "cpu"))
    # a file that cannot be read: matte, with pbrt_tpu's warning
    bad = SPHERE % (8, 8, 1, 'Material "fourier" "string bsdffile" '
                    '"missing.bsdf"')
    js = JAPI().parse_string(bad).scene
    with caplog.at_level("WARNING"):
        ts = TAPI("cpu").parse_string(bad).scene
    assert "unusable" in caplog.text and not ts.has_fourier
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), "cpu"))


@pytest.mark.parametrize("name", ["lambert", "lobe"])
def test_fourier_sphere_renders_like_jax(files, name):
    """tests/test_fourier.py's sphere under an area light at 12x12, 2 spp,
    with each table."""
    src = SPHERE % (12, 12, 2, 'Material "fourier" "string bsdffile" "%s"'
                    % files[name])
    assert_renders_alike(*render_pair(src))


def test_lambert_table_renders_like_matte(files):
    """tests/test_fourier.py::test_fourier_scene_matches_matte on the port
    alone, at its size but 16 spp (its 48): the Lambertian table against
    matte Kd 0.6, centre means within 15%."""
    out = {}
    for name, mat in (("fourier", 'Material "fourier" "string bsdffile" '
                       '"%s"' % files["lambert"]),
                      ("matte", 'Material "matte" "color Kd" [0.6 0.6 0.6]')):
        job = TAPI("cpu").parse_string(SPHERE % (24, 24, 16, mat))
        film, _ = tcli.run_job(job)
        out[name] = tfilm.develop_rgb(film).numpy()
    a, b = out["fourier"][8:16, 8:16].mean(), out["matte"][8:16, 8:16].mean()
    assert abs(a - b) < 0.15 * b, (a, b)
    assert os.path.exists(files["lambert"])
