"""The port's subsurface scattering against pbrt_tpu's on the CPU: the
beam-diffusion tables, the device profile queries, the probe event
(integrators/path.py _sss_event), the parser's subsurface and
kdsubsurface, and renders through the path, volpath and whitted
integrators.

Tolerances:
- the numpy tables and host queries are the same numpy code: bit for
  bit;
- the device queries (sr_eval / sr_sample / sr_pdf_device) run the same
  f32 operations: within 1e-5 relative (measured: equal on 98.5%, 100%
  and 98.9% of the lanes);
- _sss_event fed the same hits, materials and samples: every lane's
  material type equal, and where both packages' probes picked the same
  exit triangle (all but ties of the two intersectors, >= 99% of the
  relocated lanes) the exit point within 1e-4, its shading normal within
  1e-4 and beta within 1e-4 relative (measured: the same triangle on
  every relocated lane, the point within 6e-8, the normal equal, beta
  within 4.6e-7);
- renders (12x12, 2 spp) run the same counter-based samples and paths:
  test_torch_volpath.assert_renders_alike (mean within 1e-4 relative,
  >= 97% of pixels within 1e-3, >= 99% within 1e-2; measured on these
  and the hair, fourier and ptex files' renders: means within 2.7e-6,
  every pixel within 2.0e-4).

pbrt_tpu's renders run unfused with their pieces jitted one by one
(`jax_render_all`: test_torch_volpath.jax_render plus the probe's table
queries, make_hit and the Fresnel and GGX helpers it calls eagerly).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.materials import bssrdf as jb
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.materials import bsdf as tbsdf
from pbrt_tpu_torch.materials import bssrdf as tb
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers import samplers as tsamp
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import assert_scene_equal, jax_arrays
from test_torch_volpath import assert_renders_alike, jax_render

RES, SPP, DEPTH = 12, 2, 3
NS = 31
# pbrt_tpu's probe event in one compile (its ~hundreds of eager operations
# compile one by one otherwise)
_jax_sss_event = jax.jit(jpath._sss_event, static_argnums=(9, 10, 11, 14))


def jax_render_all(jj, spp, depth):
    """pbrt_tpu's render of job jj (test_torch_volpath.jax_render) with
    the helpers its probe event, hair frame and fourier lookups call
    outside the jitted pieces jitted as well."""
    from pbrt_tpu.materials import fourier as jfour
    from pbrt_tpu.materials import hair as jhair
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sr_sample_device", "sr_eval_device", "sr_pdf_device"):
            mp.setattr(jb, name, jax.jit(getattr(jb, name)))
        mp.setattr(jisect, "make_hit", jax.jit(
            jisect.make_hit, static_argnames=("exact_p",)))
        for name in ("ggx_sample_wh", "fresnel_dielectric",
                     "hair_shading_frame"):
            mp.setattr(jbsdf, name, jax.jit(getattr(jbsdf, name)))
        for name in ("hair_eval", "hair_pdf", "hair_sample"):
            mp.setattr(jhair, name, jax.jit(getattr(jhair, name)))
        for name in ("eval_grid", "sample_grid_cr", "pdf_grid_cr"):
            mp.setattr(jfour, name, jax.jit(getattr(jfour, name)))
        return jax_render(jj, spp, depth)


def render_pair(src, spp=SPP, depth=DEPTH, res=RES):
    """(port image, pbrt_tpu image) [H,W,31] of one scene text."""
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    for j in (jj, tj):
        j.film_width = j.film_height = res
    tf, _ = tcli.run_job(tj, spp=spp, max_depth=depth)
    return (tfilm.develop_spectral(tf).numpy(),
            jax_render_all(jj, spp, depth))


# ---------------------------------------------------------------------------
# the numpy tables: the same code, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.3, 1.5), (-0.2, 1.2)])
def test_profile_tables_bit_for_bit(g, eta):
    a = tb.compute_beam_diffusion_bssrdf(g, eta)
    b = jb.compute_beam_diffusion_bssrdf(g, eta)
    for k in ("rho", "radius", "profile", "cdf", "rho_eff"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_host_queries_bit_for_bit():
    rs = np.random.RandomState(0)
    eta = rs.uniform(0.6, 2.0, 64)
    for f in ("fresnel_moment1", "fresnel_moment2"):
        assert np.array_equal(getattr(tb, f)(eta), getattr(jb, f)(eta)), f
    t = tb.compute_beam_diffusion_bssrdf(0.0, 1.33, n_rho=32, n_radius=48)
    target = rs.uniform(0.0, 0.9, (8, 3))
    mfp = rs.uniform(0.1, 2.0, (8, 3))
    for x, y in zip(tb.subsurface_from_diffuse(t, target, mfp),
                    jb.subsurface_from_diffuse(t, target, mfp)):
        assert np.array_equal(x, y)
    rho = rs.uniform(0.0, 1.0, 64)
    r = np.exp(rs.uniform(-6.0, 3.0, 64))
    assert np.array_equal(tb.eval_sr(t, rho, r), jb.eval_sr(t, rho, r))
    u = rs.uniform(0.0, 1.0, 64)
    assert np.array_equal(tb.sample_sr(t, rho, u), jb.sample_sr(t, rho, u))


# ---------------------------------------------------------------------------
# the device queries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    """Two stacked tables, as a scene with two (g, eta) holds them."""
    ts = [tb.compute_beam_diffusion_bssrdf(0.0, 1.33),
          tb.compute_beam_diffusion_bssrdf(0.3, 1.5)]
    return dict(profile=np.stack([t["profile"] for t in ts]),
                cdf=np.stack([t["cdf"] for t in ts]),
                rho=ts[0]["rho"].astype(np.float32),
                radius=ts[0]["radius"].astype(np.float32))


def _both(x):
    return torch.from_numpy(np.asarray(x)), jnp.asarray(x)


def _close(a, b, rtol=1e-5, atol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=rtol, atol=atol), \
        np.abs(a - b).max()


def test_device_queries_match_jax(tables, monkeypatch):
    for name in ("sr_eval_device", "sr_sample_device", "sr_pdf_device"):
        monkeypatch.setattr(jb, name, jax.jit(getattr(jb, name)))
    rs = np.random.RandomState(3)
    B = 512
    prof_t, prof_j = _both(tables["profile"])
    cdf_t, cdf_j = _both(tables["cdf"])
    rho_t, rho_j = _both(tables["rho"])
    rad_t, rad_j = _both(tables["radius"])
    tid = rs.randint(0, 2, B).astype(np.int32)
    rho = rs.uniform(0.0, 1.0, (B, NS)).astype(np.float32)
    rho[:8] = tables["rho"][rs.randint(0, 100, 8)][:, None]   # on nodes
    r = np.exp(rs.uniform(-7.0, 4.5, (B, NS))).astype(np.float32)
    u = rs.uniform(0.0, 1.0, B).astype(np.float32)
    tid_t, tid_j = _both(tid)
    _close(tb.sr_eval_device(prof_t, rho_t, rad_t, tid_t[:, None],
                             *(_both(rho)[0], _both(r)[0])),
           jb.sr_eval_device(prof_j, rho_j, rad_j, tid_j[:, None],
                             jnp.asarray(rho), jnp.asarray(r)))
    _close(tb.sr_sample_device(cdf_t, rad_t, rho_t, tid_t,
                               torch.from_numpy(rho[:, 0]),
                               torch.from_numpy(u)),
           jb.sr_sample_device(cdf_j, rad_j, rho_j, tid_j,
                               jnp.asarray(rho[:, 0]), jnp.asarray(u)))
    # the probe's shapes: tid [B,1,1], rho [B,1,31], r [B,3,31]
    r3 = np.exp(rs.uniform(-7.0, 4.5, (B, 3, NS))).astype(np.float32)
    _close(tb.sr_pdf_device(prof_t, cdf_t, rho_t, rad_t,
                            tid_t[:, None, None],
                            torch.from_numpy(rho[:, None, :]),
                            torch.from_numpy(r3)),
           jb.sr_pdf_device(prof_j, cdf_j, rho_j, rad_j,
                            tid_j[:, None, None], jnp.asarray(rho[:, None]),
                            jnp.asarray(r3)))


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

PARSE = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material %s
Shape "sphere" "float radius" [1]
Material "subsurface" "float g" [0.2] "float eta" [1.4]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-4 -1 -4  -4 -1 4  4 -1 4  4 -1 -4]
WorldEnd
"""


@pytest.mark.parametrize("mat", [
    '"subsurface" "string name" "Skin1" "float scale" [30]',
    '"subsurface" "color sigma_a" [.02 .03 .05] "color sigma_s" [8 7 6]',
    '"kdsubsurface" "color Kd" [0.6 0.3 0.1] "float mfp" [0.1] '
    '"float uroughness" [0.1]',
    '"subsurface" "float g" [0.2] "float eta" [1.4] "rgb Kr" [.5 .5 .5]'],
    ids=["preset", "coefficients", "kd-rough", "shared-table"])
def test_parsed_scene_equals_scene_from_jax(mat):
    src = PARSE % mat
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    ts = tj.scene
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(jj.scene), "cpu"))
    assert ts.has_sss and not ts.has_hair
    assert {tir.MAT_SUBSURFACE, tir.MAT_MIRROR, tir.MAT_ROUGHGLASS,
            tir.MAT_SSW} <= set(ts.mat_families)
    # tables shared by (g, eta): the last case's equal the floor's
    n_tables = 1 if '"float eta" [1.4]' in mat else 2
    assert ts.bssrdf_profile.shape == (n_tables, 100, 64)


# ---------------------------------------------------------------------------
# the probe event, fed the same hits
# ---------------------------------------------------------------------------

def _slabs(rough=None, passes_res=16):
    """tests/test_bssrdf.py::_render_slabs's three thin slabs."""
    rough_decl = f'"float uroughness" [{rough}]' if rough else ""
    slabs = "\n".join(
        f'AttributeBegin\nTranslate 0 {0.12 * i} 0\n'
        f'Shape "trianglemesh" "integer indices" [0 1 2 2 3 0'
        f' 4 6 5 4 7 6]\n'
        f'  "point P" [-4 0 -4  -4 0 4  4 0 4  4 0 -4'
        f'  -4 -0.05 -4  -4 -0.05 4  4 -0.05 4  4 -0.05 -4]\n'
        f'AttributeEnd' for i in range(3))
    return f"""
Integrator "path" "integer maxdepth" [5]
Sampler "sobol" "integer pixelsamples" [12]
Film "image" "integer xresolution" [{passes_res}]
     "integer yresolution" [{passes_res}]
LookAt 0 3 0.01  0 0 0  0 0 1
Camera "perspective" "float fov" [35]
WorldBegin
AttributeBegin
  Translate 0 8 0
  LightSource "point" "color I" [100 100 100]
AttributeEnd
Material "subsurface" "color sigma_a" [0.05 0.05 0.05]
         "color sigma_s" [6 6 6] "float eta" [1.33] {rough_decl}
{slabs}
WorldEnd
"""


def _hit_to_torch(jh):
    """pbrt_tpu's Hit as the port's (the same values)."""
    def t(x):
        return torch.from_numpy(np.array(x))
    return tisect.Hit(valid=t(jh.valid), t=t(jh.t), p=t(jh.p), ng=t(jh.ng),
                      ns=t(jh.ns), uv=t(jh.uv), wo=t(jh.wo),
                      prim=t(jh.prim).long(), material=t(jh.material),
                      light=t(jh.light), instance=t(jh.instance),
                      face=t(jh.face))


def _events(src, bounce=0):
    """(port's, pbrt_tpu's) _sss_event outputs on the camera hits of the
    scene's first sample, both fed pbrt_tpu's hits."""
    jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
    js, ts = jj.scene, tj.scene
    W = H = 16
    jcfg = jsamp.SamplerConfig("sobol", 0, 1)
    tcfg = tsamp.SamplerConfig("sobol", 0, 1)
    tcam = tcli.build_camera(tj, W, H, "cpu")
    ids = torch.arange(W * H)
    ray, _, _, pid, sidx = tpath.camera_rays_for_pixels(tcam, W, H, tcfg,
                                                        ids, 0)
    jray = jgeom.Ray.make(jnp.asarray(ray.o.numpy()),
                          jnp.asarray(ray.d.numpy()),
                          tmax=jnp.asarray(ray.tmax.numpy()))
    jh = jisect.intersect_full(js, jray)
    th = _hit_to_torch(jh)
    jpid = jnp.asarray(pid.numpy().astype(np.uint32))
    jsidx = jnp.asarray(sidx.numpy().astype(np.uint32))
    jm = jbsdf.gather_materials(js, jh.material, uv=jh.uv, p=jh.p)
    tm = tbsdf.gather_materials(ts, th.material, uv=th.uv, p=th.p)
    ss, tt = jgeom.coordinate_system(jh.ns)
    B = W * H
    jout = _jax_sss_event(js, jh, jm, jnp.ones((B, NS)), jh.valid, ss, tt,
                          jpid, jsidx, jcfg, jsamp.sample_dim, bounce,
                          jray.wavelength, jnp.zeros(4), True)

    def sdim(dim):
        return tsamp.sample_dim(tcfg, pid, sidx, dim)

    n_rays = torch.zeros(4, dtype=torch.int64)
    tout = tpath._sss_event(ts, th, tm, torch.ones((B, NS)), th.valid,
                            torch.from_numpy(np.array(ss)),
                            torch.from_numpy(np.array(tt)), sdim, bounce,
                            ray.wavelength, n_rays, True)
    return tout, jout


@pytest.mark.parametrize("rough", [None, 0.3], ids=["smooth", "rough"])
def test_sss_event_matches_jax(rough):
    (th, tm, tbeta, talive, tn), (jh, jm, jbeta, jalive, jn) = _events(
        _slabs(rough))
    np_ = np.asarray
    assert np.array_equal(tm.type.numpy(), np_(jm.type))
    assert np.array_equal(talive.numpy(), np_(jalive))
    # the probe lanes the closest-hit count takes: pbrt_tpu counts them
    # as floats
    assert int(tn[0]) == int(np_(jn)[0])
    reloc = tm.type.numpy() == tir.MAT_SSW
    assert reloc.sum() > 50
    same = reloc & (th.prim.numpy() == np_(jh.prim))
    assert same.sum() >= 0.99 * reloc.sum()
    for a, b in ((th.p, jh.p), (th.ns, jh.ns)):
        assert np.abs(a.numpy()[same] - np_(b)[same]).max() <= 1e-4
    _close(tbeta.numpy()[same], np_(jbeta)[same], rtol=1e-4, atol=1e-7)
    if rough:
        assert (tm.type.numpy() == tir.MAT_ROUGHGLASS).any()
    else:
        assert (tm.type.numpy() == tir.MAT_MIRROR).any()


def test_rough_interface_energy_is_f_squared():
    """The rough interface's reflected energy, as pbrt_tpu has it: a lane
    reflects with probability Fr, and its reflection-only rough-glass
    lobe multiplies by F again (pbrt_tpu/integrators/path.py:101-126), so
    at normal incidence the rough interface returns about F times the
    smooth one's Fr, where an unbiased estimator would return about as
    much.  The port reproduces it: both packages' estimates agree, and
    the ratio is below 0.2 (F is 0.02 at eta 1.33)."""
    plane = """
Sampler "sobol"
Film "image" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 0 5  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
WorldBegin
Material "subsurface" "color sigma_a" [.05 .05 .05] "color sigma_s" [6 6 6]
  "float eta" [1.33] %s
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-50 -50 0  50 -50 0  50 50 0  -50 50 0]
WorldEnd
"""
    energy = {}
    for name, decl in (("smooth", ""), ("rough", '"float uroughness" [.1]')):
        src = plane % decl
        jj, tj = JAPI().parse_string(src), TAPI("cpu").parse_string(src)
        W = H = 16      # _events's batch: its eager JAX ops are compiled
        B = W * H
        tcfg = tsamp.SamplerConfig("sobol", 0, 1)
        jcfg = jsamp.SamplerConfig("sobol", 0, 1)
        pid = torch.arange(B)
        sidx = torch.zeros(B, dtype=torch.int64)
        o = torch.zeros(B, 3)
        o[:, 0] = (pid % W).float() / W * 2 - 1
        o[:, 1] = (pid // W).float() / H * 2 - 1
        o[:, 2] = 5.0
        d = torch.tensor([0.0, 0.0, -1.0]).expand(B, 3).contiguous()
        ray = tgeom.Ray.make(o, d)
        jray = jgeom.Ray.make(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
        jh = jisect.intersect_full(jj.scene, jray)
        th = _hit_to_torch(jh)
        jpid = jnp.asarray(pid.numpy().astype(np.uint32))
        jsidx = jnp.zeros(B, jnp.uint32)
        jm = jbsdf.gather_materials(jj.scene, jh.material, uv=jh.uv,
                                    p=jh.p)
        tm = tbsdf.gather_materials(tj.scene, th.material, uv=th.uv,
                                    p=th.p)
        ss, ts_ = jgeom.coordinate_system(jh.ns)
        jo = _jax_sss_event(jj.scene, jh, jm, jnp.ones((B, NS)), jh.valid,
                            ss, ts_, jpid, jsidx, jcfg, jsamp.sample_dim,
                            0, jray.wavelength, jnp.zeros(4), True)

        def sdim(dim):
            return tsamp.sample_dim(tcfg, pid, sidx, dim)

        to = tpath._sss_event(tj.scene, th, tm, torch.ones((B, NS)),
                              th.valid, torch.from_numpy(np.array(ss)),
                              torch.from_numpy(np.array(ts_)), sdim, 0,
                              ray.wavelength)
        us = [tpath._bdim(0, k) for k in (3, 4, 5)]
        out = []
        for pkg, (h, m, beta, alive, _) in (("port", to), ("jax", jo)):
            if pkg == "port":
                s1, s2 = tgeom.coordinate_system(h.ns)
                wo = tgeom.world_to_frame(s1, s2, h.ns, h.wo)
                wi, f, pdf, *_ = tbsdf.sample_f(m, wo, *(sdim(k) for k in us))
                refl = (m.type == tir.MAT_MIRROR) | (
                    m.type == tir.MAT_ROUGHGLASS)
                w = torch.where(refl & (pdf > 1e-12),
                                f[:, 15] * wi[:, 2].abs()
                                / pdf.clamp(min=1e-12), 0.0)
                out.append(float(w.double().mean()))
            else:
                s1, s2 = jgeom.coordinate_system(h.ns)
                wo = jgeom.world_to_frame(s1, s2, h.ns, h.wo)
                wi, f, pdf, *_ = jbsdf.sample_f(
                    m, wo, *(jsamp.sample_dim(jcfg, jpid, jsidx, k)
                             for k in us))
                refl = (m.type == tir.MAT_MIRROR) | (
                    m.type == tir.MAT_ROUGHGLASS)
                w = jnp.where(refl & (pdf > 1e-12),
                              f[:, 15] * jnp.abs(wi[:, 2])
                              / jnp.maximum(pdf, 1e-12), 0.0)
                out.append(float(np.asarray(w, np.float64).mean()))
        assert abs(out[0] - out[1]) <= 1e-3 * abs(out[1]) + 1e-9, out
        energy[name] = out[0]
    # the smooth interface: the share of lanes with u0 < Fr ~ 0.02
    assert 0.004 < energy["smooth"] < 0.06, energy
    assert energy["rough"] < 0.2 * energy["smooth"], energy


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

SPHERE = """
Integrator "%s" "integer maxdepth" [5]
Sampler "sobol" "integer pixelsamples" [8]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
AttributeBegin
  Translate 0 4 4
  LightSource "point" "color I" [60 60 60]
AttributeEnd
Material "subsurface" "color sigma_a" [0.02 0.02 0.02]
         "color sigma_s" [8 8 8] "float eta" [1.33]
Shape "sphere" "float radius" [1]
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
WorldEnd
"""


@pytest.mark.parametrize("integrator", ["path", "whitted"])
def test_subsurface_sphere_renders_like_jax(integrator):
    """The probe relocation (path) and the diffusion-limit fallback of an
    integrator without it (whitted)."""
    assert_renders_alike(*render_pair(SPHERE % integrator))


@pytest.mark.parametrize("passes", [2, 4])
def test_three_slabs_render_like_jax(passes):
    """tests/test_bssrdf.py's three-slab stack: the probe chain truncated
    at SSS_PROBE_PASSES hits (pbrt_tpu's constant set the same)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpath, "SSS_PROBE_PASSES", passes)
        mp.setattr(jpath, "SSS_PROBE_PASSES", passes)
        assert_renders_alike(*render_pair(_slabs(rough=0.3)))


def test_volpath_subsurface_in_fog_renders_like_jax():
    """volpath's probe hook on surface lanes, with a homogeneous medium
    filling the scene (the camera inside it)."""
    src = ('MakeNamedMedium "fog" "string type" "homogeneous" '
           '"rgb sigma_a" [.02 .02 .02] "rgb sigma_s" [.08 .08 .08]\n'
           'MediumInterface "fog" "fog"\n'
           + (SPHERE % "volpath").replace(
               "WorldBegin", 'WorldBegin\nMediumInterface "fog" "fog"'))
    assert_renders_alike(*render_pair(src))
