"""The port's scene compile against pbrt_tpu's (CPU).

Tolerance: exact.  Both packages order primitives with the same BVH
builders (native SAH at >= 512 prims, numpy below) and compute the same
f32 columns, and the dense section tables come from the same f64 code.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.ops import pallas_intersect as jdense
from pbrt_tpu.scene import ir as jir
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu_torch.cameras import projective as tproj
from pbrt_tpu_torch.core import transform as ttfm
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.ops import dense_intersect as tdense
from pbrt_tpu_torch.scene import ir as tir
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_core import tensors_equal

DEV = "cpu"


@pytest.fixture(scope="module")
def scenes():
    js, jcam = jflag.cornell(tessellate=True)
    ts, tcam = tflag.cornell(device=DEV)
    return js, jcam, ts, tcam


def jax_arrays(js):
    arrays = {k: np.asarray(getattr(js, k)) for k in tir.JAX_ARRAYS}
    statics = {k: getattr(js, k) for k in tir.JAX_STATICS}
    return arrays, statics


def _assert_scene_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert tensors_equal(x, y), f
        else:
            assert x == y, f


def test_cornell_equals_scene_from_jax(scenes):
    js, _, ts, _ = scenes
    _assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), "cpu"))
    assert ts.tri_v0.shape[0] == 6061           # 6,060 triangles + 1 sphere
    assert ts.dense_w.shape == (48, 16, 4 * 128)


def test_cornell_columns_equal_jax(scenes):
    js, _, ts, _ = scenes
    for k in tir.JAX_COLUMNS:
        a = np.asarray(getattr(js, k))
        b = getattr(ts, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in tir.JAX_STATICS:
        assert getattr(js, k) == getattr(ts, k), k


def test_untessellated_cornell_equals_jax():
    """cornell(tessellate=False): the box's 12 triangles and the mirror
    and plastic spheres as quadrics, column for column."""
    js, jcam = jflag.cornell(tessellate=False)
    ts, tcam = tflag.cornell(tessellate=False, device=DEV)
    for k in tir.JAX_COLUMNS:
        a = np.asarray(getattr(js, k))
        b = getattr(ts, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in tir.JAX_STATICS:
        assert getattr(js, k) == getattr(ts, k), k
    _assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), DEV))
    assert ts.n_quadrics == 2 and ts.prim_type.shape[0] == 14
    np.testing.assert_array_equal(tcam(24, 24).raster_to_camera.numpy(),
                                  np.asarray(jcam(24, 24).raster_to_camera))


def test_dense_tables_equal_jax(scenes):
    js, _, ts, _ = scenes
    v0, e1, e2 = (np.asarray(getattr(js, k), np.float64)
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    ref = jdense.build_dense_tables(v0, e1, e2, chunk=js.dense_chunk)
    got = tdense.build_dense_tables(v0, e1, e2, chunk=ts.dense_chunk)
    assert np.array_equal(ref["chunk_bounds"], got["chunk_bounds"])
    assert np.array_equal(ref["center"], got["center"])
    assert ref["chunk"] == got["chunk"]
    assert np.array_equal(np.asarray(js.dense_cb), ts.dense_cb.numpy())
    # the port keeps the f32 sections the TPU split into bf16 hi/lo
    center = v0.mean(0)
    inv = (1.0 / jdense._plucker_scale(v0, e1, e2, center))[:, None]
    sec = jdense._plucker_sections(v0, e1, e2, center, inv)
    assert np.array_equal(
        sec, tdense._plucker_sections(v0, e1, e2, center, inv))
    C, chunk, P = ts.dense_w.shape[0], ts.dense_chunk, v0.shape[0]
    W = ts.dense_w.numpy().reshape(C, 16, 4, chunk).transpose(2, 1, 0, 3) \
        .reshape(4, 16, C * chunk)
    assert np.array_equal(W[:, :, :P], sec.astype(np.float32))
    assert not W[:, :, P:].any()


def test_small_scene_numpy_bvh_order_matches():
    """Below 512 prims both packages order with the numpy SAH builder."""
    def build(ir, tfm):
        b = ir.SceneBuilder()
        m0 = b.add_material(ir.MaterialSpec(type=ir.MAT_MATTE,
                                            kd=np.full(31, .5, np.float32)))
        m1 = b.add_material(ir.MaterialSpec(type=ir.MAT_GLASS,
                                            kr=np.ones(31, np.float32),
                                            kt=np.ones(31, np.float32)))
        rs = np.random.RandomState(11)
        verts = rs.rand(300, 3) * 4
        b.add_triangle_mesh(verts, rs.randint(0, 300, (200, 3)), m0)
        li = b.add_area_light(np.full(31, 5.0, np.float32))
        b.add_triangle_mesh([[1, 1, 3], [2, 1, 3], [2, 2, 3]], [[0, 1, 2]],
                            m0, light_id=li)
        b.add_sphere(tfm.translate(2, 2, 1), 0.5, m1)
        return b.build(device=DEV) if ir is tir else b.build()
    js = build(jir, jtfm)
    ts = build(tir, ttfm)
    _assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), "cpu"))


def test_camera_from_jax(scenes):
    _, jcam, _, tcam = scenes
    jc, tc = jcam(64, 48), tcam(64, 48)
    arrays = {k: np.asarray(getattr(jc, k)) for k in (
        "cam_to_world", "raster_to_camera", "camera_to_raster",
        "lens_radius", "focal_distance", "shutter_open", "shutter_close")}
    cc = tproj.camera_from_jax(arrays, "cpu")
    for k in ("cam_to_world", "raster_to_camera", "camera_to_raster"):
        assert torch.equal(getattr(cc, k), getattr(tc, k)), k
    for k in ("lens_radius", "focal_distance", "shutter_open",
              "shutter_close"):
        assert getattr(cc, k) == getattr(tc, k), k


def test_every_material_family_builds():
    """SceneBuilder takes every material family of the JAX package (hair,
    fourier with its lattice, subsurface with its profile table): the
    same scene as scene_from_jax of pbrt_tpu's builder, with the static
    flags that gate them."""
    from pbrt_tpu.materials import bssrdf as jb
    from pbrt_tpu.materials import fourier as jfour
    table = jb.compute_beam_diffusion_bssrdf(0.0, 1.33, n_rho=16,
                                             n_radius=24)
    mu = np.linspace(-1.0, 1.0, 6)
    grid = jfour.bake_grid(dict(
        mu=mu, cdf=None, a_offset=np.zeros((6, 6), np.int64),
        m=np.zeros((6, 6), np.int64), a=np.zeros(0), m_max=1,
        n_channels=1, eta=1.0), n_mu=8, n_phi=8)
    grid[:, :, :, 1] = 0.25
    built = []
    for irmod in (tir, jir):
        b = irmod.SceneBuilder()
        mats = [irmod.MaterialSpec(type=irmod.MAT_HAIR, kd=np.full(
                    31, 0.4, np.float32), rough_u=0.3, rough_v=0.3,
                    sigma=2.0, eta=1.55, remap_roughness=False),
                irmod.MaterialSpec(type=irmod.MAT_FOURIER,
                                   fourier_id=b.add_fourier_grid(grid)),
                irmod.MaterialSpec(type=irmod.MAT_SUBSURFACE,
                                   bssrdf_id=b.add_bssrdf_table(table),
                                   sss_sigma_t=np.full(31, 5.0, np.float32),
                                   sss_rho=np.full(31, 0.9, np.float32),
                                   kd=np.full(31, 0.6, np.float32))]
        for k, m in enumerate(mats):
            mid = b.add_material(m)
            b.add_triangle_mesh(np.float32([[0, 0, k], [1, 0, k],
                                            [1, 1, k]]), [[0, 1, 2]], mid)
        built.append(b.build(**({"device": "cpu"} if irmod is tir
                                else {})))
    ts, js = built
    assert ts.has_hair and ts.has_fourier and ts.has_sss and not ts.has_ptex
    assert ts.mat_families == (tir.MAT_MIRROR, tir.MAT_HAIR,
                               tir.MAT_FOURIER, tir.MAT_ROUGHGLASS,
                               tir.MAT_SUBSURFACE, tir.MAT_SSW)
    _assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), "cpu"))


def test_dataclasses_move_between_devices(scenes):
    """SceneData, ProjectiveCamera, Film, Ray, Hit and MaterialParams each
    carry a .to(device) that moves every tensor field."""
    from pbrt_tpu_torch.film import film as tfilm
    from pbrt_tpu_torch.integrators import path as tpath
    from pbrt_tpu_torch.materials import bsdf as tbsdf
    from pbrt_tpu_torch.ops import intersect as tisect
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    _, _, ts, tcam = scenes
    _assert_scene_equal(ts, ts.to("cpu"))
    cam = tcam(8, 8).to("cpu")
    ray = tpath.camera_rays_for_pixels(cam, 8, 8, SamplerConfig(),
                                       torch.arange(64), 0)[0].to("cpu")
    hit = tisect.intersect_full(ts, ray, presorted=True).to("cpu")
    mat = tbsdf.gather_materials(ts, hit.material).to("cpu")
    film = tfilm.make_film(8, 8, device=DEV).to("cpu")
    for obj in (cam, ray, hit, mat, film):
        for f in obj.__dataclass_fields__:
            v = getattr(obj, f)
            assert not torch.is_tensor(v) or v.device.type == "cpu", f
    assert hit.valid.all() and (mat.type >= 0).all()


@pytest.mark.parametrize("lens_radius", [0.0, 0.1])
def test_generate_rays_matches_jax(lens_radius):
    """Pinhole and thin-lens rays (the lens camera via camera_from_jax)."""
    import jax.numpy as jnp
    from pbrt_tpu.cameras import projective as jproj
    look = ([2.5, -4.5, 2.5], [2.5, 2.5, 2.5], [0, 0, 1])
    jc = jproj.make_perspective(jtfm.look_at(*look), 50.0, 40, 30,
                                lens_radius=lens_radius, focal_distance=6.0)
    tc = tproj.camera_from_jax(
        {k: np.asarray(getattr(jc, k)) for k in (
            "cam_to_world", "raster_to_camera", "camera_to_raster",
            "lens_radius", "focal_distance", "shutter_open",
            "shutter_close")}, "cpu")
    rs = np.random.RandomState(18)
    pf = (rs.rand(256, 2) * [40, 30]).astype(np.float32)
    ul = rs.rand(256, 2).astype(np.float32)
    ut = rs.rand(256).astype(np.float32)
    jr, jw = jproj.generate_rays(jc, jnp.asarray(pf), jnp.asarray(ul),
                                 jnp.asarray(ut), width=40, height=30)
    tr, tw = tproj.generate_rays(tc, torch.from_numpy(pf),
                                 torch.from_numpy(ul), torch.from_numpy(ut))
    for k in ("o", "d", "tmax", "wavelength", "time"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert np.array_equal(tw.numpy(), np.asarray(jw))


def test_materials_scene_columns_from_packed_table():
    """pbrt_tpu_torch/scenes/cornell_materials.pbrt parsed by both: the
    port's SceneData equals scene_from_jax of pbrt_tpu's, whose conductor
    spectra, opacity and Beckmann flag come only from the packed table's
    bf16-hi + residual rows, and those sums are the f32 values exactly
    (the hi rows alone are not)."""
    import os
    from pbrt_tpu.parser.api import parse_scene as jparse
    from pbrt_tpu_torch.parser.api import parse_scene as tparse
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "pbrt_tpu_torch", "scenes",
        "cornell_materials.pbrt")
    js, ts = jparse(path).scene, tparse(path, device="cpu").scene
    _assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), "cpu"))
    packed = np.asarray(js.mat_packed)
    M = packed.shape[0] // 2
    for col, off in (("mat_eta_spec", jir.MPK_SPECTRA.index("eta_spec")),
                     ("mat_k_spec", jir.MPK_SPECTRA.index("k_spec")),
                     ("mat_opacity", jir.MPK_SPECTRA.index("opacity"))):
        sl = slice(off * 31, off * 31 + 31)
        want = getattr(ts, col).numpy()
        assert np.array_equal(packed[:M, sl] + packed[M:, sl], want), col
        assert np.array_equal(np.asarray(getattr(js, col)), want), col
    assert not np.array_equal(packed[:M, 4 * 31:5 * 31],
                              ts.mat_eta_spec.numpy())     # copper's eta
    beck = ts.mat_beckmann.numpy()
    assert beck.sum() == 1 and np.array_equal(
        beck, packed[:M, jir.MPK_BECKMANN] > 0.5)
    assert ts.mat_families == (0, 1, 4, 5, 6, 7, 8, 9, 12, 13)
    assert ts.tex_kinds == (0, 1, 7) and ts.has_bump and ts.has_mix
    assert ts.has_disney and ts.has_beckmann
    assert float(ts.world_radius) == float(js.world_radius)


def _light_builder(ir_mod, tfm_mod):
    """One light of every kind through the builder API (pbrt_tpu's or the
    port's modules)."""
    b = ir_mod.SceneBuilder()
    m = b.add_material(ir_mod.MaterialSpec(kd=np.full(31, .5, np.float32)))
    b.add_triangle_mesh([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]],
                        [[0, 1, 2], [2, 3, 0]], m)
    li = b.add_area_light(np.full(31, 3.0, np.float32), two_sided=True)
    b.add_sphere(tfm_mod.translate(1, 2, 1) * tfm_mod.scale(2, 2, 2), .25, m,
                 light_id=li)
    lm = b.add_area_light(np.full(31, 2.0, np.float32))
    b.add_triangle_mesh([[0, 0, 4], [1, 0, 4], [0, 1, 4]], [[0, 1, 2]], m,
                        light_id=lm)
    b.add_point_light([1, 1, 3], np.linspace(1, 2, 31).astype(np.float32))
    b.add_spot_light([0, 0, 4], [0.3, 0, -1], np.full(31, 5, np.float32),
                     0.85, 0.9)
    b.add_distant_light([0.2, -1, -1], np.full(31, 1.5, np.float32))
    env = np.random.RandomState(3).rand(6, 12, 31).astype(np.float32)
    env[3:] = 0.0
    b.add_infinite_light(np.ones(31, np.float32), env_map=env,
                         light_to_world=tfm_mod.rotate(-90, 1, 0, 0))
    tid = b.textures.add(0, image=np.random.RandomState(4).rand(
        8, 8, 3).astype(np.float32))
    b.add_light(type=ir_mod.LIGHT_GONIO, pos=np.float32([2, 2, 3]),
                dir=np.float32([0, 0, -1]), L=np.full(31, 2, np.float32),
                params=np.float32([0, 0, tid, np.cos(np.radians(20))]))
    return b


def test_light_builders_match_jax():
    """Every builder light call gives pbrt_tpu's light, selection and env
    columns and light statics bit for bit (a scaled two-sided sphere
    light, a mesh light, point, spot, distant, a rotated env map and a
    goniometric light)."""
    js = _light_builder(jir, jtfm).build()
    ts = _light_builder(tir, ttfm).build(device=DEV)
    for k in tir.LIGHT_COLUMNS:
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("n_lights", "light_kinds", "has_mesh_lights",
              "has_sphere_lights", "has_infinite", "inf_light_idx"):
        assert getattr(js, k) == getattr(ts, k), k
    assert ts.light_quad[0] >= 0 and ts.light_sph_radius[0] == 0.5
    assert ts.env_map.shape == (6, 12, 31)
