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


@pytest.fixture(scope="module")
def scenes():
    js, jcam = jflag.cornell(tessellate=True)
    ts, tcam = tflag.cornell()
    return js, jcam, ts, tcam


def jax_arrays(js):
    arrays = {k: np.asarray(getattr(js, k)) for k in tir.JAX_COLUMNS}
    statics = {k: getattr(js, k) for k in tir.JAX_STATICS}
    return arrays, statics


def _assert_scene_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert torch.equal(x, y), f
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
        return b.build()
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


def test_unported_features_raise(scenes):
    b = tir.SceneBuilder()
    with pytest.raises(NotImplementedError):
        b.add_material(tir.MaterialSpec(type=4))          # metal
    js = scenes[0]
    arrays, statics = jax_arrays(js)
    arrays["mat_type"] = np.append(arrays["mat_type"], 9)  # disney
    with pytest.raises(NotImplementedError):
        tir.scene_from_jax(arrays, statics, "cpu")


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
    film = tfilm.make_film(8, 8).to("cpu")
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
