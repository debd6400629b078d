"""Two-keyframe motion blur in the port against pbrt_tpu (CPU): animated
transforms, the motion section table and K2 motion's plain version,
intersection and hit records of moving meshes and spheres, camera motion
rays, and a whole motion render.

Tolerances, each with its reason:
- decompose/animated_pair: exact (the same f64 numpy code);
  interp_matrix / affine_inverse against the `_j` versions: 1e-5 (f32
  trigonometry and sums in another order).
- the f32 motion table against pbrt_tpu's bf16x2 one: 2^-15 relative
  (its hi + lo split keeps ~16 bits).
- K2 motion's plain version against an f64 Moller-Trumbore on the
  interpolated vertices: found differs on <= 0.1% of rays (grazing hits),
  t within 1e-4 relative, prim equal on > 99%.
- against pbrt_tpu's BVH intersect (tests/test_motion_blur.py:230-236):
  found agrees on > 99.5%, 99th-percentile relative t < 2e-3; make_hit
  from the same (t, prim) agrees to 1e-4.
- camera rays: 1e-5 (f32 slerp and matrix products).
- the 16x16 render: image mean within 1e-4 relative (measured 1.2e-7
  on the CPU, see test_motion_render_matches_jax).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.ops import pallas_intersect as jdense
from pbrt_tpu.parser.api import parse_scene as jparse
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu.scene import ir as jir
from pbrt_tpu_torch.cameras import projective as tproj
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.core import transform as ttfm
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.ops import dense_intersect as tdense
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.scene import ir as tir
from test_torch_parser import (MOTION, assert_scene_equal, jax_arrays,
                               small_film)
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"
BIG = 3.0e38


def _trs(rs):
    """A random translate * rotate * scale transform (numpy matrix)."""
    axis = rs.randn(3)
    return (jtfm.translate(*rs.randn(3))
            * jtfm.rotate(rs.uniform(-170, 170), *axis)
            * jtfm.scale(*rs.uniform(0.5, 2.0, 3))).m


def test_animated_pair_and_interpolation_match_jax():
    rs = np.random.RandomState(21)
    for _ in range(4):
        m0, m1 = _trs(rs), _trs(rs)
        pj = jtfm.animated_pair(m0, m1)
        pt = ttfm.animated_pair(m0, m1)
        for a, b in zip(pj, pt):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        u = np.concatenate([[0.0, 1.0], rs.rand(62)]).astype(np.float32)
        jm = jtfm.interp_matrix_j(*(jnp.asarray(x) for x in pj),
                                  jnp.asarray(u))
        tm = ttfm.interp_matrix(*(torch.from_numpy(x) for x in pt),
                                torch.from_numpy(u))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tm[0].numpy(), m0[:3], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tm[1].numpy(), m1[:3], rtol=1e-5,
                                   atol=1e-5)
        ji = jtfm.affine_inverse_j(jm)
        ti = ttfm.affine_inverse(tm)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5,
                                   atol=1e-5)


def _moving_soup(n_tris=600, seed=0):
    """A triangle soup whose odd triangles move (translate and deform)."""
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n_tris, 3) * 10 - 5
    e1, e2 = rs.randn(2, n_tris, 3) * 0.5
    dm = np.zeros((n_tris, 12))
    dm[1::2, 0:3] = rs.randn(n_tris // 2, 3) * 1.0
    dm[1::2, 3:9] = rs.randn(n_tris // 2, 6) * 0.2
    return v0, e1, e2, dm


def _rays(n_rays=1024, seed=1):
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.0, 0.0, -12.0]]), (n_rays, 1))
    d = rs.rand(n_rays, 3) * 10 - 5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            rs.rand(n_rays).astype(np.float32))


def _port_motion(v0, e1, e2, dm, o, d):
    tab = tdense.build_dense_tables_motion(v0, e1, e2, dm)
    r16 = tdense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tab["center"]))
    return (tab, r16, torch.from_numpy(tab["W"]),
            torch.from_numpy(tab["chunk_bounds"]))


def test_motion_table_matches_jax():
    v0, e1, e2, dm = _moving_soup(seed=2)
    ref = jdense.build_dense_tables_motion(v0, e1, e2, dm)
    got = tdense.build_dense_tables_motion(v0, e1, e2, dm)
    assert ref["chunk"] == got["chunk"]
    assert np.array_equal(ref["chunk_bounds"], got["chunk_bounds"])
    assert np.array_equal(ref["center"], got["center"])
    hi = np.asarray(ref["W"][:, 0:16]).astype(np.float32)
    lo = np.asarray(ref["W"][:, 32:48]).astype(np.float32)
    W = got["W"]
    assert W.dtype == np.float32 and W.shape == hi.shape
    # the recorded deviation (ROADMAP Queue 3): the port writes exact
    # zeros as an unmoving triangle's planes 1-3, where pbrt_tpu's fit
    # leaves up to ~1e-14; every other entry as pbrt_tpu's
    C, chunk = W.shape[0], got["chunk"]
    ref_w = (hi + lo).reshape(C, 16, 4, 4, chunk)
    still = np.ones(C * chunk, bool)
    still[:v0.shape[0]] = ~dm.any(1)
    dev = np.zeros(ref_w.shape, bool)
    dev[:, :, 1:] = still.reshape(C, 1, 1, 1, chunk)
    assert (W.reshape(ref_w.shape)[dev] == 0).all()
    assert np.abs(ref_w[dev]).max() <= 1e-14
    np.testing.assert_allclose(ref_w[~dev], W.reshape(ref_w.shape)[~dev],
                               rtol=2.0 ** -15, atol=1e-30)
    # static triangles: plane 0 is the static table, planes 1-3 vanish
    planes = W.reshape(C, 16, 4, 4, chunk).transpose(2, 3, 1, 0, 4) \
        .reshape(4, 4, 16, C * chunk)[..., :v0.shape[0]]
    static = tdense.build_dense_tables(v0, e1, e2)["W"]
    static = static.reshape(C, 16, 4, chunk).transpose(2, 1, 0, 3) \
        .reshape(4, 16, C * chunk)[..., :v0.shape[0]]
    np.testing.assert_allclose(planes[0][..., 0::2], static[..., 0::2],
                               rtol=1e-6, atol=1e-12)
    assert np.abs(planes[1:, ..., 0::2]).max() < 1e-6
    assert np.abs(planes[3][..., 1::2]).max() > 1e-4     # cubic terms


def test_motion_table_exact_for_unmoving_triangles():
    """An unmoving triangle's plane 0 is build_dense_tables' entry bit for
    bit and its planes 1-3 are exact zeros (pbrt_tpu's fit leaves ~1e-15
    there: its inverse Vandermonde rows do not sum to 0), so Horner in any
    time returns the static entry; a moving triangle's planes are
    pbrt_tpu's within test_motion_table_matches_jax's tolerance."""
    v0, e1, e2, dm = _moving_soup(n_tris=700, seed=9)
    dm[384:512] = 0.0                      # chunk 3: no triangle moves
    got = tdense.build_dense_tables_motion(v0, e1, e2, dm)
    ref = jdense.build_dense_tables_motion(v0, e1, e2, dm)
    static = tdense.build_dense_tables(v0, e1, e2)
    C, chunk = got["W"].shape[0], got["chunk"]
    planes = got["W"].reshape(C, 16, 4, 4 * chunk)
    still = np.ones(C * chunk, bool)
    still[:700] = ~dm.any(1)
    col = np.broadcast_to(still.reshape(C, 1, chunk), (C, 4, chunk)) \
        .reshape(C, 1, 4 * chunk)
    st = np.broadcast_to(col, (C, 16, 4 * chunk))
    assert np.array_equal(planes[:, :, 0][st], static["W"][st])
    assert (planes[:, :, 1:][np.broadcast_to(col[:, :, None], planes[:, :, 1:]
                                             .shape)] == 0).all()
    jw = (np.asarray(ref["W"][:, 0:16]).astype(np.float32)
          + np.asarray(ref["W"][:, 32:48]).astype(np.float32)) \
        .reshape(C, 16, 4, 4 * chunk)
    mv = ~np.broadcast_to(col[:, :, None], planes.shape)
    np.testing.assert_allclose(planes[mv], jw[mv], rtol=2.0 ** -15,
                               atol=1e-30)
    # pbrt_tpu's planes 1-3 of unmoving triangles are tiny, not zero
    assert np.abs(jw[:, :, 1:][~mv[:, :, 1:]]).max() > 0
    # Horner in the plain version's order returns plane 0 exactly
    u = np.float32(0.37)
    h = planes[:, :, 3]
    for k in (2, 1, 0):
        h = h * u + planes[:, :, k]
    assert np.array_equal(h[st], static["W"][st])


@pytest.mark.parametrize("case", ["soup", "cornell_motion"])
def test_chunk_static_marks_chunks_without_moving_triangles(case, tmp_path):
    if case == "soup":
        v0, e1, e2, dm = _moving_soup(n_tris=700, seed=10)
        dm[:256] = 0.0
        tab = tdense.build_dense_tables_motion(v0, e1, e2, dm)
        chunk = tab["chunk"]
        want = np.array([not dm[c * chunk:(c + 1) * chunk].any()
                         for c in range(tab["W"].shape[0])])
        got = tab["chunk_static"]
        assert got.tolist() == [True, True, False, False, False, False]
    else:
        scene = tparse(MOTION, device=DEV).scene
        moving = scene.tri_motion.numpy().any(1)
        chunk = scene.dense_chunk
        C = scene.dense_w.shape[0]
        want = np.array([not moving[c * chunk:(c + 1) * chunk].any()
                         for c in range(C)])
        got = scene.dense_static.numpy()
        assert got.dtype == np.bool_ and got.shape == (C,)
    assert np.array_equal(got, want), (
        f"{case}: chunk_static {got.astype(int).tolist()}, expected "
        f"{want.astype(int).tolist()}")
    assert 0 < got.sum() < got.size, (
        f"{case}: {int(got.sum())} static chunks of {got.size}")


def test_motion_plain_on_static_table_matches_static_plain():
    """On a soup with no moving triangle the motion table's plain version
    finds the static plain version's prims, and t within 1 ulp (the two
    CPU matmuls differ in width, so they may round differently; the
    kernels' bit-for-bit check is a card test)."""
    v0, e1, e2, _ = _moving_soup(n_tris=500, seed=11)
    o, d, time = _rays(n_rays=1024, seed=12)
    tm_tab = tdense.build_dense_tables_motion(v0, e1, e2, np.zeros((500, 12)))
    st_tab = tdense.build_dense_tables(v0, e1, e2)
    assert tm_tab["chunk_static"].all()
    r16 = tdense.ray_vectors(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(st_tab["center"]))
    anyhit = torch.zeros(1024, dtype=torch.bool)
    anyhit[1::3] = True
    r16[:, 12] = anyhit.float()
    tmax = torch.full((1024,), BIG)
    tmax[::9] = -1.0
    cb = torch.from_numpy(st_tab["chunk_bounds"])
    cl, na = tdense.tile_chunk_lists(r16, tmax, cb)
    t_s, p_s = tdense.loop_hits_plain(r16, tmax,
                                      torch.from_numpy(st_tab["W"]), cl, na)
    t_m, p_m = tdense.loop_hits_motion_plain(
        r16, tmax, torch.from_numpy(time), torch.from_numpy(tm_tab["W"]),
        cl, na)
    assert (p_s >= 0).sum() > 200 and (anyhit & (p_s >= 0)).sum() > 50
    assert torch.equal(p_s, p_m)
    ulp = torch.abs(torch.nextafter(t_s, torch.tensor(np.inf)) - t_s)
    assert ((t_m - t_s).abs() <= ulp).all()


def _mt_motion(v0, e1, e2, dm, o, d, time):
    """f64 closest-hit Moller-Trumbore against each ray's interpolated
    triangles -> (t, prim)."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    u = time.astype(np.float64)[:, None, None]
    V0 = v0[None] + u * dm[None, :, 0:3]
    E1 = e1[None] + u * dm[None, :, 3:6]
    E2 = e2[None] + u * dm[None, :, 6:9]
    pvec = np.cross(d[:, None], E2)
    det = (E1 * pvec).sum(-1)
    inv = 1.0 / np.where(det == 0, 1, det)
    tvec = o[:, None] - V0
    b1 = (tvec * pvec).sum(-1) * inv
    qvec = np.cross(tvec, E1)
    b2 = (d[:, None] * qvec).sum(-1) * inv
    t = (E2 * qvec).sum(-1) * inv
    hit = ((np.abs(det) > 1e-9) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
           & (t > 1e-4))
    t = np.where(hit, t, np.inf)
    prim = t.argmin(1)
    t_best = t.min(1)
    return t_best, np.where(np.isfinite(t_best), prim, -1)


def test_motion_plain_matches_f64_moller_trumbore():
    v0, e1, e2, dm = _moving_soup(seed=3)
    o, d, time = _rays(seed=4)
    tab, r16, W, cb = _port_motion(v0, e1, e2, dm, o, d)
    before = dict(tdense.LAUNCHES)
    t, prim = tdense.dense_intersect_loop(
        r16, torch.full((o.shape[0],), BIG), W, cb,
        torch.from_numpy(tab["chunk_static"]), time=torch.from_numpy(time))
    assert tdense.LAUNCHES == before              # plain versions never count
    t, prim = t.numpy(), prim.numpy()
    tb, pb = _mt_motion(v0, e1, e2, dm, o, d, time)
    found, ref_found = prim >= 0, pb >= 0
    assert found.mean() > 0.2
    assert (found != ref_found).mean() <= 1e-3
    both = found & ref_found
    assert (np.abs(t[both] - tb[both]) / tb[both]).max() < 1e-4
    assert (prim == pb).mean() > 0.99


def test_motion_t_within_bound_and_truncated_table_breaks_it():
    """Every closest-hit lane of the plain version lies within the f32
    bound of loop_t_reference_motion (the bound chip_smoke.py holds the
    CUDA kernel to), and a table with coefficient plane 3 zeroed breaks
    it on most lanes that hit a moving triangle."""
    v0, e1, e2, dm = _moving_soup(seed=5)
    o, d, time = _rays(seed=6)
    tab, r16, W, cb = _port_motion(v0, e1, e2, dm, o, d)
    tmax = torch.full((o.shape[0],), BIG)
    tm = torch.from_numpy(time)
    cl, na = tdense.tile_chunk_lists(r16, tmax, cb)
    t, prim = tdense.loop_hits_motion_plain(r16, tmax, tm, W, cl, na)
    hit = prim >= 0
    t64, bound = tdense.loop_t_reference_motion(r16[hit], tm[hit], W,
                                                prim[hit])
    assert torch.isfinite(bound).all() and (bound < 1e-3).all()
    assert ((t[hit].double() - t64).abs() <= bound * t64.abs()).all()
    chunk = tab["chunk"]
    Wt = W.clone().reshape(W.shape[0], 16, 4, 4 * chunk)
    Wt[:, :, 3] = 0.0
    t3, p3 = tdense.loop_hits_motion_plain(r16, tmax, tm,
                                           Wt.reshape(W.shape), cl, na)
    moving = hit & (p3 == prim) & (prim % 2 == 1) & (tm > 0.2)
    assert moving.sum() > 50
    t64, bound = tdense.loop_t_reference_motion(r16[moving], tm[moving], W,
                                                prim[moving])
    beyond = (t3[moving].double() - t64).abs() > bound * t64.abs()
    assert beyond.double().mean() > 0.5


def _quads_scene(ir, tfm):
    """tests/test_motion_blur.py:188-205's moving and static quads and a
    moving sphere, with an area light in place of the distant light."""
    b = ir.SceneBuilder()
    m = b.add_material(ir.MaterialSpec(type=ir.MAT_MATTE,
                                       kd=np.full(31, .8, np.float32)))
    li = b.add_area_light(np.full(31, 3.0, np.float32))
    b.add_triangle_mesh([[-4, -4, 9], [-4, 4, 9], [4, 4, 9], [4, -4, 9]],
                        [[0, 1, 2], [2, 3, 0]], m, light_id=li)
    quad = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
    b.add_triangle_mesh(quad, [[0, 1, 2], [2, 3, 0]], m,
                        object_to_world=tfm.Transform(),
                        object_to_world1=(tfm.translate(2, 0, 0.5)
                                          * tfm.rotate(25, 0, 0, 1)))
    b.add_triangle_mesh([[-3, -3, -2], [3, -3, -2], [3, 3, -2],
                         [-3, 3, -2]], [[0, 1, 2], [2, 3, 0]], m)
    b.add_sphere(tfm.translate(-1.5, 1.0, 0.5), 0.6, m,
                 object_to_world1=tfm.translate(-0.5, 1.0, 1.5))
    return b


def _quad_rays():
    rs = np.random.RandomState(5)
    B = 512
    o = (rs.randn(B, 3) * np.array([2.0, 2.0, 0.2])
         + np.array([0.5, 0, 5.0])).astype(np.float32)
    d = rs.randn(B, 3) * np.array([0.6, 0.6, 0.2]) + np.array([0, 0, -1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, rs.rand(B).astype(np.float32)


def test_moving_quads_and_sphere_match_jax():
    """The port's intersect (plain K1 + K2 motion + the moving-sphere
    test) and make_hit against pbrt_tpu's BVH intersect and make_hit."""
    js = _quads_scene(jir, jtfm).build()
    ts = _quads_scene(tir, ttfm).build(device=DEV)
    assert_scene_equal(ts, tir.scene_from_jax(*jax_arrays(js), DEV))
    assert ts.dense_motion and ts.has_animated_quads
    o, d, tm = _quad_rays()
    jray = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d),
                          time=jnp.asarray(tm))
    tray = tgeom.Ray.make(torch.from_numpy(o), torch.from_numpy(d),
                          time=torch.from_numpy(tm))
    jt, jp, _, _, jf = (np.array(x) for x in jisect.intersect(js, jray))
    tt, tp, tf = (x.numpy() for x in tisect.intersect(ts, tray))
    assert (jf == tf).mean() > 0.995
    both = jf & tf
    assert both.sum() > 50
    rel = np.abs(tt[both] - jt[both]) / np.maximum(jt[both], 1e-6)
    assert np.quantile(rel, 0.99) < 2e-3
    assert (tp[both] == jp[both]).mean() > 0.99
    sphere = both & (jp == int(js.quad_prim[0]))
    assert sphere.sum() > 10                    # the moving sphere is hit
    jh = jisect.make_hit(js, jray, jnp.asarray(jt), jnp.asarray(jp),
                         jnp.zeros_like(jt), jnp.zeros_like(jt),
                         jnp.asarray(jf))
    th = tisect.make_hit(ts, tray, torch.from_numpy(jt),
                         torch.from_numpy(jp), torch.from_numpy(jf))
    for k in ("t", "p", "ng", "ns", "uv"):
        np.testing.assert_allclose(getattr(th, k).numpy()[jf],
                                   np.asarray(getattr(jh, k))[jf],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_camera_motion_rays_match_jax():
    W, H = 40, 30
    c2w0 = jtfm.look_at([-0.8, -6, 1], [-0.8, 0, 0.5], [0, 0, 1])
    c2w1 = jtfm.look_at([0.8, -6, 1.5], [0.3, 0, 0.5], [0, 0, 1])
    jc = jproj.make_perspective(c2w0, 40.0, W, H, cam_to_world1=c2w1)
    tc = tproj.make_perspective(ttfm.Transform(c2w0.m), 40.0, W, H,
                                cam_to_world1=ttfm.Transform(c2w1.m),
                                device=DEV)
    fields = ("cam_to_world", "raster_to_camera", "camera_to_raster",
              "lens_radius", "focal_distance", "shutter_open",
              "shutter_close") + tproj.ANIM_FIELDS
    tc2 = tproj.camera_from_jax({k: np.asarray(getattr(jc, k))
                                 for k in fields}, DEV)
    rs = np.random.RandomState(22)
    pf = (rs.rand(256, 2) * [W, H]).astype(np.float32)
    ul = rs.rand(256, 2).astype(np.float32)
    ut = rs.rand(256).astype(np.float32)
    jr, _ = jproj.generate_rays(jc, jnp.asarray(pf), jnp.asarray(ul),
                                jnp.asarray(ut), width=W, height=H)
    for cam in (tc, tc2):
        tr, _ = tproj.generate_rays(cam, torch.from_numpy(pf),
                                    torch.from_numpy(ul),
                                    torch.from_numpy(ut))
        for k in ("o", "d", "time"):
            np.testing.assert_allclose(getattr(tr, k).numpy(),
                                       np.asarray(getattr(jr, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # the rays do move: time 0 and 1 see different origins
    assert np.ptp(np.asarray(jr.o)[:, 0]) > 1.0


def test_motion_render_matches_jax(tmp_path, monkeypatch):
    """cornell_motion.pbrt at 16x16, 2 spp, depth 5 through both
    packages' render: the same Sobol' samples, so almost every path is
    the same path.  Image mean within 1e-4 relative (measured 1.2e-7 on
    the CPU).  The JAX sampler's sample_dim is jitted on its own, so that
    tracing the render traces it once, not once per sample dimension (the
    same function, the same bits)."""
    monkeypatch.setattr(jpath, "sample_dim",
                        jax.jit(jsamp.sample_dim, static_argnums=0))
    scene = small_film(MOTION, tmp_path)
    jj, tj = jparse(scene), tparse(scene, device=DEV)
    W = H = 16
    spp = 2
    jc = jproj.make_perspective(jj.cam_to_world, 50.0, W, H)
    tc = tproj.make_perspective(tj.cam_to_world, 50.0, W, H, device=DEV)
    jf = jpath.render(jj.scene, jc, jfilm.make_film(W, H),
                      JCfg("sobol", 0, spp), spp, max_depth=5)
    tf = tpath.render(tj.scene, tc, tfilm.make_film(W, H, device=DEV),
                      TCfg("sobol", 0, spp), spp, max_depth=5)
    ji = np.asarray(jfilm.develop_spectral(jf))
    ti = tfilm.develop_spectral(tf).numpy()
    rel = abs(ti.mean() / ji.mean() - 1)
    print(f"16x16 motion render: image mean rel diff {rel:.3e}")
    assert np.isfinite(ti).all() and ti.mean() > 0
    assert rel < 1e-4


def test_launch_counts_cover_the_motion_kernel():
    tdense.LAUNCHES["dense_loop_motion"] = 3
    tdense.LAUNCHES["dense_loop_ablate[direct]"] = 2
    tdense.reset_launch_counts()
    assert tdense.LAUNCHES == {"dense_queue": 0, "dense_queue_cull": 0,
                               "dense_loop": 0,
                               "dense_loop_motion": 0,
                               "dense_loop_ablate[empty]": 0,
                               "dense_loop_ablate[stage]": 0,
                               "dense_loop_ablate[sections]": 0,
                               "dense_loop_ablate[direct]": 0,
                               "dense_tile_dump": 0,
                               "dense_loop_init": 0}


def test_motion_wrapper_takes_plain_path_on_cpu_only():
    v0, e1, e2, dm = _moving_soup(n_tris=200, seed=7)
    o, d, time = _rays(n_rays=256, seed=8)
    tab, r16, W, cb = _port_motion(v0, e1, e2, dm, o, d)
    tmax = torch.full((256,), BIG)
    tm = torch.from_numpy(time)
    st = torch.from_numpy(tab["chunk_static"])
    cl, na = tdense.tile_chunk_lists(r16, tmax, cb)
    a = tdense.loop_hits_motion(r16, tmax, tm, W, cl, na, st)
    b = tdense.loop_hits_motion_plain(r16, tmax, tm, W, cl, na)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tdense.loop_hits_motion(r16, tmax, tm.to("meta"), W, cl, na, st)
