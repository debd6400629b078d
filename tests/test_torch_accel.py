"""The port's BVH and kd-tree routes (accel/bvh.py, accel/kdtree.py,
ops/accel_walk.py, ops/intersect.py's _intersect_bvh / _intersect_kd)
against pbrt_tpu's, on the CPU, where the walks run their plain versions.

Tolerances:
- the builds: arrays equal (`np.array_equal`; the BVH's packed rows bit
  for bit): the BVH is the same numpy code below 512 primitives and the
  same native builder source above; the port's C++ kd build repeats
  pbrt_tpu's numpy build in its order;
- the walks against pbrt_tpu's on the small shapes scene (2,999
  primitives) through `scene_from_jax`, static and with the moving
  heightfield, closest-hit and any-hit: found equal; prim equal but at
  ties (two triangles whose t agree within 1e-5 relative); t within 1e-5
  relative (XLA contracts multiply-adds into FMAs, torch does not, so a
  grazing lane's f32 t may part by a few ulps);
- pbrt_tpu's own twins: the BVH against a brute-force f64
  Moller-Trumbore (tests/test_intersect.py's limits: hit or miss equal on
  > 99% of lanes, t within 1e-3); kd equal to the BVH on random triangles
  (found equal, t within 1e-5 relative, prim equal on > 99.9%);
- a render over the (lowered) dense cap, 8x8, 2 spp, depth 3, through
  each walk, against pbrt_tpu's CPU render of the same scene through its
  kd walk:
  test_torch_volpath.assert_renders_alike (mean within 1e-4 relative,
  >= 97% of pixels within 1e-3, >= 99% within 1e-2), inside
  test_torch_integrators.py's (mean within 1%, >= 95% within 1e-2).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import bvh as jbvh
from pbrt_tpu.accel import kdtree as jkd
from pbrt_tpu.core import geometry as jgeom
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.parser.api import PbrtAPI as JAPI
from pbrt_tpu.scene import ir as jir
from pbrt_tpu_torch.accel import bvh as tbvh
from pbrt_tpu_torch.accel import kdtree as tkd
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.ops import accel_walk
from pbrt_tpu_torch.ops import intersect as tisect
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import pbrt as tcli
from pbrt_tpu_torch.tools import kernel_workloads as kw
from pbrt_tpu_torch.tools import shapes_scene
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parser import jax_arrays
from test_torch_volpath import assert_renders_alike, jax_render

SMALL = dict(level=1, instances=2, field=6, subdiv=1, res=16, spp=2)
T_REL = 1e-5


def _build_equal(a, b):
    assert a.n_nodes == b.n_nodes and a.max_leaf_size == b.max_leaf_size
    assert np.array_equal(a.packed.view(np.int32), b.packed.view(np.int32))
    for k in ("hit_links", "miss_links", "prim_order", "prim_offset",
              "prim_count"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("n", [40, 300, 1500, 5000],
                         ids=["numpy-40", "numpy-300", "native-1500",
                              "native-5000"])
def test_build_bvh_equals_jax(n):
    """The numpy SAH builder below 512 primitives, the native one at 512
    or more; with clusters of coinciding centres, which make the large
    leaves of ROADMAP Queue 3 (v)."""
    rs = np.random.RandomState(n)
    lo = rs.uniform(-5, 5, (n, 3))
    lo[: n // 10] = lo[0]
    hi = lo + rs.uniform(0, 0.5, (n, 3))
    hi[: n // 10] = lo[0] + 0.25
    a = tbvh.build_bvh(lo, hi, 4)
    _build_equal(a, jbvh.build_bvh(lo, hi, 4, "sah"))
    assert sorted(a.prim_order.tolist()) == list(range(n))


def _flat_quad_bounds():
    """tests/test_intersect.py:232's scene: a flat quad on y = 0, two
    triangle clusters above and below, so that the SAH splits at y = 0."""
    quad = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]],
                    np.float64)
    tris = [quad[[0, 1, 2]], quad[[0, 2, 3]]]
    rs = np.random.RandomState(0)
    for yc in (3.0, -3.0):
        base = rs.rand(40, 3)
        base[:, 1] = yc + base[:, 1] * 0.5
        tris += [np.stack([p, p + [0.3, 0, 0], p + [0, 0.1, 0.3]])
                 for p in base]
    v = np.asarray(tris, np.float32)
    return v.min(1), v.max(1)


@pytest.mark.parametrize("case", ["boxes", "flat-quad", "triangles",
                                  "empty"])
def test_build_kdtree_equals_jax(case):
    """The port's C++ build (native/kdtree_builder.cc) against pbrt_tpu's
    numpy build: seeded boxes, flat ones on a common plane among them; the
    flat quad on a split plane; the bounds of random triangles; no
    primitive."""
    if case == "boxes":
        rs = np.random.RandomState(11)
        lo = rs.uniform(-5, 5, (1200, 3)).astype(np.float32)
        hi = lo + rs.uniform(0, 0.6, (1200, 3)).astype(np.float32)
        lo[:100, 1] = hi[:100, 1] = 0.5
    elif case == "flat-quad":
        lo, hi = _flat_quad_bounds()
    elif case == "triangles":
        v = _random_tris(800, 5)[0].astype(np.float32)
        lo, hi = v.min(1), v.max(1)
    else:
        lo = hi = np.zeros((0, 3), np.float32)
    a, b = tkd.build_kdtree(lo, hi), jkd.build_kdtree(lo, hi)
    assert a.keys() == b.keys()
    for k in a:
        if k == "max_leaf":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if case == "flat-quad":
        # the quad (prims 0 and 1) stays in the tree
        assert {0, 1} <= set(a["prim_idx"].tolist())


# ---------------------------------------------------------------------------
# the walks against pbrt_tpu's on the small shapes scene
# ---------------------------------------------------------------------------

# the small shapes scene's variants: (Accelerator, moving heightfield);
# each holds both trees
VARIANTS = (("kdtree", False), ("kdtree", True))
# caps below the small scene, so that the port's parse takes the walks
LOW_CAPS = dict(MAX_DENSE_PRIMS=1000, MAX_MOTION_PRIMS=500)


@pytest.fixture(scope="module")
def shapes_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("accel"))
    for accel, moving in VARIANTS:
        shapes_scene.write_shapes_scene(_sub(d, accel, moving), accel=accel,
                                        moving_field=moving, **SMALL)
    return d


def _sub(d, accel, moving):
    return os.path.join(d, f"{accel}{'-moving' if moving else ''}")


_SCENES = {}


def _scenes(shapes_dir, accel, moving):
    """(pbrt_tpu's job, the port's job parsed over LOW_CAPS, scene_from_jax
    of pbrt_tpu's scene, which keeps pbrt_tpu's dense route) of a variant
    of the small shapes scene, parsed once per module."""
    key = (accel, moving)
    if key not in _SCENES:
        sub = _sub(shapes_dir, accel, moving)
        text = open(os.path.join(sub, "shapes.pbrt")).read()
        jj = JAPI().parse_string(text, sub)
        with pytest.MonkeyPatch.context() as mp:
            for k, v in LOW_CAPS.items():
                mp.setattr(tir, k, v)
            tj = TAPI("cpu").parse_string(text, sub)
        _SCENES[key] = (jj, tj, tir.scene_from_jax(*jax_arrays(jj.scene),
                                                   "cpu"))
    return _SCENES[key]


def _rays(n=1536, seed=0):
    """Rays from inside the Cornell box in all directions, a few dead
    (tmax -1) and some of a finite tmax, at random shutter times."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(0.2, 4.8, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d[:8] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0, -1, 0],
             [1, 1e-21, 0], [0, 0, 1], [-1, 0, -1e-22], [1, 1, 1]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::17] = -1.0
    tmax[5::7] = rs.uniform(0.1, 3.0, len(tmax[5::7]))
    time = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    return o, d, tmax, time


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
@pytest.mark.parametrize("anyhit", [False, True],
                         ids=["closest", "anyhit"])
def test_walk_equals_jax(shapes_dir, accel, moving, anyhit):
    """Each walk through the kdtree variants, which hold both trees."""
    jj, _, s = _scenes(shapes_dir, "kdtree", moving)
    assert s.has_animated_mesh == moving and s.use_kd
    o, d, tmax, time = _rays()
    jray = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d),
                          tmax=jnp.asarray(tmax), time=jnp.asarray(time))
    jfn = jisect._intersect_kd if accel == "kdtree" else jisect._intersect_bvh
    jt, jp, _, _, jf = (np.asarray(x) for x in jax.jit(
        jfn, static_argnums=2)(jj.scene, jray, anyhit))
    tray = tgeom.Ray.make(torch.as_tensor(o), torch.as_tensor(d),
                          tmax=torch.as_tensor(tmax),
                          time=torch.as_tensor(time))
    tfn = tisect._intersect_kd if accel == "kdtree" else tisect._intersect_bvh
    amask = torch.full((len(o),), anyhit)
    tt, tp, tf = (x.numpy() for x in tfn(s, tray, amask))
    assert np.array_equal(tf, jf)
    assert 0.2 < tf.mean() < 1.0
    if anyhit:
        return
    differ = np.nonzero(tp != jp)[0]
    assert len(differ) <= 0.005 * len(o)
    assert kw.walk_ties(
        s, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(time) if moving else None, torch.as_tensor(differ),
        torch.as_tensor(tp), torch.tensor(jp), T_REL).all()
    same = tf & (tp == jp)
    assert (np.abs(tt[same] - jt[same]) <= T_REL * np.abs(jt[same])).all()
    assert np.array_equal(tt[~tf], jt[~tf])


def test_walk_counts_and_plain_contract():
    """counts=True: node visits of every lane, tests only where leaves were
    hit, the distinct rows touched; the wrappers take the plain versions
    for CPU tensors and launch nothing."""
    b = tir.SceneBuilder()
    m = b.add_material(tir.MaterialSpec())
    verts, _ = _random_tris(300, 1)
    for v in verts:
        b.add_triangle_mesh(v, [[0, 1, 2]], m)
    s = b.build(device="cpu", accel="kdtree")
    o, d, tmax, _ = _rays(512, seed=3)
    o = o * 4 - 10
    args = dict(o=torch.as_tensor(o), d=torch.as_tensor(d),
                t_init=torch.as_tensor(tmax),
                prim_init=torch.full((512,), -1, dtype=torch.int32))
    accel_walk.reset_launch_counts()
    t, p = accel_walk.bvh_walk(packed=s.bvh_packed, links=s.bvh_links,
                               tri_packed=s.tri_packed, max_leaf=4, **args)
    t2, p2, c = accel_walk.bvh_walk_plain(
        packed=s.bvh_packed, links=s.bvh_links,
        tri_packed=s.tri_packed, max_leaf=4, counts=True, **args)
    assert torch.equal(t, t2) and torch.equal(p, p2)
    assert (c.visits >= 1).all() and c.tests.sum() > 0
    assert 0 < c.nodes <= s.n_nodes and 0 < c.tris <= 300
    kt, kp = accel_walk.kd_walk(
        tmax=torch.as_tensor(tmax), kd_packed=s.kd_packed,
        kd_prim_idx=s.kd_prim_idx, kd_bounds=s.kd_bounds,
        tri_packed=s.tri_packed, kd_max_leaf=s.kd_max_leaf, **args)
    kt2, kp2, kc = accel_walk.kd_walk_plain(
        tmax=torch.as_tensor(tmax), kd_packed=s.kd_packed,
        kd_prim_idx=s.kd_prim_idx, kd_bounds=s.kd_bounds,
        tri_packed=s.tri_packed, kd_max_leaf=s.kd_max_leaf, counts=True,
        **args)
    assert torch.equal(kt, kt2) and torch.equal(kp, kp2)
    assert kc.list_entries > 0 and kc.nodes <= s.kd_packed.shape[0]
    # dead lanes walk no kd node
    assert (kc.visits[torch.as_tensor(tmax) <= 0] == 0).all()
    assert all(v == 0 for v in accel_walk.LAUNCHES.values())
    with pytest.raises(ValueError, match="together"):
        accel_walk.bvh_walk(packed=s.bvh_packed, links=s.bvh_links,
                            tri_packed=s.tri_packed, max_leaf=4,
                            time=args["t_init"], **args)


# ---------------------------------------------------------------------------
# pbrt_tpu's own twins (tests/test_intersect.py)
# ---------------------------------------------------------------------------

def _random_tris(n, seed, spread=0.5):
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 3) * 10 - 5
    offs = rs.randn(n, 2, 3) * spread
    return np.concatenate([base[:, None, :], base[:, None, :] + offs], 1), rs


def _brute_force(verts, o, d):
    """tests/test_intersect.py's f64 Moller-Trumbore over every triangle."""
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    t_best = np.full(o.shape[0], np.inf)
    hit_any = np.zeros(o.shape[0], bool)
    for i in range(verts.shape[0]):
        pvec = np.cross(d, e2[i])
        det = (e1[i] * pvec).sum(-1)
        ok = np.abs(det) > 1e-7
        inv = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = o - v0[i]
        b1 = (tvec * pvec).sum(-1) * inv
        qvec = np.cross(tvec, e1[i])
        b2 = (d * qvec).sum(-1) * inv
        t = (e2[i] * qvec).sum(-1) * inv
        h = ok & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 1e-5)
        t_best = np.where(h & (t < t_best), t, t_best)
        hit_any |= h
    return t_best, hit_any


def _tri_scene(verts, accel="bvh", sphere=False):
    b = tir.SceneBuilder()
    m = b.add_material(tir.MaterialSpec())
    for v in verts:
        b.add_triangle_mesh(v, [[0, 1, 2]], m)
    if sphere:
        b.add_sphere(Transform(np.eye(4)), 1.5, m)
    return b.build(device="cpu", accel=accel)


def test_bvh_vs_brute_force():
    verts, _ = _random_tris(200, 0)
    s = _tri_scene(verts)
    rs = np.random.RandomState(3)
    o = (rs.rand(256, 3) * 20 - 10).astype(np.float32)
    d = rs.randn(256, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = tgeom.Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    t, _, found = tisect._intersect_bvh(s, ray)
    _, _, occ = tisect._intersect_bvh(s, ray, torch.ones(256, dtype=bool))
    t_ref, hit_ref = _brute_force(verts, o.astype(np.float64),
                                  d.astype(np.float64))
    found = found.numpy()
    assert (found == hit_ref).mean() > 0.99
    assert (occ.numpy() == hit_ref).mean() > 0.99
    m = found & hit_ref
    assert np.allclose(t.numpy()[m], t_ref[m], rtol=1e-3, atol=1e-3)


def test_kdtree_matches_bvh():
    """tests/test_intersect.py::test_kdtree_matches_bvh through the port:
    400 random triangles and a sphere, coherent and incoherent rays,
    closest hit and shadow rays (tmax 9, every fifth dead)."""
    verts, rs = _random_tris(400, 7, spread=0.6)
    s_kd = _tri_scene(verts, "kdtree", sphere=True)
    s_bvh = _tri_scene(verts, "bvh", sphere=True)
    assert s_kd.use_kd and not s_bvh.use_kd and s_kd.n_quadrics == 1
    for coherent in (True, False):
        if coherent:
            o = np.tile(np.array([[0.0, 0.0, -12.0]]), (2048, 1))
            d = rs.rand(2048, 3) * 10 - 5 - o
        else:
            o = rs.rand(2048, 3) * 14 - 7
            d = rs.randn(2048, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        ray = tgeom.Ray.make(torch.as_tensor(o, dtype=torch.float32),
                             torch.as_tensor(d, dtype=torch.float32))
        t1, p1, f1 = (x.numpy() for x in tisect._intersect_kd(s_kd, ray))
        t2, p2, f2 = (x.numpy() for x in tisect._intersect_bvh(s_bvh, ray))
        assert (f1 == f2).all()
        assert np.allclose(t1[f1], t2[f1], rtol=1e-5)
        assert (p1 == p2)[f1].mean() > 0.999
    tmax = np.full(2048, 9.0, np.float32)
    tmax[::5] = -1.0
    sray = tgeom.Ray.make(torch.as_tensor(o, dtype=torch.float32),
                          torch.as_tensor(d, dtype=torch.float32),
                          tmax=torch.as_tensor(tmax))
    amask = torch.ones(2048, dtype=torch.bool)
    occ1 = tisect._intersect_kd(s_kd, sray, amask)[2]
    occ2 = tisect._intersect_bvh(s_bvh, sray, amask)[2]
    assert torch.equal(occ1, occ2)
    assert not occ1[torch.as_tensor(tmax) <= 0].any()


# ---------------------------------------------------------------------------
# ROADMAP Queue 3 (v): the BVH's large leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_far", [100, 700], ids=["numpy", "native"])
def test_large_leaf_skips_a_triangle_as_in_jax(n_far):
    """8 concentric triangles share one box centre, the largest added last;
    the ray at (-7, -7.5) hits only the largest.  Both builders make one
    leaf of the 8 (up to 4 * max_leaf prims when the centres coincide),
    and the BVH walk tests only its first max_leaf = 4: pbrt_tpu's BVH
    and the port's miss the triangle (ROADMAP Queue 3 (v)); the kd-tree
    and the dense route find it."""
    base = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float64)
    tris = [base * s for s in range(1, 9)]
    rs = np.random.RandomState(2)
    far = rs.uniform(20, 40, (n_far, 3))
    tris += [np.stack([p, p + [0.2, 0, 0], p + [0, 0.2, 0]]) for p in far]

    def build(mod, accel):
        b = mod.SceneBuilder()
        m = b.add_material(mod.MaterialSpec())
        for i, v in enumerate(tris):
            b.add_triangle_mesh(v, [[0, 1, 2]], m, instance_id=i)
        return (b.build(device="cpu", accel=accel) if mod is tir
                else b.build(accel=accel))

    o = np.array([[-7.0, -7.5, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    jray = jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d))
    tray = tgeom.Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    js, jk = build(jir, "bvh"), build(jir, "kdtree")
    assert not bool(jisect._intersect_bvh(js, jray)[4][0])
    assert bool(jisect._intersect_kd(jk, jray)[4][0])
    s, sk = build(tir, "bvh"), build(tir, "kdtree")
    assert s.use_dense and s.n_nodes == js.n_nodes
    biggest = int(np.nonzero(s.prim_instance.numpy() == 7)[0][0])
    t, p, f = tisect._intersect_bvh(s, tray)
    assert not f[0] and p[0] == -1 and torch.isinf(t[0])
    tk, pk, fk = tisect._intersect_kd(sk, tray)
    assert fk[0] and pk[0] == biggest and abs(tk[0].item() - 5.0) < 1e-5
    _, pd, fd = tisect.intersect(s, tray)          # the dense route
    assert fd[0] and pd[0] == biggest


# ---------------------------------------------------------------------------
# the route over the cap: build and render
# ---------------------------------------------------------------------------

_JAX_IMAGE = []


def _jax_kd_image(jj):
    """pbrt_tpu's 8x8 render (2 spp, depth 3) of job jj through its kd
    walk (use_dense false), rendered once for the module."""
    if not _JAX_IMAGE:
        j = dataclasses.replace(jj, scene=jj.scene.replace(use_dense=False))
        j.film_width = j.film_height = 8
        _JAX_IMAGE.append(jax_render(j, 2, 3))
    return _JAX_IMAGE[0]


@pytest.mark.parametrize("accel", ["kdtree", "bvh"])
def test_over_cap_renders_like_jax(shapes_dir, accel):
    """With the caps lowered below the small shapes scene, the port builds
    no dense table for the moving variant and walks its kd-tree, or, told
    to leave it (use_kd false), its BVH, each at the rays' times.  Each
    8x8 render matches pbrt_tpu's, which walks the kd-tree of the same
    scene and is rendered once for both cases: the two trees' hits agree
    on this scene (test_walk_equals_jax)."""
    jj, tj, _ = _scenes(shapes_dir, "kdtree", True)
    tj = dataclasses.replace(tj, scene=dataclasses.replace(
        tj.scene, use_kd=accel == "kdtree"))
    s = tj.scene
    assert not s.use_dense and s.dense_w is None and s.dense_cb is None
    assert s.dense_chunk == 0 and s.has_animated_mesh and not s.dense_motion
    assert tcli.route_name(s) == ("kd-tree" if accel == "kdtree" else "BVH")
    tj.film_width = tj.film_height = 8
    accel_walk.reset_launch_counts()
    tf, _ = tcli.run_job(tj, spp=2, max_depth=3)
    ti = tfilm.develop_spectral(tf).numpy()
    ji = _jax_kd_image(jj)
    assert_renders_alike(ti, ji)
    assert abs(ti.mean() / ji.mean() - 1) < 0.01


def test_scene_from_jax_carries_the_trees(shapes_dir):
    """The BVH, kd-tree and route flags come across unchanged, and equal
    the port's own build (over the lowered caps, the walks' route; the
    dense route's scenes compare whole in test_torch_shapes.py);
    tri_packed equals pbrt_tpu's."""
    jj, tj, s = _scenes(shapes_dir, "kdtree", True)
    own = tj.scene
    for k in tir.BVH_COLUMNS + tir.KD_COLUMNS + ("tri_packed",
                                                 "tri_motion"):
        a, b = getattr(own, k), getattr(s, k)
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b), k
    assert np.array_equal(np.asarray(jj.scene.tri_packed),
                          s.tri_packed.numpy())
    assert np.array_equal(np.asarray(jj.scene.kd_packed).view(np.int32),
                          s.kd_packed.numpy().view(np.int32))
    assert (s.n_nodes, s.max_leaf, s.kd_max_leaf, s.use_dense) == (
        jj.scene.n_nodes, jj.scene.max_leaf, jj.scene.kd_max_leaf, True)
    assert (own.n_nodes, own.max_leaf, own.kd_max_leaf, own.use_dense,
            own.use_kd, own.dense_motion) == (s.n_nodes, 4, s.kd_max_leaf,
                                              False, True, False)
    assert s.dense_motion and s.dense_w is not None
    # quadric rows never hit
    quad = s.prim_type.numpy() != tir.PRIM_TRIANGLE
    assert quad.sum() == 5 and not s.tri_packed.numpy()[quad].any()
