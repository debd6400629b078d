"""Differentiable rendering: the port's integrators/diff.py against
pbrt_tpu.integrators.diff on the CPU, on the same scenes (carried over by
scene_from_jax / camera_from_jax) and the same seeded parameters.

pbrt_tpu's side runs its gradients unfused, with its sampler, BSDF,
light and intersect functions jitted one by one (as
test_torch_materials_render.py runs its render): XLA compiles the fused
gradient of the depth-5 Cornell loss in several minutes on the CPU, the
pieces in ~30 s, and a jitted piece is compiled once and reused by every
bounce.  Each reference is computed once per module.

Tolerances: the samples are the same Sobol' bits and the paths the same
paths (12 triangles and two quadric spheres, where the two intersectors
agree), so the gradients agree to f32 rounding: within 1e-5 of the
gradient's largest entry (measured ~5e-7).  The camera's J^T w leaves out
the pixels whose forward values differ between the two packages by more
than 1e-4 relative (a path that went elsewhere: a visibility flip), and
holds the rest within 1e-4 of |J|^T |w|, the limit each pixel's value
is held to (measured 2.5e-5).  Adam: parameters within 1e-6
after each of 5 steps.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.integrators import diff as jdiff
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import bsdf as jbsdf
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.ops import intersect as jisect
from pbrt_tpu.samplers import samplers as jsamp
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu.scene.ir import SceneBuilder, MaterialSpec, MAT_MATTE
from pbrt_tpu_torch.cameras import projective as tproj
from pbrt_tpu_torch.integrators import diff as tdiff
from pbrt_tpu_torch.parser.api import parse_scene as tparse
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from pbrt_tpu_torch.scene import ir as tir
from pbrt_tpu_torch.tools import launch_components
from pbrt_tpu_torch.tools import pbrt as tcli
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"
GRAD_RTOL = 1e-5          # of the gradient's largest entry
CAM_W = 24                # tests/test_diff_camera.py's film and depth
CAM_DEPTH = 2
CAM_P = {"cam_delta": [0.004, -0.003, 0.002, 0.02, -0.015, 0.01],
         "cam_fov": 50.4}
FLIP_RTOL = 1e-4          # a pixel whose forward values differ by more
CAM_RTOL = 1e-4           # J^T w, of |J|^T |w|
ADAM_ATOL = 1e-6
CAMERA_FIELDS = ("cam_to_world", "raster_to_camera", "camera_to_raster",
                 "lens_radius", "focal_distance", "shutter_open",
                 "shutter_close")


@pytest.fixture(scope="module", autouse=True)
def jax_pieces():
    """pbrt_tpu's path loop with its sampler, BSDF, light and intersect
    functions jitted one by one (the same functions in the same order)."""
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpath, "sample_dim", jit(jsamp.sample_dim,
                                            static_argnums=0))
        for name in ("eval_f", "pdf_f", "sample_f", "gather_materials",
                     "bump_shading_normal"):
            mp.setattr(jbsdf, name, jit(getattr(jbsdf, name)))
        for name in ("sample_li", "area_le", "pdf_li_area", "env_le",
                     "pdf_li_infinite"):
            mp.setattr(jlights, name, jit(getattr(jlights, name)))
        mp.setattr(jisect, "trace_pair", jit(jisect.trace_pair))
        mp.setattr(jisect, "intersect_full", jit(
            jisect.intersect_full, static_argnames=("presorted",)))
        yield


def _carry(js, jc):
    ts = tir.scene_from_jax({k: np.asarray(getattr(js, k))
                             for k in tir.JAX_ARRAYS},
                            {k: getattr(js, k) for k in tir.JAX_STATICS},
                            DEV)
    tc = tproj.camera_from_jax({k: np.asarray(getattr(jc, k))
                                for k in CAMERA_FIELDS}, DEV)
    return ts, tc


def _sphere():
    """tests/test_diff.py's scene: a matte sphere under a constant
    infinite light, 8x8."""
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(type=MAT_MATTE,
                                    kd=np.full(31, 0.5, np.float32)))
    b.add_sphere(jtfm.Transform(), 1.0, m)
    b.add_infinite_light(np.full(31, 1.0, np.float32))
    js = b.build()
    jc = jproj.make_perspective(
        jtfm.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), 30.0, 8, 8)
    return js, jc


@pytest.fixture(scope="module")
def sphere():
    js, jc = _sphere()
    return (js, jc) + _carry(js, jc)


@pytest.fixture(scope="module")
def cornell():
    js, jcam = jflag.cornell(tessellate=False)
    return {w: (js, jcam(w, w)) + _carry(js, jcam(w, w))
            for w in (8, CAM_W)}


# (scene, W, sample indices, depth, params, target fill): test_diff.py's
# albedo loss on the sphere; the Cornell box at depth 5 (the main path's)
# and 6, the shallowest depth at which Russian roulette (bounces > 3)
# scales a beta that a later NEE sample uses: at depth 5 the bounce after
# it only adds emission found by a BSDF sample, which no lane of this
# 8x8 loss finds
LOSSES = {
    "sphere": ("sphere", 8, (0, 1), 3, ("mat_kd", "env_map"), 0.3),
    "cornell-d5": ("cornell", 8, (0, 1), 5, ("mat_kd", "light_L"), None),
    "cornell-d6": ("cornell", 8, (0, 1), 6, ("mat_kd", "light_L"), None),
}


def _target(n, fill):
    if fill is not None:
        return np.full((n, 31), fill, np.float32)
    return (np.random.RandomState(10).rand(n, 31) * 0.5).astype(np.float32)


def _scene_of(name, sphere, cornell, w):
    return sphere if name == "sphere" else cornell[w]


@pytest.fixture(scope="module")
def jax_grads(sphere, cornell):
    """pbrt_tpu's render_loss and its gradients, one jax.grad call per
    loss."""
    out = {}
    for key, (name, w, samples, depth, fields, fill) in LOSSES.items():
        js, jc, _, _ = _scene_of(name, sphere, cornell, w)
        ids = jnp.arange(w * w, dtype=jnp.uint32)
        tgt = jnp.asarray(_target(w * w, fill))

        def loss(p):
            return jdiff.render_loss(p, js, jc, w, w, JCfg("sobol", 0, 4),
                                     ids, samples, tgt, max_depth=depth)

        lv, g = jax.value_and_grad(loss)({f: getattr(js, f)
                                          for f in fields})
        out[key] = float(lv), {k: np.asarray(v) for k, v in g.items()}
    return out


def _port_loss(key, sphere, cornell):
    name, w, samples, depth, fields, fill = LOSSES[key]
    _, _, ts, tc = _scene_of(name, sphere, cornell, w)
    tgt = torch.from_numpy(_target(w * w, fill))
    ids = torch.arange(w * w)

    def loss(p):
        return tdiff.render_loss(p, ts, tc, w, w, TCfg("sobol", 0, 4), ids,
                                 samples, tgt, max_depth=depth)
    return loss, {f: getattr(ts, f).clone() for f in fields}


@pytest.mark.parametrize("key", list(LOSSES))
def test_render_loss_grads_match_jax(key, sphere, cornell, jax_grads):
    loss, params = _port_loss(key, sphere, cornell)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    lv = loss(p)
    grads = dict(zip(p, torch.autograd.grad(lv, list(p.values()))))
    jl, jg = jax_grads[key]
    assert abs(float(lv.detach()) / jl - 1) < 1e-5
    for k, g in grads.items():
        a, b = g.numpy(), jg[k]
        assert np.isfinite(a).all(), k
        scale = np.abs(b).max()
        assert scale > 0, k
        err = np.abs(a - b).max() / scale
        assert err < GRAD_RTOL, (key, k, err)


@pytest.fixture(scope="module")
def jax_camera(cornell):
    """tests/test_diff_camera.py's per-pixel render (24x24, depth 2) at
    its parameters: the values and the vjp function."""
    js, jc, _, _ = cornell[CAM_W]
    ids = jnp.arange(CAM_W * CAM_W, dtype=jnp.uint32)

    def render(p):
        L, _ = jdiff.render_samples(p, js, jc, CAM_W, CAM_W,
                                    JCfg("sobol", 0, 4), ids, jnp.uint32(0),
                                    max_depth=CAM_DEPTH)
        return L.sum(-1)

    out, vjp = jax.vjp(render, {k: jnp.asarray(v, jnp.float32)
                                for k, v in CAM_P.items()})
    return np.asarray(out), vjp


def test_camera_vjp_matches_jax(cornell, jax_camera):
    """J^T w for three seeded w, the pixels whose forward values differ
    (visibility flips) left out of w on both sides; each component within
    CAM_RTOL of |J|^T |w| (J's columns from the port's forward-mode
    derivatives: J^T w of random w cancels to far below its terms)."""
    _, _, ts, tc = cornell[CAM_W]
    jout, vjp = jax_camera

    def render(delta, fov):
        L, _ = tdiff.render_samples(
            {"cam_delta": delta, "cam_fov": fov}, ts, tc, CAM_W, CAM_W,
            TCfg("sobol", 0, 4), torch.arange(CAM_W * CAM_W), 0,
            max_depth=CAM_DEPTH)
        return L.sum(-1)

    p = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
         for k, v in CAM_P.items()}
    out = render(p["cam_delta"], p["cam_fov"])
    tout = out.detach().numpy()
    flip = np.abs(tout - jout) > FLIP_RTOL * np.maximum(np.abs(jout), 1e-3)
    assert flip.mean() < 0.02, flip.mean()
    d0, f0 = (v.detach() for v in p.values())
    cols = [torch.autograd.functional.jvp(
        lambda d: render(d, f0), d0, torch.eye(6)[i])[1] for i in range(6)]
    absj = {"cam_delta": torch.stack(cols, -1).abs().numpy(),
            "cam_fov": torch.autograd.functional.jvp(
                lambda f: render(d0, f), f0, torch.tensor(1.0))[1]
            .abs().numpy()[:, None]}
    ws = np.random.RandomState(11).randn(3, CAM_W * CAM_W)
    for w in np.where(flip, 0.0, ws).astype(np.float32):
        g = torch.autograd.grad(out, list(p.values()),
                                grad_outputs=torch.from_numpy(w),
                                retain_graph=True)
        jg = vjp(jnp.asarray(w))[0]
        for k, gk in zip(p, g):
            a, b = gk.numpy().reshape(-1), np.asarray(jg[k]).reshape(-1)
            assert np.isfinite(a).all(), k
            scale = absj[k].T @ np.abs(w)
            err = (np.abs(a - b) / scale).max()
            assert err < CAM_RTOL, (k, a, b, scale)


@pytest.fixture(scope="module")
def jax_train(sphere):
    """Five steps of pbrt_tpu's make_train_step (optax.adam, lr 0.1) on
    tests/test_diff.py's inverse-rendering scene, its step run eagerly on
    the jitted pieces; returns the target and each step's params."""
    js, jc, _, _ = sphere
    ids = jnp.arange(64, dtype=jnp.uint32)
    cfg = JCfg("sobol", 0, 4)
    tgt, _ = jdiff.render_samples({"mat_kd": jnp.full((1, 31), 0.8)}, js,
                                  jc, 8, 8, cfg, ids, jnp.uint32(0),
                                  max_depth=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        init, step = jdiff.make_train_step(js, jc, 8, 8, cfg, tgt,
                                           max_depth=3, learning_rate=0.1)
    params = _train_start(js)
    state = init(params)
    steps = []
    for _ in range(5):
        params, state, loss = step(params, state, ids, jnp.uint32(0))
        steps.append(({k: np.asarray(v) for k, v in params.items()},
                      float(loss)))
    return np.array(tgt), steps


def _train_start(js):
    rs = np.random.RandomState(12)
    return {"mat_kd": jnp.asarray(0.3 + 0.1 * rs.rand(1, 31), jnp.float32),
            "env_map": jnp.asarray(np.asarray(js.env_map)
                                   * (0.7 + 0.2 * rs.rand(31)), jnp.float32)}


def test_train_step_matches_optax(sphere, jax_train):
    js, _, ts, tc = sphere
    tgt, steps = jax_train
    init, step = tdiff.make_train_step(ts, tc, 8, 8, TCfg("sobol", 0, 4),
                                       torch.from_numpy(tgt), max_depth=3,
                                       learning_rate=0.1)
    params = {k: torch.from_numpy(np.array(v))
              for k, v in _train_start(js).items()}
    state = init(params)
    for i, (jp, jl) in enumerate(steps):
        params, state, loss = step(params, state, torch.arange(64), 0)
        assert abs(float(loss) / jl - 1) < 1e-5, (i, float(loss), jl)
        for k, v in params.items():
            assert not v.requires_grad
            np.testing.assert_allclose(v.numpy(), jp[k], rtol=0,
                                       atol=ADAM_ATOL, err_msg=f"{i} {k}")
    assert steps[-1][1] < steps[0][1]


def test_grad_albedo_matches_finite_difference(sphere):
    """The port's own finite-difference harness on one mat_kd bin of
    tests/test_diff.py's albedo loss, at its threshold."""
    loss, params = _port_loss("sphere", sphere, None)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(loss(p), [p["mat_kd"]])[0]
    fd = tdiff.finite_difference_grad(loss, params, "mat_kd", 15, eps=2e-3)
    ad = float(g.reshape(-1)[15])
    assert abs(ad - fd) < max(3e-3, 0.05 * abs(fd)), (ad, fd)
    assert abs(ad) > 1e-5


RS = np.random.RandomState(13)


@pytest.mark.parametrize("r", [np.zeros(3), 1e-4 * RS.randn(3),
                               0.7 * RS.randn(3)],
                         ids=["zero", "small", "large"])
def test_so3_exp_matches_jax(r):
    r32 = r.astype(np.float32)
    jv, jj = (np.asarray(f(jnp.asarray(r32))) for f in (
        jax.jit(jdiff._so3_exp), jax.jit(jax.jacrev(jdiff._so3_exp))))
    t = torch.from_numpy(r32)
    tv = tdiff._so3_exp(t).numpy()
    tj = torch.autograd.functional.jacobian(tdiff._so3_exp, t).numpy()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    assert np.isfinite(tj).all()
    np.testing.assert_allclose(tj, jj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [np.zeros(6), np.r_[0.3 * RS.randn(3),
                                                  RS.randn(3)]],
                         ids=["zero", "seeded"])
def test_se3_matrix_matches_jax(d):
    d32 = d.astype(np.float32)
    jv, jj = (np.asarray(f(jnp.asarray(d32))) for f in (
        jax.jit(jdiff._se3_matrix), jax.jit(jax.jacrev(jdiff._se3_matrix))))
    t = torch.from_numpy(d32)
    np.testing.assert_allclose(tdiff._se3_matrix(t).numpy(), jv, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        torch.autograd.functional.jacobian(tdiff._se3_matrix, t).numpy(),
        jj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fov,w,h", [(50.4, 24, 24), (30.0, 32, 20)])
def test_perspective_raster_to_camera_matches_jax(fov, w, h):
    def jf(f):
        return jdiff._perspective_raster_to_camera(f, w, h)

    def tf(f):
        return tdiff._perspective_raster_to_camera(f, w, h)

    f32 = np.float32(fov)
    jv = np.asarray(jax.jit(jf)(jnp.float32(f32)))
    jj = np.asarray(jax.jit(jax.jacrev(jf))(jnp.float32(f32)))
    t = torch.tensor(f32)
    tv = tf(t).numpy()
    tj = torch.autograd.functional.jacobian(tf, t).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tj, jj, rtol=1e-5, atol=1e-8)
    # the static build's matrix at the same fov
    cam = tproj.make_perspective(tproj.tfm.Transform(), fov, w, h,
                                 device=DEV)
    np.testing.assert_allclose(tv, cam.raster_to_camera.numpy(), rtol=1e-5,
                               atol=1e-7)


# the leaves each scene uses (a nonzero gradient expected), at 8x8, 1 spp,
# depth 3; every other leaf of DIFFERENTIABLE_FIELDS must be finite
USED = {"cornell_materials.pbrt": ("mat_kd", "mat_ks", "mat_kr", "mat_kt",
                                   "light_L"),
        "cornell_lights.pbrt": ("mat_kd", "light_L", "env_map")}


@pytest.mark.parametrize("name", list(USED))
def test_every_gradient_finite(name):
    job = tparse(os.path.join(ROOT, "pbrt_tpu_torch", "scenes", name),
                 device=DEV)
    sc = job.scene
    W = 8
    cam = tcli.build_camera(job, W, W, DEV)
    p = {k: getattr(sc, k).clone().requires_grad_(True)
         for k in tdiff.DIFFERENTIABLE_FIELDS}
    ids = torch.arange(W * W)
    tgt = torch.zeros(W * W, 31)
    loss = tdiff.render_loss(p, sc, cam, W, W, TCfg(job.sampler_kind, 0, 1),
                             ids, (0,), tgt, max_depth=3)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)))
    assert torch.isfinite(loss)
    for k, g in grads.items():
        if g is None:
            assert k not in USED[name], k
            continue
        assert torch.isfinite(g).all(), (name, k)
        if k in USED[name]:
            assert g.abs().max() > 0, (name, k)


def test_launch_components_counts_the_backward():
    """launch_components --grad: the forward by component, the backward
    as one component; the backward holds only what depends on mat_kd
    and light_L, a small share of the forward's operations."""
    job = tparse(os.path.join(ROOT, "scenes", "cornell_bench.pbrt"),
                 device=DEV)
    counts, launches = launch_components.count_pass(job, 64, 8, 8, DEV,
                                                    grad=True)
    plain, _ = launch_components.count_pass(job, 64, 8, 8, DEV)
    fwd = sum(v for k, v in counts.items() if k != "backward")
    assert "backward" not in plain
    assert 0 < counts["backward"] < fwd / 10
    assert fwd >= sum(plain.values())
    assert not any(launches.values())       # the CPU runs no kernel
