"""The port's MLT (integrators/mlt.py) and trace_paths' primary-sample
hook against pbrt_tpu's on the CPU, on tests/test_lighttracer.py's scene
(a light quad over a floor) at 8x8, depth 2, 512 chains bootstrapped
from 512 paths (one batch shape, so pbrt_tpu's trace_paths compiles
once).

pbrt_tpu's render_mlt runs eagerly around its jitted trace_paths; its
splats are captured to read each step's proposal and its acceptance.
- trace_paths(uniforms=) lane by lane on seeded uniforms [512, 32]:
  >= 99% of lanes within 1e-5 relative (measured: every lane);
- the bootstrap's b within 1e-6 relative and the same chain seeds on
  >= 99% of chains; one mutate_step from that state: accept flips at
  most 1% of chains, the step's splats summing within 1e-4 of pbrt_tpu's
  (measured: b equal, every seed, no flip);
- render_mlt's image mean (8 mutations) within 1% (measured: equal).
A scene with subsurface, hair, a mix material and three lights under the
"all" strategy reads every sampler dimension from the uniforms (the
sampler is never called) with the wrap at D.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import projective as jproj
from pbrt_tpu.core import transform as jtfm
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import mlt as jmlt
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.core import geometry as tgeom
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import mlt as tmlt
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.parser.api import PbrtAPI as TAPI
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from test_lighttracer import _scene as light_quad_scene
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lighttracer import port_camera, port_scene

W = H = 8
CHAINS = BOOT = 512
MUTATIONS = 8
DEPTH = 2
ALL_DIMS = """LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [20 20 20] "point from" [0 3 -3]
LightSource "spot" "rgb I" [20 20 20] "point from" [2 2 -3]
    "point to" [0 0 0]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [4 4 4]
Shape "trianglemesh" "point P" [-3 3 -3  3 3 -3  3 3 3  -3 3 3]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
MakeNamedMaterial "a" "string type" "matte" "rgb Kd" [.8 .2 .2]
MakeNamedMaterial "b" "string type" "plastic" "rgb Kd" [.2 .2 .8]
Material "mix" "string namedmaterial1" "a" "string namedmaterial2" "b"
    "rgb amount" [.5 .5 .5]
Shape "trianglemesh" "point P" [-5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5]
    "integer indices" [0 1 2 2 3 0]
AttributeBegin
Material "subsurface" "color sigma_a" [.05 .05 .05]
    "color sigma_s" [6 6 6] "float eta" [1.33]
Translate -0.8 0 0
Shape "sphere" "float radius" [0.6]
AttributeEnd
Material "hair" "float eumelanin" [0.3]
Shape "curve" "point P" [0.2 -1 0  0.6 0.5 0  0.9 -0.5 0  1.2 1 0]
    "float width" [0.3] "string type" "flat"
WorldEnd
"""


@pytest.fixture(scope="module")
def scenes():
    js = light_quad_scene()
    jc = jproj.make_perspective(
        jtfm.look_at([0, -6, 2.5], [0, 0, 1], [0, 0, 1]), 40.0, W, H)
    return js, jc, port_scene(js), port_camera(jc)


@pytest.fixture(scope="module")
def jax_mlt(scenes):
    """pbrt_tpu's render_mlt, eager around its trace_paths (jitted for
    the module), with each add_splats call's (pfilm, L) captured."""
    js, jc, _, _ = scenes
    splats = []
    add = jfilm.add_splats
    trace = jax.jit(jpath.trace_paths, static_argnums=(4,),
                    static_argnames=("max_depth",))

    def record(film, pfilm, L):
        splats.append((np.asarray(pfilm), np.asarray(L)))
        return add(film, pfilm, L)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpath, "trace_paths", trace)
        mp.setattr(jfilm, "add_splats", record)
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        img, b = jmlt.render_mlt(js, jc, W, H, n_chains=CHAINS,
                                 mutations_per_chain=MUTATIONS,
                                 n_bootstrap=BOOT, max_depth=DEPTH)
    return np.asarray(img), b, splats, trace


def test_trace_paths_uniforms_lane_by_lane(scenes, jax_mlt):
    js, _, ts, _ = scenes
    trace = jax_mlt[3]
    D = tmlt.n_dims(DEPTH)
    u = np.random.RandomState(3).rand(CHAINS, D).astype(np.float32)
    o = np.tile(np.float32([[0.0, -6.0, 2.5]]), (CHAINS, 1))
    d = np.stack([u[:, 0] - 0.5, np.ones(CHAINS), u[:, 1] - 0.9], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    from pbrt_tpu.core import geometry as jgeom
    jL = np.asarray(trace(js, jgeom.Ray.make(jnp.asarray(o), jnp.asarray(d)),
                          jnp.zeros(CHAINS, jnp.uint32), jnp.uint32(0),
                          JCfg("independent", 0, 1), max_depth=DEPTH,
                          uniforms=jnp.asarray(u)))
    pid = torch.zeros(CHAINS, dtype=torch.int64)
    tL = tpath.trace_paths(ts, tgeom.Ray.make(torch.as_tensor(o),
                                              torch.as_tensor(d)),
                           pid, pid, TCfg("independent", 0, 1),
                           max_depth=DEPTH, uniforms=torch.as_tensor(u))
    tL = tL.numpy()
    assert (jL.sum(-1) > 0).mean() > 0.5
    ok = (np.abs(tL - jL) <= 1e-5 * np.abs(jL) + 1e-7).all(-1)
    assert ok.mean() >= 0.99


def test_mutate_step_like_jax(scenes, jax_mlt):
    """The bootstrap, then one mutate_step from its state; pbrt_tpu's
    chain c accepted its first proposal where the current state it
    splats at step 2 is that proposal."""
    _, _, ts, tc = scenes
    _, jb, splats, _ = jax_mlt
    assert len(splats) == 2 * MUTATIONS
    b, state = tmlt.bootstrap(ts, tc, W, H, CHAINS, BOOT, DEPTH)
    assert abs(b / jb - 1) < 1e-6
    # the same seeds: pbrt_tpu's first current-state splat is at them
    assert (state[2].numpy() == splats[1][0]).all(-1).mean() >= 0.99
    film = tfilm.make_film(W, H, device="cpu")
    _, acc = tmlt.mutate_step(ts, tc, film, state, 1, b, 0.01, 0.3, DEPTH)
    acc_j = (splats[3][0] == splats[0][0]).all(-1)
    assert (acc.numpy() != acc_j).mean() <= 0.01
    assert 0.2 < acc_j.mean() < 1.0
    # the step's two splats land in the buffer: their sum, pbrt_tpu's
    inb = lambda pf: ((pf >= 0) & (pf < W)).all(-1)  # noqa: E731
    j_sum = sum(L[inb(pf)].sum() for pf, L in splats[:2])
    assert abs(float(film.splat.sum()) / j_sum - 1) < 1e-4


def test_render_mlt_mean_like_jax(scenes, jax_mlt):
    _, _, ts, tc = scenes
    jimg, jb = jax_mlt[:2]
    timg, tb = tmlt.render_mlt(ts, tc, W, H, n_chains=CHAINS,
                               mutations_per_chain=MUTATIONS,
                               n_bootstrap=BOOT, max_depth=DEPTH)
    timg = timg.numpy()
    assert np.isfinite(timg).all() and (timg >= 0).all()
    assert jimg.mean() > 0 and abs(timg.mean() / jimg.mean() - 1) < 0.01


def test_uniforms_stand_in_for_every_sampler_dimension(monkeypatch):
    """With uniforms, trace_paths never calls the sampler, in a scene that
    reads the camera's, the bounces' (mix, hair), the BSSRDF probe's and
    the "all" strategy's dimensions; the pass is finite and lit."""
    job = TAPI("cpu").parse_string(ALL_DIMS)
    sc = job.scene
    assert sc.has_sss and sc.has_hair and sc.has_mix and sc.n_lights == 3

    def no_sampler(*a, **k):
        raise AssertionError("the sampler was called")

    monkeypatch.setattr(tpath, "sample_dim", no_sampler)
    n = 256
    D = tmlt.n_dims(DEPTH)
    u = torch.as_tensor(np.random.RandomState(4).rand(n, D),
                        dtype=torch.float32)
    g = torch.linspace(-1.0, 1.0, 16)
    gx, gy = torch.meshgrid(g, g, indexing="ij")
    d = tgeom.normalize(torch.stack([gx.reshape(-1), gy.reshape(-1),
                                     torch.full((n,), 2.0)], -1))
    ray = tgeom.Ray.make(torch.tensor([[0.0, 0.0, -4.0]]).expand(n, 3), d)
    pid = torch.zeros(n, dtype=torch.int64)
    L = tpath.trace_paths(sc, ray, pid, pid, None, max_depth=DEPTH,
                          light_strategy="all", uniforms=u)
    assert torch.isfinite(L).all() and float(L.sum()) > 0
