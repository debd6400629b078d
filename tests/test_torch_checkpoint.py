"""The port's film checkpoint and resume (film/checkpoint.py, render's
checkpoint options) against pbrt_tpu's (CPU, 16x16).

tests/test_checkpoint.py's four cases on the port, plus: both packages
fingerprint the same render alike, and a checkpoint pbrt_tpu writes at 2
spp resumes in the port to 4 spp.  Tolerances: resume is bit for bit on
the CPU (the samplers are pure functions of pixel, sample and
dimension); the cross-package resume is held to test_torch_path.py's
port-against-JAX render tolerance (image mean within 1%, >= 95% of
pixels within 1e-2 relative), since a few paths take another triangle
in each package's intersector.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.film import checkpoint as jckpt
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.film import checkpoint as ckpt
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

W = H = 16
DEPTH = 3
FIELDS = ("weighted", "weight", "raw", "splat")


@pytest.fixture(scope="module")
def setup():
    scene, cam_ctor = tflag.cornell(device="cpu")
    return scene, cam_ctor(W, H), TCfg("sobol", 0, 4)


def film():
    return tfilm.make_film(W, H, "gaussian", device="cpu")


def render(setup, spp, **kw):
    scene, cam, cfg = setup
    return tpath.render(scene, cam, film(), cfg, spp, max_depth=DEPTH, **kw)


def assert_films_equal(a, b):
    for k in FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_resume_is_bit_identical(setup, tmp_path):
    scene, _, cfg = setup
    ref = render(setup, 4)
    cp = str(tmp_path / "film.ckpt")
    part = render(setup, 2, checkpoint_path=cp, checkpoint_every=0.0)
    # rewrite the 2-spp checkpoint under the 4-spp render's fingerprint,
    # as a stopped 4-spp render would have written it
    ckpt.save(cp, part, 2, ckpt.render_fingerprint(scene, cfg, 4, DEPTH, W,
                                                   H))
    calls = []
    out = render(setup, 4, checkpoint_path=cp, checkpoint_every=1e9,
                 progress=lambda done, total: calls.append((done, total)))
    assert_films_equal(out, ref)
    # resumed at sample 2: passes 3 and 4 of 4
    assert calls == [(3, 4), (4, 4)]
    with np.load(cp) as z:
        assert int(z["completed_spp"]) == 4


def test_mismatched_fingerprint_starts_fresh(setup, tmp_path):
    scene, _, cfg = setup
    cp = str(tmp_path / "film.ckpt")
    f = film()
    f.weighted.fill_(1.0)
    ckpt.save(cp, f, 3, "deadbeefdeadbeef")
    fresh = film()
    restored, spp_done = ckpt.load(
        cp, fresh, ckpt.render_fingerprint(scene, cfg, 4, DEPTH, W, H))
    assert spp_done == 0
    assert_films_equal(restored, film())


def test_corrupt_checkpoint_starts_fresh(setup, tmp_path):
    scene, _, cfg = setup
    cp = str(tmp_path / "film.ckpt")
    with open(cp, "wb") as f:
        f.write(b"not a checkpoint")
    restored, spp_done = ckpt.load(
        cp, film(), ckpt.render_fingerprint(scene, cfg, 4, DEPTH, W, H))
    assert spp_done == 0
    assert_films_equal(restored, film())


def test_completed_checkpoint_skips_render(setup, tmp_path):
    cp = str(tmp_path / "film.ckpt")
    ref = render(setup, 2, checkpoint_path=cp, checkpoint_every=1e9)
    # the same render again resumes at completed == spp: no pass runs
    calls = []
    again = render(setup, 2, checkpoint_path=cp, checkpoint_every=1e9,
                   progress=lambda done, total: calls.append(done))
    assert calls == []
    assert_films_equal(again, ref)


def test_shape_mismatch_starts_fresh(setup, tmp_path):
    scene, _, cfg = setup
    cp = str(tmp_path / "film.ckpt")
    fp = ckpt.render_fingerprint(scene, cfg, 4, DEPTH, W, H)
    ckpt.save(cp, tfilm.make_film(W, H + 1, "gaussian", device="cpu"), 2, fp)
    _, spp_done = ckpt.load(cp, film(), fp)
    assert spp_done == 0


def test_fingerprint_equals_jax():
    """flagship.cornell()'s scene columns are pbrt_tpu's bytes, so both
    packages fingerprint every render of it alike."""
    js, _ = jflag.cornell()
    ts, _ = tflag.cornell(device="cpu")
    for args in ((4, DEPTH, W, H), (2, 5, 32, 16)):
        assert (ckpt.render_fingerprint(ts, TCfg("sobol", 0, 4), *args)
                == jckpt.render_fingerprint(js, JCfg("sobol", 0, 4), *args))
    assert ckpt.render_fingerprint(ts, TCfg("halton", 0, 4), 4, DEPTH, W,
                                   H) != ckpt.render_fingerprint(
        ts, TCfg("sobol", 0, 4), 4, DEPTH, W, H)


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path):
    """pbrt_tpu renders 4 spp with a checkpoint after every sample; the
    file as it stands after its second sample (a render stopped there)
    resumes in the port to 4 spp.  The port's film holds pbrt_tpu's two
    samples exactly, and the result matches pbrt_tpu's uninterrupted
    render within the port-vs-JAX render tolerance (module docstring).
    One pbrt_tpu render: each render call compiles its pass (~20 s)."""
    import shutil
    scene, cam, cfg = setup
    js, jcam_ctor = jflag.cornell()
    jcfg = JCfg("sobol", 0, 4)
    jcp, cp = str(tmp_path / "jax.ckpt"), str(tmp_path / "film.ckpt")

    def keep_two(done, total):
        # pass 3 starts after sample index 1's save: 2 completed spp
        if done == 3:
            shutil.copy(jcp, cp)
    jref = jpath.render(js, jcam_ctor(W, H), jfilm.make_film(W, H,
                                                            "gaussian"),
                        jcfg, spp=4, max_depth=DEPTH, progress=keep_two,
                        checkpoint_path=jcp, checkpoint_every=0.0)
    restored, done = ckpt.load(
        cp, film(), ckpt.render_fingerprint(scene, cfg, 4, DEPTH, W, H))
    assert done == 2
    with np.load(cp) as z:
        for k in FIELDS:
            assert np.array_equal(getattr(restored, k).numpy(), z[k]), k
    out = render(setup, 4, checkpoint_path=cp)
    ti = tfilm.develop_spectral(out).numpy()
    ji = np.asarray(jfilm.develop_spectral(jref))
    assert abs(ti.mean() / ji.mean() - 1) < 1e-2
    tl, jl = ti.sum(-1), ji.sum(-1)
    assert (np.abs(tl - jl) <= 1e-2 * np.abs(jl)).mean() >= 0.95


def test_render_stats_counters(setup):
    """render(stats=) records trace_paths' counts under the JAX package's
    names, and their closest + shadow sum is render(count_rays=True)'s."""
    from pbrt_tpu_torch.utils.stats import Stats
    st = Stats()
    a = render(setup, 2, stats=st)
    b, n_rays = render(setup, 2, count_rays=True)
    assert_films_equal(a, b)
    c = st.counters
    assert c["Integrator/Camera rays traced"] == 2 * W * H
    assert (c["Intersections/Regular ray intersection tests"]
            + c["Intersections/Shadow ray intersection tests"]) == n_rays
    num, den = st.ratios["Integrator/Path length"]
    assert num == c["Integrator/Path vertices shaded"] and den == 2 * W * H
