"""The port's rendering split over ranks (parallel/mesh.py, multihost.py,
torch.distributed with gloo on the CPU) against one process's render and
pbrt_tpu's.

Each group meets through a file under tmp_path (parallel test workers
cannot collide on a port), and each subprocess has its own timeout.
Tolerances: one rank is bit for bit with `render`; two ranks' summed
film against pbrt_tpu's `path.render` of the same samples at rtol 1e-4,
atol 1e-5 (tests/test_sharding.py's), since the ranks' films are summed
in another f32 order; the sharded train step's loss and gradients within
1e-5 relative of one process's over the whole batch (the gradients
relative to their largest entry).
"""
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.models import flagship as jflag
from pbrt_tpu.samplers.samplers import SamplerConfig as JCfg
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrators import diff
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.models import flagship as tflag
from pbrt_tpu_torch.parallel import mesh
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TCfg
from test_torch_core import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("weighted", "weight", "raw")
TIMEOUT = 300


def launch(tmp_path, ranks, *args):
    """Start `ranks` multihost processes (gloo, CPU) meeting through a
    file under tmp_path."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'init'}"
    return [subprocess.Popen(
        [sys.executable, "-m", "pbrt_tpu_torch.parallel.multihost",
         "--init-method", init, "--world-size", str(ranks), "--rank",
         str(r), "--backend", "gloo", "--cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        for r in range(ranks)]


def finish(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_rank_pixel_ids_cover_each_pixel_once():
    for n_pix, world, per in ((256, 2, 128), (256, 3, 50), (100, 4, 1 << 16)):
        ids = np.concatenate([mesh.rank_pixel_ids(n_pix, world, r, per)[0]
                              for r in range(world)])
        assert np.array_equal(np.sort(ids[ids < n_pix]), np.arange(n_pix))
        assert (ids[ids >= n_pix] == 0xFFFFFFFF).all()


def test_one_rank_equals_render(tmp_path):
    """A group of one: render_sharded (two passes a sample) is render's
    film bit for bit."""
    scene, cam_ctor = tflag.cornell(device="cpu")
    cam, cfg = cam_ctor(16, 16), TCfg("sobol", 0, 2)
    ref = tpath.render(scene, cam, tfilm.make_film(16, 16, "gaussian",
                                                  device="cpu"),
                       cfg, 2, max_depth=3, max_rays_per_pass=128)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'g'}",
                            world_size=1, rank=0)
    try:
        timings = {}
        out = mesh.render_sharded(
            scene, cam, tfilm.make_film(16, 16, "gaussian", device="cpu"),
            cfg, 2, max_depth=3, rays_per_rank=128, timings=timings)
    finally:
        dist.destroy_process_group()
    assert timings["passes"] == 4
    for k in mesh.FILM_FIELDS:
        assert torch.equal(getattr(out, k), getattr(ref, k)), k


def test_two_ranks_match_jax_render(tmp_path):
    """parallel.multihost on two gloo ranks (16x16, 2 spp, depth 3, the
    quadric Cornell, a box film): the summed film against pbrt_tpu's
    render of the same samples."""
    out = str(tmp_path / "film.npz")
    procs = launch(tmp_path, 2, "--size", "16", "--spp", "2", "--out", out)
    try:
        js, jcam = jflag.cornell(tessellate=False)
        ref = jpath.render(js, jcam(16, 16), jfilm.make_film(16, 16, "box"),
                           JCfg("sobol", 0, 2), spp=2, max_depth=3)
    finally:
        outs = finish(procs)
    assert "MULTIHOST_OK" in outs[0] and "ranks=2 backend=gloo" in outs[0]
    assert all("ms a pass" in o for o in outs)
    with np.load(out) as z:
        for k in FIELDS:
            np.testing.assert_allclose(z[k], np.asarray(getattr(ref, k)),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        assert not z["splat"].any() and z["weighted"].sum() > 0


def test_sharded_train_step_matches_one_process(tmp_path):
    """dryrun_multichip's step on two gloo ranks (32 rays of the 64x64
    Cornell model, depth 2): loss and gradients against one process's
    render_loss over the whole batch, and the clamped SGD step."""
    out = str(tmp_path / "step.npz")
    procs = launch(tmp_path, 2, "--train-step", "--out", out)
    try:
        scene, cam_ctor = tflag.cornell(device="cpu")
        p = {"mat_kd": scene.mat_kd.clone().requires_grad_(True),
             "light_L": scene.light_L.clone().requires_grad_(True)}
        loss = diff.render_loss(p, scene, cam_ctor(64, 64), 64, 64,
                                TCfg("sobol", 0, 4), torch.arange(32), (0,),
                                torch.full((64 * 64, 31), 0.25), 2)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    finally:
        outs = finish(procs)
    assert "TRAIN_STEP_OK" in outs[0]
    with np.load(out) as z:
        np.testing.assert_allclose(z["loss"], loss.item(), rtol=1e-5)
        for k, g in grads.items():
            g = g.numpy()
            assert np.abs(g).max() > 0, k
            np.testing.assert_allclose(z[f"grad_{k}"], g, rtol=0,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=k)
            step = np.maximum(p[k].detach().numpy() - 0.1 * z[f"grad_{k}"],
                              0.0)
            assert np.array_equal(z[k], step), k
