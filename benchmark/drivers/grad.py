"""Drive the inverse-rendering step of `pbrt_tpu_torch` as a user does:
`integrators.diff.make_train_step` over every pixel of the film, one
sample index a step (the next one each step), on the materials' diffuse
albedo and the area light's emission, started at 0.5 and 0.7 of the
scene's values, toward the image at the scene's own values: the plain
reference's render at the first step's sample index, made in set-up.

Set-up builds the step and its Adam state once, drives them through
their first steps, which are the warm-up, and the window goes on with
the same objects.  The check compares those first steps with the plain
reference's: each step's loss, each leaf's first gradient as Adam got it
(its first moment over 1 - b1), and each leaf's change over the steps.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from benchmark.reference import compare
from benchmark.reference import scene as rscene
from benchmark.seeds import grad_seed


@dataclasses.dataclass
class State:
    cell: dict
    traffic: dict
    device: torch.device
    seed: int
    sampler_seed: int
    step: object
    params: dict
    adam: dict
    pixels: torch.Tensor
    target: torch.Tensor
    width: int
    height: int
    depth: int
    setup_times: dict
    counts: dict
    index: int = 0
    first: dict = None


def setup(cell, seed, device):
    from pbrt_tpu_torch.integrators import diff
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import pbrt as cli

    tr = cell["traffic"]
    times = {}
    scene_file = os.path.join(cell["root"], cell["config_data"]["scene"])
    t0 = time.perf_counter()
    job = parse_scene(scene_file, device=device)
    times["parse_build_s"] = time.perf_counter() - t0
    W, H = tr["width"], tr["height"]
    scene = job.scene
    camera = cli.build_camera(job, W, H, device)
    sampler_seed = grad_seed(seed)
    cfg = SamplerConfig(kind=job.sampler_kind, seed=sampler_seed, spp=1)
    t0 = time.perf_counter()
    target = compare.grad_target(rscene.parse(scene_file), sampler_seed, W,
                                 H, device)
    times["target_s"] = time.perf_counter() - t0
    depth = job.integrator_params["maxdepth"]
    init, step = diff.make_train_step(scene, camera, W, H, cfg, target,
                                      max_depth=depth,
                                      learning_rate=tr["learning_rate"])
    params = {"mat_kd": scene.mat_kd * tr["kd_scale"],
              "light_L": scene.light_L * tr["light_scale"]}
    st = State(cell=cell, traffic=tr, device=device, seed=seed,
               sampler_seed=sampler_seed, step=step, params=params,
               adam=init(params), pixels=torch.arange(W * H, device=device),
               target=target, width=W, height=H, depth=depth,
               setup_times=times,
               counts=dict(triangles=int((scene.prim_type == 0).sum()),
                           quadrics=int(scene.n_quadrics)))
    # the first steps, through the window's own call: the warm-up, and
    # what the check compares
    t0 = time.perf_counter()
    start = {k: v.clone() for k, v in params.items()}
    losses = []
    for k in range(tr["checked_steps"]):
        loss = _step(st)
        losses.append(float(loss))
        if k == 0:
            g1 = {n: float((m / (1 - 0.9)).double().norm())
                  for n, m in st.adam["mu"].items()}
    change = {n: float((st.params[n] - start[n]).double().norm())
              for n in start}
    st.first = dict(losses=losses, grad_norm=g1, change=change)
    times["warmup_s"] = time.perf_counter() - t0
    return st


def _step(st):
    st.params, st.adam, loss = st.step(st.params, st.adam, st.pixels,
                                       st.index)
    st.index += 1
    return loss


def window(st, seconds):
    """Steps until `seconds` have passed."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n = 0
    while time.perf_counter() < deadline:
        _step(st)
        n += 1
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return dict(units=n, seconds=time.perf_counter() - t0)


def unit(st):
    _step(st)


def spans(st):
    from pbrt_tpu_torch.ops import intersect

    return [("intersect", intersect, "intersect",
             lambda scene, ray, *a, **k: int(ray.o.shape[0])),
            ("backward", torch.autograd, "grad", None)]


def check(st):
    return compare.check_grad(st)
