"""The operations one render pass launches, by component.

    python -m pbrt_tpu_torch.tools.launch_components scene.pbrt
        [--rays 65536] [--width W --height H] [--cpu] [--grad]

Parses the scene (on the first CUDA card, or the CPU with --cpu), traces
one pass with its integrator as `run_job` does (sample 0 of the first
`--rays` pixels of a
film of the scene's size, or of --width x --height) under a
TorchDispatchMode that counts every ATen operation that computes (views
and aliases excluded: they launch nothing), and prints the counts by the
component whose function issued them: the innermost of the functions in
COMPONENTS on the Python stack; a texture lookup is named with its
caller's component too.  The dense intersector's kernels (K1, K2) are
ctypes launches, counted by their wrappers' LAUNCHES, and on the CPU
their plain versions' operations fall under "intersect".

A scene whose integrator is lighttracer, bdpt, sppm or mlt counts one
unit of its driver instead (light_side_unit): a photon pass of --rays
photons, a bdpt pass of --rays camera rays, an SPPM iteration (a camera
pass over the film and --rays photons) or an MLT mutation step of --rays
chains; the SPPM photon gather is its own component.

With --grad the pass is the forward of a gradient step instead
(`diff.render_loss` of mat_kd and light_L against a black target), and
the operations of its backward (`autograd.grad`) are counted as one
more component, "backward": autograd runs them with no frame of the
forward's functions on the stack.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.integrators import (bdpt, diff, dispatch, lighttracer,
                                        mlt, path, sppm)
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.parser.api import parse_scene
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import pbrt as cli

# (module suffix, function) -> component; the innermost match names an op
COMPONENTS = {
    ("textures.textures", "eval_texture"): "texture lookups",
    ("lights.lights", None): "lights",
    ("lights.distrib", None): "light selection",
    ("materials.bsdf", "eval_f"): "eval_f",
    ("materials.bsdf", "pdf_f"): "pdf_f",
    ("materials.bsdf", "sample_f"): "sample_f",
    ("materials.bsdf", "gather_materials"): "gather_materials",
    ("materials.bsdf", "bump_shading_normal"): "bump",
    ("samplers.samplers", None): "sampler",
    ("ops.intersect", "make_hit"): "make_hit",
    ("ops.intersect", None): "intersect",
    ("ops.dense_intersect", None): "intersect",
    ("media.media", None): "media tracking",
    ("ops.intersect", "intersect_tr_walk"): "shadow walk",
    ("integrators.path", "camera_ray_differentials"): "differentials",
    ("integrators.path", "_specular_differentials"): "differentials",
    ("cameras.projective", None): "camera",
    ("cameras.lens", None): "camera",
    ("integrators.sppm", "gather"): "photon gather",
}
_VIEWS = {"view", "_unsafe_view", "reshape", "expand", "slice", "select",
          "unsqueeze", "squeeze", "t", "permute", "as_strided", "detach",
          "alias", "transpose", "unbind", "split", "split_with_sizes",
          "lift_fresh", "_to_copy_noop", "numpy_T"}


def _component(frame):
    """The components of the stack above `frame`, innermost first."""
    found = []
    while frame is not None:
        mod = frame.f_globals.get("__name__", "")
        if mod.startswith("pbrt_tpu_torch."):
            sub = mod[len("pbrt_tpu_torch."):]
            name = (COMPONENTS.get((sub, frame.f_code.co_name))
                    or COMPONENTS.get((sub, None)))
            if name and (not found or found[-1] != name):
                found.append(name)
                if len(found) == 2:
                    break
        frame = frame.f_back
    if not found:
        return "path (the rest)"
    if found[0] == "texture lookups" and len(found) > 1:
        return f"texture lookups ({found[1]})"
    return found[0]


class OpCounter(TorchDispatchMode):
    """Counts the computing ATen operations by component."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.label = None          # a fixed component for every operation

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name not in _VIEWS:
            self.counts[self.label or _component(sys._getframe(1))] += 1
        return func(*args, **(kwargs or {}))


def light_side_unit(kind, scene, camera, cfg, width, height, depth, rays):
    """fn() running one unit of a light-side integrator at sample 0 (the
    module docstring); MLT's bootstrap of `rays` paths runs here, outside
    the unit."""
    dev = scene.device
    ids = torch.arange(rays, device=dev)
    if kind == "lighttracer":
        film = filmmod.make_film(width, height, device=dev)
        trace = lighttracer.make_trace_lighttracer(camera, width, height)
        return lambda: trace(scene, film, ids, torch.zeros_like(ids), cfg,
                             depth)
    if kind == "bdpt":
        film = filmmod.make_film(width, height, device=dev)
        return lambda: bdpt.trace_pass(scene, camera, film, cfg, ids, 0,
                                       depth)
    if kind == "sppm":
        radius = torch.full((width * height,),
                            float(scene.world_radius) * 0.01, device=dev)

        def iteration():
            _, vp_p, _, vp_ok, _ = sppm.camera_pass(
                scene, camera, width, height, cfg, 0, depth)
            sppm.photon_pass(scene, cfg, 0, rays, depth, vp_p, vp_ok, radius)
        return iteration
    b, state = mlt.bootstrap(scene, camera, width, height, rays, rays, depth)
    film = filmmod.make_film(width, height, device=dev)
    return lambda: mlt.mutate_step(scene, camera, film, state, 1, b, 0.01,
                                   0.3, depth)


def count_pass(job, rays, width, height, device, grad=False):
    """{component: operations} of one pass of `rays` camera rays (with
    grad: a gradient step's forward and backward; a light-side
    integrator's unit, light_side_unit), and the dense kernels'
    launches."""
    camera = cli.build_camera(job, width, height, device)
    cfg = SamplerConfig(job.sampler_kind, 0, job.spp)
    if job.integrator_kind in dispatch.LIGHT_SIDE:
        unit = light_side_unit(job.integrator_kind, job.scene, camera, cfg,
                               width, height,
                               job.integrator_params["maxdepth"], rays)
        dense.reset_launch_counts()
        counter = OpCounter()
        with counter:
            unit()
        return counter.counts, dict(dense.LAUNCHES)
    trace, kw, depth = dispatch.integrator_trace(
        job, camera, width, height, job.integrator_params["maxdepth"])
    trace = trace or path.trace_paths
    ids = torch.arange(rays, device=device)
    opts, use_rd = path.trace_options(job.scene, camera, trace)
    opts.update(kw)
    dense.reset_launch_counts()
    counter = OpCounter()
    if grad:
        p = {k: getattr(job.scene, k).clone().requires_grad_(True)
             for k in ("mat_kd", "light_L")}
        with counter:
            loss = diff.render_loss(
                p, job.scene, camera, width, height, cfg, ids, (0,),
                torch.zeros(rays, 31, device=device), depth)
            counter.label = "backward"
            torch.autograd.grad(loss, list(p.values()))
        return counter.counts, dict(dense.LAUNCHES)
    with counter:
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            camera, width, height, cfg, ids, 0)
        if use_rd:
            opts["ray_diff"] = path.camera_ray_differentials(
                camera, width, height, cfg, pid, sidx,
                path.generate_fn(camera), job.spp)
        trace(job.scene, ray, pid, sidx, cfg, max_depth=depth, **opts)
    return counter.counts, dict(dense.LAUNCHES)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="launch_components")
    ap.add_argument("scene")
    ap.add_argument("--rays", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--grad", action="store_true")
    args = ap.parse_args(argv)
    device = devmod.resolve("cpu" if args.cpu else None)
    job = parse_scene(args.scene, device=device)
    W = args.width or job.film_width
    H = args.height or job.film_height
    rays = min(args.rays or 65536, W * H)
    counts, launches = count_pass(job, rays, W, H, device, grad=args.grad)
    total = sum(counts.values())
    print(f"{args.scene} at {W}x{H}, {rays} rays, on {device}: {total} "
          f"operations; dense kernel launches {launches}")
    for name, n in counts.most_common():
        print(f"  {n:8d} {100 * n / total:5.1f}%  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
