"""Where the time of one render pass, or one gradient step, goes on the
card.

    python -m pbrt_tpu_torch.tools.profile_pass scene.pbrt [--rays 65536]
        [--maxdepth N] [--top 12] [--sampler refsobol]
    python -m pbrt_tpu_torch.tools.profile_pass (scene.pbrt | cornell)
        --grad [--rays 65536] [--maxdepth N] [--top 12]

Parses the scene on the first CUDA card, traces one pass (sample 0 of
the first `--rays` pixels, through `path.trace_paths` with the texture
footprint, camera ray differentials and light strategy `run_job` gives
it; with
`--sampler refsobol`, of the first min(rays, W*H) pixels through the
matched-RNG `refpath.trace_ref`, as `render_ref` traces a pass) three times
unprofiled and once under torch.profiler, and prints: the wall time of
each unprofiled pass; for the profiled one, its wall time, the device
kernel events and their summed device time, the device's idle share
(1 - device time / wall time), the launches of the dense kernels, and
the kernels that took the most device time.  Needs a card: it raises
without one.

With --grad it profiles one step of `diff.make_train_step` instead
(`cornell` is the Cornell model of `models/flagship.py` at 256x256,
Sobol, depth 5, the benchmark cell): the parameters mat_kd and light_L
start at 0.5 and 0.7 of the scene's values and the target is
`diff.render_samples` at the scene's own, for sample 0 of the first
`--rays` pixels.  After two unprofiled steps it prints the peak device
memory of a third (max_memory_allocated, its peak statistics reset just
before), then traces one more step's forward (`render_loss`) and backward
(`autograd.grad`, the Adam update and the clamp) under torch.profiler,
each alone, and prints their wall time, device kernel events, device
time and the dense kernels' launches, and the step's idle share.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.integrators import diff, dispatch, path, refpath
from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.parser.api import parse_scene
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import pbrt as cli
from pbrt_tpu_torch.tools.kernel_workloads import device_us


def _device_events(prof):
    """(device ms, kernel launches) of a profile's device kernels."""
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    return (sum(device_us(e) for e in ev) / 1e3,
            sum(e.count for e in ev), ev)


def grad_problem(scene, camera, W, H, cfg, rays, depth):
    """The inverse-rendering problem --grad profiles: (start params,
    target, pixel ids) for mat_kd and light_L at 0.5 and 0.7 of the
    scene's values, the target rendered at the scene's own at sample 0."""
    ids = torch.arange(rays, device=scene.device)
    truth = {"mat_kd": scene.mat_kd, "light_L": scene.light_L}
    with torch.no_grad():
        target, _ = diff.render_samples(truth, scene, camera, W, H, cfg,
                                        ids, 0, max_depth=depth)
    start = {"mat_kd": scene.mat_kd * 0.5, "light_L": scene.light_L * 0.7}
    return start, target, ids


def profile_train_step(scene, camera, W, H, cfg, params, target, ids,
                       depth, learning_rate=0.05):
    """One make_train_step step, split into its forward and its backward,
    each under torch.profiler, after two unprofiled steps and one whose
    peak memory is read.  Returns a dict: fwd / bwd (wall ms, device ms,
    launches, the device kernel events, dense launches), idle share of
    the step, peak_mib (the step's peak allocation) and above_mib (its
    peak above what was allocated before it)."""
    init, step = diff.make_train_step(scene, camera, W, H, cfg, target,
                                      max_depth=depth,
                                      learning_rate=learning_rate)
    state = init(params)
    for _ in range(2):
        params, state, _ = step(params, state, ids, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, state, _ = step(params, state, ids, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"peak_mib": peak / 2 ** 20, "above_mib": (peak - base) / 2 ** 20}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def traced(fn):
        dense.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return res, (wall,) + _device_events(prof) + (dict(dense.LAUNCHES),)

    (p, loss), out["fwd"] = traced(lambda: step.forward(params, ids, 0))
    _, out["bwd"] = traced(lambda: step.backward(p, loss, state))
    out["idle"] = 1 - (out["fwd"][1] + out["bwd"][1]) / (
        out["fwd"][0] + out["bwd"][0])
    return out


def _grad_main(args, card, device):
    if args.scene == "cornell":
        scene, cam_ctor = flagship.cornell(device=device)
        W = H = 256
        camera = cam_ctor(W, H)
        cfg = SamplerConfig("sobol", 0, 4)
        depth = args.maxdepth or 5
    else:
        job = parse_scene(args.scene, device=device)
        scene, W, H = job.scene, job.film_width, job.film_height
        camera = cli.build_camera(job, W, H, device)
        cfg = SamplerConfig(job.sampler_kind, 0, job.spp)
        depth = args.maxdepth or job.integrator_params["maxdepth"]
    rays = min(args.rays, W * H)
    params, target, ids = grad_problem(scene, camera, W, H, cfg, rays,
                                       depth)
    r = profile_train_step(scene, camera, W, H, cfg, params, target, ids,
                           depth)
    print(f"{args.scene} --grad: {rays} rays, depth {depth}, params "
          f"mat_kd light_L, on {card}")
    print(f"step peak memory {r['peak_mib']:.1f} MiB ({r['above_mib']:.1f} "
          f"MiB above what was allocated before it)")
    for name in ("fwd", "bwd"):
        wall, dev_ms, n, ev, launches = r[name]
        print(f"{name}: {wall:.2f} ms wall, {n} device kernel events, "
              f"{dev_ms:.2f} ms device time, dense launches {launches}")
        for e in sorted(ev, key=device_us, reverse=True)[:args.top]:
            print(f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d} calls "
                  f"{100 * device_us(e) / 1e3 / dev_ms:5.1f}%  "
                  f"{e.key[:90]}")
    print(f"step idle share {r['idle']:.3f}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_pass")
    ap.add_argument("scene")
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--sampler", default=None, choices=["refsobol"])
    ap.add_argument("--grad", action="store_true")
    args = ap.parse_args(argv)
    device = devmod.resolve(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if args.grad:
        return _grad_main(args, card, device)
    job = parse_scene(args.scene, device=device)
    W, H = job.film_width, job.film_height
    camera = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig(job.sampler_kind, 0, job.spp)
    depth = args.maxdepth or job.integrator_params["maxdepth"]
    if args.sampler == "refsobol":
        ids = torch.arange(min(args.rays, W * H), device=device)
        sampler = refpath.RefSampler.make(W, H)
        lights = refpath.build_ref_lights(job.scene)

        def trace():
            ray, _, _, pid, sidx = refpath.camera_rays_ref(camera, W, H,
                                                           sampler, ids, 0)
            refpath.trace_ref(job.scene, lights, sampler, ray, pid, sidx,
                              max_depth=depth)
    else:
        ids = torch.arange(args.rays, device=device)
        opts, use_rd = path.trace_options(job.scene, camera,
                                          path.trace_paths)
        opts["light_strategy"] = dispatch.light_strategy(
            job.integrator_params)

        def trace():
            ray, _, _, pid, sidx = path.camera_rays_for_pixels(
                camera, W, H, cfg, ids, 0)
            kw = dict(opts)
            if use_rd:
                kw["ray_diff"] = path.camera_ray_differentials(
                    camera, W, H, cfg, pid, sidx, path.generate_fn(camera),
                    job.spp)
            path.trace_paths(job.scene, ray, pid, sidx, cfg, max_depth=depth,
                             **kw)

    def one_pass():
        trace()
        torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_pass()
        walls.append((time.perf_counter() - t0) * 1e3)
    dense.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_pass()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    dev_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f"{args.scene}: {len(ids)} rays, depth {depth}, sampler "
          f"{args.sampler or job.sampler_kind}, on {card}")
    print("unprofiled passes: " + ", ".join(f"{w:.2f} ms" for w in walls))
    if not kernels:
        print("profiled pass: no device time in the trace (not measured)")
        return 1
    print(f"profiled pass: {wall:.2f} ms wall, "
          f"{sum(e.count for e in kernels)} device kernel events, "
          f"{dev_ms:.2f} ms device time, idle share "
          f"{1 - dev_ms / wall:.3f}, dense launches {dict(dense.LAUNCHES)}")
    for e in sorted(kernels, key=device_us, reverse=True)[:args.top]:
        print(f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d} calls "
              f"{100 * device_us(e) / 1e3 / dev_ms:5.1f}%  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
