"""Where the time of one render pass goes, on the card.

    python -m pbrt_tpu_torch.tools.profile_pass scene.pbrt [--rays 65536]
        [--maxdepth N] [--top 12] [--sampler refsobol]

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
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.integrators import dispatch, path, refpath
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.parser.api import parse_scene
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import pbrt as cli
from pbrt_tpu_torch.tools.kernel_workloads import device_us


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_pass")
    ap.add_argument("scene")
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--sampler", default=None, choices=["refsobol"])
    args = ap.parse_args(argv)
    device = devmod.resolve(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
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
