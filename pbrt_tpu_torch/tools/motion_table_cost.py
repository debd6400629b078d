"""What the motion table costs a scene whose triangles do not move.

    python -m pbrt_tpu_torch.tools.motion_table_cost scene.pbrt [--rays N]

Once any mesh of a scene moves, every triangle goes into the motion
table (the static ones with zero higher planes) and K2 motion runs over
all of them.  This parses a static scene on the first CUDA card,
captures the batches that the first two intersect calls of one pass
hand the dense intersector (camera rays; bounce-1 rays with bounce-0
shadow rays), and times by CUDA events, on the same chunk lists, the
static K2 on the scene's table against K2 motion on a zero-motion table
of the same triangles.  Plane 0 of that table holds the static entries,
so the prims must agree.  Needs a card: it raises without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.integrators import path
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.parser.api import parse_scene
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import pbrt as cli


def _time_ms(fn, reps=20):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(prog="motion_table_cost")
    ap.add_argument("scene")
    ap.add_argument("--rays", type=int, default=65536)
    args = ap.parse_args(argv)
    device = devmod.resolve(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    job = parse_scene(args.scene, device=device)
    scene = job.scene
    if scene.dense_motion:
        raise SystemExit(f"{args.scene}: a mesh moves; give a static scene")
    W, H = job.film_width, job.film_height
    camera = cli.build_camera(job, W, H, device)
    cfg = SamplerConfig("sobol", 0, job.spp)

    batches = []
    inner = dense.dense_intersect_loop

    def record(r16, tmax, W_, cb, time=None):
        if len(batches) < 2:
            batches.append((r16.clone(), tmax.clone()))
        return inner(r16, tmax, W_, cb, time=time)

    dense.dense_intersect_loop = record
    try:
        ids = torch.arange(args.rays, device=device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(camera, W, H, cfg,
                                                           ids, 0)
        path.trace_paths(scene, ray, pid, sidx, cfg,
                         max_depth=job.integrator_params["maxdepth"])
    finally:
        dense.dense_intersect_loop = inner

    tab = dense.build_dense_tables_motion(
        scene.tri_v0.cpu().numpy(), scene.tri_e1.cpu().numpy(),
        scene.tri_e2.cpu().numpy(), np.zeros((scene.tri_v0.shape[0], 12)),
        chunk=scene.dense_chunk)
    Wm = torch.as_tensor(tab["W"], device=device)
    if not torch.equal(torch.as_tensor(tab["chunk_bounds"], device=device),
                       scene.dense_cb):
        raise AssertionError("zero-motion chunk boxes differ from static")
    print(f"{args.scene}: {scene.tri_v0.shape[0]} triangles, on {card}")
    for name, (r16, tmax) in zip(("camera", "bounce1"), batches):
        cl, na = dense.tile_chunk_lists(r16, tmax, scene.dense_cb)
        tm = torch.full_like(tmax, 0.5)
        _, p_s = dense.loop_hits(r16, tmax, scene.dense_w, cl, na)
        _, p_m = dense.loop_hits_motion(r16, tmax, tm, Wm, cl, na)
        agree = (p_s == p_m).float().mean().item()
        if agree < 0.999:
            raise AssertionError(f"{name}: prim agree {agree}")
        ms_s = _time_ms(lambda: dense.loop_hits(r16, tmax, scene.dense_w,
                                                cl, na))
        ms_m = _time_ms(lambda: dense.loop_hits_motion(r16, tmax, tm, Wm,
                                                       cl, na))
        print(f"{name}: B={r16.shape[0]} static K2 {ms_s:.4f} ms, K2 "
              f"motion on a zero-motion table {ms_m:.4f} ms "
              f"({ms_m / ms_s:.2f}x), prim agree {agree:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
