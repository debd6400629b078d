"""What the motion table costs a scene whose triangles do not move.

    python -m pbrt_tpu_torch.tools.motion_table_cost scene.pbrt [--rays N]

Once any mesh of a scene moves, every triangle goes into the motion
table (an unmoving one with its static entry as plane 0 and exact zeros
as planes 1-3) and K2 motion runs over all of them: the chunks whose
triangles are all unmoving (`chunk_static`) with the static body, the
others through Horner in the ray's time.  This parses a static scene on
the first CUDA card, captures the batches that the first two intersect
calls of one pass hand the dense intersector (camera rays; bounce-1 rays
with bounce-0 shadow rays), and times by CUDA events, on the same chunk
lists, the static K2 on the scene's table against K2 motion on a
zero-motion table of the same triangles, told its chunks are static (as
a scene gives them) and told none is (every chunk through Horner).  Both
must give the static K2's (t, prim) bit for bit.  Needs a card: it
raises without one.
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

    def record(r16, tmax, W_, cb, chunk_static, time=None):
        if len(batches) < 2:
            batches.append((r16.clone(), tmax.clone()))
        return inner(r16, tmax, W_, cb, chunk_static, time=time)

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
    st = torch.as_tensor(tab["chunk_static"], device=device)
    if not bool(st.all()):
        raise AssertionError("a zero-motion table has a moving chunk")
    if not torch.equal(torch.as_tensor(tab["chunk_bounds"], device=device),
                       scene.dense_cb):
        raise AssertionError("zero-motion chunk boxes differ from static")
    print(f"{args.scene}: {scene.tri_v0.shape[0]} triangles, on {card}")
    for name, (r16, tmax) in zip(("camera", "bounce1"), batches):
        cl, na = dense.tile_chunk_lists(r16, tmax, scene.dense_cb)
        tm = torch.full_like(tmax, 0.5)
        want = dense.loop_hits(r16, tmax, scene.dense_w, cl, na)
        none = torch.zeros_like(st)
        for told in (st, none):
            got = dense.loop_hits_motion(r16, tmax, tm, Wm, cl, na, told)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name}: K2 motion on the zero-motion "
                                     "table differs from static K2")
        ms_s = _time_ms(lambda: dense.loop_hits(r16, tmax, scene.dense_w,
                                                cl, na))
        ms_m = _time_ms(lambda: dense.loop_hits_motion(r16, tmax, tm, Wm,
                                                       cl, na, st))
        ms_h = _time_ms(lambda: dense.loop_hits_motion(r16, tmax, tm, Wm,
                                                       cl, na, none))
        print(f"{name}: B={r16.shape[0]} static K2 {ms_s:.4f} ms, K2 "
              f"motion on a zero-motion table {ms_m:.4f} ms "
              f"({ms_m / ms_s:.2f}x; every chunk through Horner "
              f"{ms_h:.4f} ms, {ms_h / ms_s:.2f}x), (t, prim) equal bit "
              "for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
