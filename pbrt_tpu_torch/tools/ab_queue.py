"""K1 against another checkout's, on the card: the chunk lists bit for
bit, and each tree's K1 by the device time of its own kernels.

    python -m pbrt_tpu_torch.tools.ab_queue --against DIR [--rank-max N ...]
        [--rounds 3] [--reps 20] [--out DIR] [--cpu]

DIR is another checkout of this repository (for example the parent
commit, unpacked with `git archive` into a gitignored directory).  The
tool makes the inputs once, in this checkout: the main path's camera and
bounce-1 batches of the Cornell model and of
pbrt_tpu_torch/scenes/cornell_motion.pbrt (256x256, Sobol', 65,536 rays
per pass, depth 5: chip_smoke.py's phases 3-4), cornell_random (s1), the
cluster mesh's z40 rays (s3) and box_table (576 chunks): the kernel
workloads of tools/kernel_workloads.py.  Then it runs one worker process
per turn, in the order DIR, this, [the --rank-max copies,] this, DIR; each
imports its own tree's `pbrt_tpu_torch` and calls the two entry points
both trees have on every workload: `tile_chunk_lists` (the lists K2
reads) and `tile_queue` (the cull's hits and near).  Every turn times
them with this checkout's timing code (kernel_workloads, loaded from its
file): `device_ms`, the summed device time of the kernels one call
launches and their number, and `time_ms`, CUDA events around `--reps`
wrapper calls, which also hold the time the card waits on the host
between launches.  `--rank-max N` adds a turn of a copy of this
checkout whose csrc/dense_queue.cu orders a tile's hit chunks by
counting up to N of them and by the bitonic sort above (kRankMax = N:
0 sorts every tile, 576 counts in every tile).

It prints per workload each turn's lists' and cull's device ms, kernels
per call and event ms (median and min-max over the turns of a tree),
the bound of each (kernel_workloads.queue_bound) and its share, and
checks that every turn's lists equal this checkout's plain version's
(tile_chunk_lists_plain on the same CUDA tensors) bit for bit, and that
its hits equal the plain hits and its near lies within 1e-6 relative of
the plain near; any difference raises.  With --out it writes
DIR/summary.json.  With --cpu the workers run the plain versions at a
small size (host times, not device times), against this checkout itself
if DIR is not given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --- the worker: runs in its tree's environment; imports that tree's
# --- pbrt_tpu_torch, and this checkout's kernel_workloads for the timing

def _timing():
    """This checkout's kernel_workloads module, loaded from its file: its
    own imports resolve to the worker's tree."""
    spec = importlib.util.spec_from_file_location(
        "_ab_queue_timing", os.path.join(HERE, "pbrt_tpu_torch", "tools",
                                         "kernel_workloads.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


def worker(inp, out, rounds, reps):
    from pbrt_tpu_torch.ops import dense_intersect as dense
    kw = _timing()
    data = torch.load(inp)
    device = torch.device(data["device"])
    fns, res = {}, {}
    for name, w in data["workloads"].items():
        args = tuple(w[k].to(device) for k in ("r16", "tmax", "cb"))
        cl, na = dense.tile_chunk_lists(*args)
        hits, near = dense.tile_queue(*args)
        res[name] = {"cl": cl.cpu(), "na": na.cpu(), "hits": hits.cpu(),
                     "near": near.cpu(), "device": {}}
        fns[(name, "list")] = lambda a=args: dense.tile_chunk_lists(*a)
        fns[(name, "cull")] = lambda a=args: dense.tile_queue(*a)
    times = kw.interleaved(fns, rounds, reps, device)
    for (name, what), fn in fns.items():
        res[name][f"{what}_ms"] = times[(name, what)]
        if device.type == "cuda":
            res[name]["device"][what] = kw.device_ms(fn, reps)
    torch.save(res, out)


# --- the coordinator: runs in this checkout

def make_inputs(device, small):
    """{name: {"r16", "tmax", "cb"}} at full size (or small on the CPU)."""
    from pbrt_tpu_torch.models import flagship
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    from pbrt_tpu_torch.tools import pbrt as cli
    side, rays = (32, 1024) if small else (256, 65536)
    cfg = SamplerConfig("sobol", 0, 4)
    out = {}
    scene, cam = flagship.cornell(device=device)
    for k, (r16, tmax, _) in kw.main_path_batches(
            scene, cam(side, side), cfg, side, side, rays, 5).items():
        out[f"cornell {k}"] = dict(r16=r16, tmax=tmax, cb=scene.dense_cb)
    job = parse_scene(os.path.join(HERE, "pbrt_tpu_torch", "scenes",
                                   "cornell_motion.pbrt"), device=device)
    mcam = cli.build_camera(job, side, side, device)
    for k, (r16, tmax, _) in kw.main_path_batches(
            job.scene, mcam, cfg, side, side, rays, 5).items():
        out[f"motion {k}"] = dict(r16=r16, tmax=tmax, cb=job.scene.dense_cb)
    for wl in (kw.cornell_random(device, 0, 1024 if small else 131072,
                                 scene),
               kw.cluster_rays_z40(device, 0, 256 if small else 65536)):
        out[wl.name] = dict(r16=wl.r16, tmax=wl.tmax, cb=wl.chunk_bounds)
    r16, tmax, cb = kw.box_table(device, 0, n_rays=256 if small else 65536)
    out["box_table"] = dict(r16=r16, tmax=tmax, cb=cb)
    return out


def rank_tree(tmp, n):
    """A checkout in tmp that is this one (its other entries linked) but
    for a copy of the package whose csrc/dense_queue.cu sets kRankMax to
    n."""
    root = os.path.join(tmp, f"rank_max{n}")
    os.makedirs(root)
    for name in os.listdir(HERE):
        if name != "pbrt_tpu_torch":
            os.symlink(os.path.join(HERE, name), os.path.join(root, name))
    shutil.copytree(os.path.join(HERE, "pbrt_tpu_torch"),
                    os.path.join(root, "pbrt_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, "pbrt_tpu_torch", "csrc", "dense_queue.cu")
    with open(path) as f:
        text, k = re.subn(r"constexpr int kRankMax = \d+;",
                          f"constexpr int kRankMax = {n};", f.read())
    if k != 1:
        raise SystemExit("ab_queue: csrc/dense_queue.cu does not define "
                         "kRankMax once")
    with open(path, "w") as f:
        f.write(text)
    return root


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ab_queue", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--against", help="another checkout of the repository")
    ap.add_argument("--rank-max", type=int, nargs="*", default=[],
                    help="also time copies of this checkout with these "
                         "kRankMax")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="directory for summary.json")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--worker", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _spread(v):
    return f"{float(np.median(v)):.4f} [{min(v):.4f}-{max(v):.4f}]"


def run(args):
    from pbrt_tpu_torch.core import device as devmod
    from pbrt_tpu_torch.ops import dense_intersect as dense
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    device = devmod.resolve("cpu" if args.cpu else None)
    other = os.path.abspath(args.against) if args.against else HERE
    if device.type == "cuda" and other == HERE:
        raise SystemExit("ab_queue: --against DIR is needed on the card")
    card = kw.card_name(device)
    data = make_inputs(device, device.type != "cuda")
    tmp = tempfile.mkdtemp(prefix="ab_queue_")
    inp = os.path.join(tmp, "inputs.pt")
    torch.save({"device": str(device), "workloads": {
        n: {k: v.cpu() for k, v in w.items()} for n, w in data.items()}},
        inp)
    turns = [("other", other), ("this", HERE)]
    turns += [(f"kRankMax={n}", rank_tree(tmp, n)) for n in args.rank_max]
    turns += [("this", HERE), ("other", other)]
    res = []
    for i, (who, tree) in enumerate(turns):
        out = os.path.join(tmp, f"turn{i}.pt")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", inp,
               out, "--rounds", str(args.rounds), "--reps", str(args.reps)]
        env = dict(os.environ, PYTHONPATH=tree)
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=tree, env=env, check=True, timeout=1800)
        print(f"turn {i}: {who} ({tree}) in {time.perf_counter() - t0:.1f} "
              "s")
        res.append((who, torch.load(out)))
    shutil.rmtree(tmp)
    print(f"ab_queue on {card}: {args.rounds} rounds x {args.reps} calls "
          f"per turn, turns {', '.join(w for w, _ in turns)}")
    summary = {}
    for name, w in data.items():
        cl_p, na_p = dense.tile_chunk_lists_plain(w["r16"], w["tmax"],
                                                  w["cb"])
        hits_p, near_p = dense.tile_queue_plain(w["r16"], w["tmax"],
                                                w["cb"])
        cl_p, na_p, hits_p, near_p = (x.cpu() for x in (cl_p, na_p, hits_p,
                                                        near_p))
        for who, r in res:
            r = r[name]
            if not (torch.equal(r["cl"], cl_p) and torch.equal(r["na"],
                                                               na_p)):
                raise AssertionError(f"{name}: {who}'s lists differ from "
                                     "the plain version's")
            rel = ((r["near"] - near_p).abs()
                   / near_p.abs().clamp(min=1e-30))[hits_p]
            if not torch.equal(r["hits"], hits_p) or (
                    rel.numel() and rel.max().item() > 1e-6):
                raise AssertionError(f"{name}: {who}'s cull differs from "
                                     "the plain version's")
        n_tiles, C = cl_p.shape
        live = int((w["tmax"] > 0).sum())
        bounds = {m: kw.queue_bound(m, w["r16"], w["tmax"], w["cb"])
                  for m in ("list", "cull")}
        print(f"{name}: B={w['r16'].shape[0]} tiles={n_tiles} C={C} live "
              f"lanes={live} active chunks/tile={na_p.float().mean():.2f}; "
              "every turn's lists equal the plain version's bit for bit, "
              "hits identical, near within 1e-6 rel")
        rec = {}
        for what in ("list", "cull"):
            b_ms, b_by = bounds[what]
            print(f"  {what}: bound {b_ms:.5f} ms ({b_by})")
            for who in dict(turns):
                rs = [r[name] for t, r in res if t == who]
                ev = [m for r in rs for m in r[f"{what}_ms"]]
                dev = [r["device"].get(what) for r in rs]
                line = f"    {who:22s} events {_spread(ev)} ms"
                rec[f"{who} {what}"] = {"event_ms": float(np.median(ev))}
                if all(d is not None for d in dev):
                    dms = [d[0] for d in dev]
                    line += (f", device {_spread(dms)} ms in "
                             f"{dev[0][1]:.0f} kernels, share of bound "
                             f"{b_ms / float(np.median(dms)):.3f}")
                    rec[f"{who} {what}"].update(
                        device_ms=float(np.median(dms)), kernels=dev[0][1])
                elif device.type == "cuda":
                    line += ", device time not measured"
                print(line)
            rec[f"bound {what}"] = {"ms": b_ms, "by": b_by}
        summary[name] = rec
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump({"card": card, "workloads": summary}, f, indent=1)
    return summary


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        worker(*args.worker, args.rounds, args.reps)
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
