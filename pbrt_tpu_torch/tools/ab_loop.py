"""K2 and K2 motion against another checkout's, on the card: bit for bit,
and by CUDA events in turns.

    python -m pbrt_tpu_torch.tools.ab_loop --against DIR [--slices G ...]
        [--rounds 5] [--reps 10] [--out DIR] [--cpu]

DIR is another checkout of this repository (for example the parent
commit, unpacked with `git archive` into a gitignored directory).  The
tool makes the inputs once, in this checkout: the main path's camera and
bounce-1 batches of the Cornell model and of
pbrt_tpu_torch/scenes/cornell_motion.pbrt (256x256, Sobol', 65,536 rays
per pass, depth 5: chip_smoke.py's phases 3-4), each with its K1 lists,
and tools/ablate_k2.py's cornell_random, cluster g=8, g=1 and z40
workloads.
Both trees' kernels take the same inputs (K2 motion this checkout's
motion table).  Then it runs one worker process per turn, in the order
DIR, this, [a copy of this checkout per --slices G,] this, DIR; each
imports its own tree's `pbrt_tpu_torch` and calls the entry points both
share (`loop_hits`, `loop_hits_motion`, the latter with the scene's
`chunk_static` where it takes one), builds its kernels, keeps each
workload's (t, prim) and times it (kernel_workloads.interleaved:
`--rounds` rounds of `--reps` launches, the workloads in turn).  A
--slices copy is this checkout's package with the kernel's slice length
G (kSlice in csrc/dense_loop.cu, LOOP_SLICE in ops/dense_intersect.py)
set to that value.  In this checkout's turns (on the card) the worker
also times one block per tile (no split) and K2 motion told no chunk is
static (every chunk on the Horner path); each must equal the production
launch bit for bit, and every turn's (t, prim) this checkout's.

It prints per workload both trees' median ms (and min-max over the
turns), the ratio, the ray-triangle tests K2 needs (on static / moving
chunks), the bound and the share of it (kernel_workloads.loop_bound),
then the alternatives and the --slices copies, and with --out writes
them to DIR/summary.json.  With --cpu the worker runs the plain versions
at a small size (host times, not device times), against this checkout
itself if DIR is not given.
"""

from __future__ import annotations

import argparse
import inspect
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


# --- the worker: runs in its tree's environment; imports only that tree's
# --- pbrt_tpu_torch, torch and numpy

def worker(inp, out, rounds, reps, alternatives):
    from pbrt_tpu_torch.ops import dense_intersect as dense
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    data = torch.load(inp)
    device = torch.device(data["device"])
    takes_static = "chunk_static" in inspect.signature(
        dense.loop_hits_motion).parameters
    fns, res, alts = {}, {}, {}
    for name, w in data["workloads"].items():
        a = {k: (v.to(device) if torch.is_tensor(v) else v)
             for k, v in w.items()}
        args = (a["r16"], a["tmax"], a["W"], a["cl"], a["na"])
        if a["time"] is None:
            def fn(args=args):
                return dense.loop_hits(*args)
        else:
            st = (a["static"],) if takes_static else ()

            def fn(args=args, a=a, st=st):
                return dense.loop_hits_motion(args[0], args[1], a["time"],
                                              *args[2:], *st)
        t, p = fn()
        res[name] = {"t": t.cpu(), "prim": p.cpu()}
        fns[name] = fn
        if not alternatives or device.type != "cuda":
            continue
        kname = "dense_loop" if a["time"] is None else "dense_loop_motion"
        variants = {"one block per tile": dict(chunk_static=a["static"],
                                               blocks=1)}
        if a["time"] is not None:
            variants["all moving"] = dict(
                chunk_static=torch.zeros_like(a["static"]))
        for label, kv in variants.items():
            def vf(kv=kv, args=args, a=a, kname=kname):
                return dense._launch_loop(kname, args[0], args[1], a["time"],
                                          *args[2:], **kv)
            tv, pv = vf()
            if not (torch.equal(tv, t) and torch.equal(pv, p)):
                raise AssertionError(f"{name} {label}: not the production "
                                     "launch bit for bit")
            alts[(name, label)] = vf
    times = kw.interleaved(fns, rounds, reps, device)
    alt_times = kw.interleaved(alts, rounds, reps, device) if alts else {}
    for name in res:
        res[name]["ms"] = times[name]
        res[name]["alternatives"] = {lab: alt_times[(n, lab)]
                                     for (n, lab) in alt_times if n == name}
    torch.save(res, out)


# --- the coordinator: runs in this checkout

def make_inputs(device, small):
    """{name: workload dict} at full size (or small on the CPU)."""
    from pbrt_tpu_torch.models import flagship
    from pbrt_tpu_torch.ops import dense_intersect as dense
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    from pbrt_tpu_torch.tools import pbrt as cli
    side, rays = (32, 1024) if small else (256, 65536)
    cfg = SamplerConfig("sobol", 0, 4)
    out = {}

    def add(name, scene, r16, tmax, tm):
        cl, na = dense.tile_chunk_lists(r16, tmax, scene.dense_cb)
        out[name] = dict(r16=r16, tmax=tmax, time=tm, W=scene.dense_w,
                         cl=cl, na=na, static=scene.dense_static)

    scene, cam = flagship.cornell(device=device)
    for k, (r16, tmax, tm) in kw.main_path_batches(
            scene, cam(side, side), cfg, side, side, rays, 5).items():
        add(f"cornell {k}", scene, r16, tmax, tm)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    job = parse_scene(os.path.join(root, "pbrt_tpu_torch", "scenes",
                                   "cornell_motion.pbrt"), device=device)
    mcam = cli.build_camera(job, side, side, device)
    for k, (r16, tmax, tm) in kw.main_path_batches(
            job.scene, mcam, cfg, side, side, rays, 5).items():
        add(f"motion {k}", job.scene, r16, tmax, tm)
    cluster = kw.cluster_lists(device, 0, 8, 2 if small else 1024)
    wls = [kw.cornell_random(device, 0, 1024 if small else 131072, scene),
           cluster, cluster.with_g(1),
           kw.cluster_rays_z40(device, 0, 256 if small else 65536)]
    for wl in wls:
        out[wl.name] = dict(r16=wl.r16, tmax=wl.tmax, time=None, W=wl.W,
                            cl=wl.chunk_list, na=wl.n_active,
                            static=wl.chunk_static)
    return out


def slice_tree(here, g, tmp):
    """A checkout in tmp that is this one (its other entries linked) but
    for a copy of the package with the kernel's slice length G set to g:
    kSlice in csrc/dense_loop.cu and its mirror LOOP_SLICE in
    ops/dense_intersect.py."""
    root = os.path.join(tmp, f"G{g}")
    os.makedirs(root)
    for name in os.listdir(here):
        if name != "pbrt_tpu_torch":
            os.symlink(os.path.join(here, name), os.path.join(root, name))
    shutil.copytree(os.path.join(here, "pbrt_tpu_torch"),
                    os.path.join(root, "pbrt_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, pat, new in (
            ("csrc/dense_loop.cu", r"constexpr int kSlice = \d+;",
             f"constexpr int kSlice = {g};"),
            ("ops/dense_intersect.py", r"\nLOOP_SLICE = \d+\n",
             f"\nLOOP_SLICE = {g}\n")):
        path = os.path.join(root, "pbrt_tpu_torch", rel)
        with open(path) as f:
            text, n = re.subn(pat, new, f.read())
        if n != 1:
            raise SystemExit(f"ab_loop: {rel} does not define G once")
        with open(path, "w") as f:
            f.write(text)
    return root


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ab_loop", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--against", help="another checkout of the repository")
    ap.add_argument("--slices", type=int, nargs="*", default=[],
                    help="also time copies of this checkout with these G")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="directory for summary.json")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--worker", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--alternatives", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def run(args):
    from pbrt_tpu_torch.core import device as devmod
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    device = devmod.resolve("cpu" if args.cpu else None)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(args.against) if args.against else here
    if device.type == "cuda" and other == here:
        raise SystemExit("ab_loop: --against DIR is needed on the card")
    card = kw.card_name(device)
    data = make_inputs(device, device.type != "cuda")
    # the inputs and the turns' outputs are large: a temporary directory
    tmp = tempfile.mkdtemp(prefix="ab_loop_")
    inp = os.path.join(tmp, "inputs.pt")
    torch.save({"device": str(device), "workloads": {
        n: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in w.items()}
        for n, w in data.items()}}, inp)
    turns = ([("other", other), ("this", here)]
             + [(f"G={g}", slice_tree(here, g, tmp)) for g in args.slices]
             + [("this", here), ("other", other)])
    res = []
    for i, (who, tree) in enumerate(turns):
        out = os.path.join(tmp, f"turn{i}.pt")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", inp,
               out, "--rounds", str(args.rounds), "--reps", str(args.reps)]
        if who == "this":
            cmd.append("--alternatives")
        env = dict(os.environ, PYTHONPATH=tree)
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=tree, env=env, check=True, timeout=1800)
        print(f"turn {i}: {who} ({tree}) in {time.perf_counter() - t0:.1f} "
              "s")
        res.append((who, torch.load(out)))
    shutil.rmtree(tmp)
    print(f"ab_loop on {card}: {args.rounds} rounds x {args.reps} launches "
          f"per turn, turns {', '.join(w for w, _ in turns)}")
    summary = {}
    for name, w in data.items():
        got = {}
        for who, r in res:
            got.setdefault(who, []).append(r[name])
        ref = got["this"][0]
        for who, rs in got.items():
            for r in rs:
                if not (torch.equal(r["t"], ref["t"])
                        and torch.equal(r["prim"], ref["prim"])):
                    raise AssertionError(f"{name}: {who}'s (t, prim) differ "
                                         "from this checkout's")
        ms = {who: [m for r in rs for m in r["ms"]]
              for who, rs in got.items()}
        med = {who: float(np.median(v)) for who, v in ms.items()}
        b_ms, b_by, tests = kw.loop_bound(
            w["r16"], w["tmax"], w["W"], w["cl"], w["na"],
            ref["t"].to(device), ref["prim"].to(device), w["static"],
            time=w["time"])
        print(f"{name}: B={w['r16'].shape[0]} listed={int(w['na'].sum())} "
              f"tests static/moving={tests[0]}/{tests[1]}: other "
              f"{med['other']:.4f} ms [{min(ms['other']):.4f}-"
              f"{max(ms['other']):.4f}], this {med['this']:.4f} ms "
              f"[{min(ms['this']):.4f}-{max(ms['this']):.4f}], "
              f"{med['other'] / med['this']:.3f}x; (t, prim) equal bit for "
              f"bit; bound {b_ms:.5f} ms ({b_by}), share "
              f"{b_ms / med['this']:.3f} (other {b_ms / med['other']:.3f})")
        alts = {}
        for lab in ref.get("alternatives", {}):
            v = [m for r in got["this"] for m in r["alternatives"][lab]]
            alts[lab] = float(np.median(v))
            print(f"    {lab:18s} {alts[lab]:.4f} ms [{min(v):.4f}-"
                  f"{max(v):.4f}]")
        for who in got:
            if who.startswith("G="):
                alts[who] = med[who]
                print(f"    {who:18s} {med[who]:.4f} ms [{min(ms[who]):.4f}"
                      f"-{max(ms[who]):.4f}]")
        summary[name] = dict(other_ms=med["other"], this_ms=med["this"],
                             bound_ms=b_ms, bound_by=b_by, tests=tests,
                             alternatives=alts)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump({"card": card, "workloads": summary}, f, indent=1)
    return summary


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        worker(*args.worker, args.rounds, args.reps, args.alternatives)
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
