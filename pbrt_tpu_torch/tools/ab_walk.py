"""The BVH and kd walks against another checkout's, on the card: (t, prim)
against the plain versions in every turn, each tree's walk kernels timed,
and the shapes_1m render's ms a pass.

    python -m pbrt_tpu_torch.tools.ab_walk --against DIR [--rounds 3]
        [--reps 10] [--define NAME=VALUE[,NAME=VALUE] ...] [--no-render]
        [--out DIR] [--cpu]

DIR is another checkout of this repository (for example the parent
commit, unpacked with `git archive` into a gitignored directory).  The
tool makes the inputs once, in this checkout: phase 25's four walk cells
(kernel_workloads.WALK_CELLS, written by tools/shapes_scene.py into a
temporary directory) and the six batches of kernel_workloads.WALK_ROWS
that one pass hands the walks, each also split into its 1% of lanes with
the most node visits (the plain version's counts) and the other 99%.
Then it runs one worker process per turn, in the order DIR, this, [the --define
copies,] this, DIR; each imports its own tree's `pbrt_tpu_torch`, calls
its `bvh_walk` / `kd_walk` on every batch and part (with the arguments
its wrapper takes) and renders shapes_1m (its own parse; one warm-up
pass, then 3 passes a round by the host clock, ended by a synchronize).
Every turn times the walks with this checkout's timing code
(kernel_workloads, loaded from its file): `device_ms`, the kernel's own
device time (torch.profiler), and `time_ms`, CUDA events around `--reps`
wrapper calls, the calls interleaved over `--rounds` rounds.
`--define kTriGroup=4` adds a turn of a copy of this checkout whose
csrc/accel_walk.cu sets those constants (`constexpr int` or `bool` there)
to those values.

It prints per batch the plain version's node visits a lane (mean, max),
the bound (kernel_workloads.walk_bound) and, per tree, device and event
ms (median and min-max over its turns), the bound's share, ms a step of
the longest chain (device ms over the most visits of a lane) and the
device ms of the 1% and of the 99% alone; then each tree's registers and
spills (ptxas) and its shapes_1m ms a pass.  Every turn's
(t, prim) must equal the plain version's on every lane of a batch and of
its parts, ties (kernel_workloads.walk_ties) the only allowance, and each
call must launch its kernel once; a difference, or a turn that fails,
makes the tool exit non-zero after printing the rest.  With --out it
writes DIR/summary.json.  With --cpu the workers run the plain versions
at a small size (host times, not device times), against this checkout
itself if DIR is not given.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the cells at a size the CPU runs in seconds (tests/test_torch_accel.py's
# small scene) and dense caps below them, so that they take the walks
SMALL = dict(level=1, instances=2, field=6, subdiv=1, res=16)
SMALL_CAPS = dict(MAX_DENSE_PRIMS=1000, MAX_MOTION_PRIMS=500)
RAYS_PER_PASS, DEPTH, PASSES = 65536, 5, 3


def _timing():
    """This checkout's kernel_workloads module, loaded from its file: its
    own imports resolve to the worker's tree."""
    spec = importlib.util.spec_from_file_location(
        "_ab_walk_timing", os.path.join(HERE, "pbrt_tpu_torch", "tools",
                                        "kernel_workloads.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _caps(small):
    """The dense caps lowered for the small cells."""
    from pbrt_tpu_torch.scene import ir
    old = {k: getattr(ir, k) for k in SMALL_CAPS}
    if small:
        for k, v in SMALL_CAPS.items():
            setattr(ir, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(ir, k, v)


def _call(fn, args):
    """fn(**args) with the arguments fn takes (a BVH batch carries both
    the link table and the two tables it is made of: an older tree's
    bvh_walk takes those)."""
    names = inspect.signature(fn).parameters
    return fn(**{k: v for k, v in args.items() if k in names})


def _subset(args, idx, ray_args):
    """The batch's per-ray arguments at lanes idx; the tables as they are."""
    return {k: (v[idx].contiguous() if k in ray_args and v is not None
                else v) for k, v in args.items()}


# --- the worker: runs in its tree's environment

def worker(inp, out, rounds, reps):
    from pbrt_tpu_torch.ops import accel_walk
    kw = _timing()
    data = torch.load(inp)
    device = torch.device(data["device"])
    res = {"rows": {}, "ptxas": {}, "render_ms": None}
    fns = {}
    for row, w in data["rows"].items():
        fn = accel_walk.kd_walk if w["kd"] else accel_walk.bvh_walk
        args = {k: (v.to(device) if torch.is_tensor(v) else v)
                for k, v in w["args"].items()}
        res["rows"][row] = {}
        for part, idx in (("full", None), *w["parts"].items()):
            a = args if idx is None else _subset(args, idx.to(device),
                                                 kw.WALK_RAY_ARGS)
            accel_walk.reset_launch_counts()
            t, p = _call(fn, a)
            if device.type == "cuda":
                torch.cuda.synchronize()
            res["rows"][row][part] = {"t": t.cpu(), "prim": p.cpu(),
                                      "launches": dict(accel_walk.LAUNCHES)}
            fns[(row, part)] = functools.partial(_call, fn, a)
    times = kw.interleaved(fns, rounds, reps, device)
    for (row, part), fn in fns.items():
        rec = res["rows"][row][part]
        rec["event_ms"] = times[(row, part)]
        rec["device"] = (kw.device_ms(fn, reps) if device.type == "cuda"
                         else None)
    if device.type == "cuda":
        from pbrt_tpu_torch.ops import cuda_kernels
        res["ptxas"] = {k: v for k, v in cuda_kernels.ptxas_report().items()
                        if "walk" in k}
    if data["render"]:
        from pbrt_tpu_torch.parser.api import parse_scene
        from pbrt_tpu_torch.tools import pbrt as cli
        with _caps(data["small"]):
            job = parse_scene(data["render"], device=device)
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else lambda: None)
        cli.run_job(job, spp=1, max_rays_per_pass=RAYS_PER_PASS)
        sync()
        ms = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            cli.run_job(job, spp=PASSES, max_rays_per_pass=RAYS_PER_PASS)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3 / PASSES)
        res["render_ms"] = ms
    torch.save(res, out)


# --- the coordinator: runs in this checkout

def variant_tree(tmp, spec):
    """A checkout in tmp that is this one (its other entries linked) but
    for a copy of the package whose csrc/accel_walk.cu sets the constants
    of spec ("NAME=VALUE,..."), each defined there once."""
    root = os.path.join(tmp, "variant_" + re.sub(r"\W", "_", spec))
    os.makedirs(root)
    for name in os.listdir(HERE):
        if name != "pbrt_tpu_torch":
            os.symlink(os.path.join(HERE, name), os.path.join(root, name))
    shutil.copytree(os.path.join(HERE, "pbrt_tpu_torch"),
                    os.path.join(root, "pbrt_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, "pbrt_tpu_torch", "csrc", "accel_walk.cu")
    with open(path) as f:
        text = f.read()
    for item in spec.split(","):
        name, value = item.split("=")
        text, k = re.subn(rf"constexpr (int|bool) {name} = [^;]+;",
                          rf"constexpr \1 {name} = {value};", text)
        if k != 1:
            raise SystemExit(f"ab_walk: csrc/accel_walk.cu does not define "
                             f"{name} once")
    with open(path, "w") as f:
        f.write(text)
    return root


def make_inputs(device, small, tmp):
    """({row: {"kd", "kernel", "args", "parts", "plain": (t, prim,
    counts)}}, shapes_1m's scene path): WALK_ROWS' batches as
    kernel_workloads.accel_batches records them, each with its 1% of
    lanes of the most node visits ("top1") and the rest ("rest")."""
    from pbrt_tpu_torch.integrators import dispatch
    from pbrt_tpu_torch.ops import accel_walk
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    from pbrt_tpu_torch.tools import pbrt as cli
    from pbrt_tpu_torch.tools import shapes_scene
    batches, paths = {}, {}
    for cell, (opts, _, r, spp, _) in kw.WALK_CELLS.items():
        if small:
            opts, r = dict(opts, **SMALL), SMALL["res"]
            opts.pop("res")
        paths[cell] = shapes_scene.write_shapes_scene(
            os.path.join(tmp, cell), res=r, spp=spp, **opts)
        with _caps(small):
            job = parse_scene(paths[cell], device=device)
        cam = cli.build_camera(job, r, r, device)
        batches[cell] = kw.accel_batches(
            job.scene, cam, SamplerConfig("sobol", 0, spp), r, r,
            min(r * r, RAYS_PER_PASS), DEPTH,
            light_strategy=dispatch.light_strategy(job.integrator_params))
    rows = {}
    for row, cell, batch in kw.WALK_ROWS:
        args = batches[cell][batch]
        kd = "kd_packed" in args
        if not kd:
            args.update(hit_links=args["links"][..., 0].contiguous(),
                        miss_links=args["links"][..., 1].contiguous())
        plain = accel_walk.kd_walk_plain if kd else accel_walk.bvh_walk_plain
        t, p, counts = _call(functools.partial(plain, counts=True), args)
        B = t.shape[0]
        top = torch.topk(counts.visits, max(1, B // 100)).indices
        rest = torch.ones(B, dtype=torch.bool, device=t.device)
        rest[top] = False
        rows[row] = dict(kd=kd, kernel=kw.WALK_CELLS[cell][4], args=args,
                         parts={"top1": torch.sort(top).values,
                                "rest": torch.nonzero(rest)[:, 0]},
                         plain=(t, p, counts))
    return rows, paths["shapes_1m"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ab_walk", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--against", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--define", nargs="*", default=[],
                    help="also time copies of this checkout with these "
                         "kernel constants, NAME=VALUE[,NAME=VALUE]")
    ap.add_argument("--no-render", action="store_true",
                    help="skip the shapes_1m render")
    ap.add_argument("--out", help="directory for summary.json")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--worker", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _spread(v):
    return f"{float(np.median(v)):.4f} [{min(v):.4f}-{max(v):.4f}]"


def _mismatch(rec, t_p, p_p, args, kw):
    """Lanes of a turn's (t, prim) that differ from the plain version's
    without a tie."""
    t, p = rec["t"], rec["prim"]
    same = (p == p_p) & (t.view(torch.int32) == t_p.view(torch.int32))
    lanes = torch.nonzero(~same)[:, 0]
    scene = types.SimpleNamespace(tri_packed=args["tri_packed"],
                                  tri_motion=args.get("tri_motion"))
    tie = kw.walk_ties(scene, args["o"], args["d"], args.get("time"), lanes,
                       p, p_p)
    return int((~tie).sum())


def run(args):
    from pbrt_tpu_torch.core import device as devmod
    from pbrt_tpu_torch.tools import kernel_workloads as kw
    device = devmod.resolve("cpu" if args.cpu else None)
    other = os.path.abspath(args.against) if args.against else HERE
    if device.type == "cuda" and other == HERE:
        raise SystemExit("ab_walk: --against DIR is needed on the card")
    small = device.type != "cuda"
    card = kw.card_name(device)
    tmp = tempfile.mkdtemp(prefix="ab_walk_")
    t0 = time.perf_counter()
    rows, render = make_inputs(device, small, tmp)
    print(f"ab_walk inputs made in {time.perf_counter() - t0:.1f} s on "
          f"{card}")
    inp = os.path.join(tmp, "inputs.pt")
    torch.save({"device": str(device), "small": small,
                "render": None if args.no_render else render,
                "rows": {r: {"kd": w["kd"], "args": w["args"],
                             "parts": w["parts"]}
                         for r, w in rows.items()}}, inp)
    turns = [("other", other), ("this", HERE)]
    turns += [(spec, variant_tree(tmp, spec)) for spec in args.define]
    turns += [("this", HERE), ("other", other)]
    res, failed = [], []
    for i, (who, tree) in enumerate(turns):
        out = os.path.join(tmp, f"turn{i}.pt")
        log = os.path.join(tmp, f"turn{i}.log")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", inp,
               out, "--rounds", str(args.rounds), "--reps", str(args.reps)]
        env = dict(os.environ, PYTHONPATH=tree)
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(cmd, cwd=tree, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=1800).returncode
        print(f"turn {i}: {who} ({tree}) exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s")
        if rc:
            with open(log) as f:
                print(f.read()[-4000:])
            failed.append(f"turn {i} ({who}) exited {rc}")
            continue
        res.append((who, torch.load(out)))
    print(f"ab_walk on {card}: {args.rounds} rounds x {args.reps} calls per "
          f"turn, turns {', '.join(w for w, _ in turns)}")
    whos = list(dict(turns))
    summary = {"card": card, "rows": {}, "ptxas": {}, "render_ms": {}}
    for row, w in rows.items():
        t_p, p_p, counts = (x.cpu() if torch.is_tensor(x) else x
                            for x in w["plain"])
        cargs = {k: (v.cpu() if torch.is_tensor(v) else v)
                 for k, v in w["args"].items()}
        for who, r in res:
            for part, rec in r["rows"][row].items():
                idx = w["parts"].get(part)
                a, tp, pp = ((cargs, t_p, p_p) if idx is None else
                             (_subset(cargs, idx.cpu(), kw.WALK_RAY_ARGS),
                              t_p[idx.cpu()], p_p[idx.cpu()]))
                bad = _mismatch(rec, tp, pp, a, kw)
                want = {k: int(k == w["kernel"] and device.type == "cuda")
                        for k in rec["launches"]}
                if bad or rec["launches"] != want:
                    failed.append(f"{row} {part} ({who}): {bad} lanes "
                                  f"differ without a tie, launches "
                                  f"{rec['launches']}")
        b_ms, b_by = kw.walk_bound(cargs, counts, w["kd"])
        vmax = int(counts.visits.max())
        print(f"{row}: B={t_p.shape[0]} ({w['kernel']}); node visits a "
              f"lane mean {counts.visits.float().mean():.1f} max {vmax}; "
              f"bound {b_ms:.5f} ms ({b_by})")
        rec = {"B": int(t_p.shape[0]), "visits_mean":
               counts.visits.float().mean().item(), "visits_max": vmax,
               "bound_ms": b_ms, "bound_by": b_by}
        for who in whos:
            rs = [r["rows"][row] for t, r in res if t == who]
            if not rs:
                continue
            for part in ("full", "top1", "rest"):
                ev = [m for x in rs for m in x[part]["event_ms"]]
                dev = [x[part]["device"] for x in rs]
                text = f"    {who:6s} {part:5s} events {_spread(ev)} ms"
                key = f"{who} {part}"
                rec[key] = {"event_ms": float(np.median(ev))}
                if all(d is not None for d in dev):
                    dms = [d[0] for d in dev]
                    med = float(np.median(dms))
                    rec[key]["device_ms"] = med
                    text += f", device {_spread(dms)} ms"
                    if part == "full":
                        rec[key].update(share=b_ms / med,
                                        us_a_step=med * 1e3 / vmax)
                        text += (f", share of bound {b_ms / med:.4f}, "
                                 f"{med * 1e3 / vmax:.4f} us a step of the "
                                 "longest chain")
                elif device.type == "cuda":
                    text += ", device time not measured"
                print(text)
        summary["rows"][row] = rec
    for who in whos:
        rs = [r for t, r in res if t == who]
        if not rs:
            continue
        summary["ptxas"][who] = rs[0]["ptxas"]
        for name, v in sorted(rs[0]["ptxas"].items()):
            print(f"ptxas {who}: {name}: {v}")
        ms = [m for r in rs for m in (r["render_ms"] or [])]
        if ms:
            summary["render_ms"][who] = ms
            print(f"shapes_1m render {who}: {_spread(ms)} ms a pass "
                  f"({PASSES} passes a round, host clock)")
    shutil.rmtree(tmp)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    if failed:
        raise SystemExit("ab_walk: " + "; ".join(failed))
    print("ab_walk: every turn's (t, prim) equals the plain version's on "
          "every lane (ties allowed), one launch a call")
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
