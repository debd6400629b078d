"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed in bfloat16, the
precision below the float32 the configurations state, against the same
reference in float32, on the cell's own sizes.  Its numbers have to
fail the cell's limits; the benchmark's own runs never run it.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 \
        [--passes N]

--passes: the render passes (a render cell) the emulated window holds,
by default the spp of one job; a light-side cell runs whole jobs, a
gradient cell its checked steps.  Prints one JSON line per seed with
each number beside its limit.  Runs on the first CUDA card, or with
--cpu on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

import torch

from benchmark import run
from benchmark.seeds import grad_seed, job_seed
from benchmark.reference import compare
from benchmark.reference import path as rpath
from benchmark.reference import scene as rscene


def render_jobs(tr, seed, passes):
    """The (sampler seed, passes) of each job a window of `passes`
    passes renders, as drivers/render.py seeds them."""
    out, j, left = [], 0, passes
    per_job = tr["spp"] * max(-(-tr["width"] * tr["height"]
                                // tr["lanes_per_pass"]), 1)
    while left > 0:
        out.append((job_seed(seed, j), min(left, per_job)))
        left -= per_job
        j += 1
    return out


def _altered(trace):
    """trace with one lane in four 5% brighter, where L is produced."""
    def fn(*a, **k):
        L = trace(*a, **k)
        lanes = torch.arange(L.shape[0], device=L.device)
        return L * torch.where(lanes % 4 == 0, 1.05, 1.0).to(L.dtype)[:, None]
    return fn


def grad_side(cell, sc, target, pixels, sampler_seed, device, fault=None):
    """The reference's first steps put in the program's place: in
    bfloat16, or with `fault` in float32 ("half": half of each step's
    pixels left out, the mean taken over the rest; "altered": an answer
    altered where it is produced)."""
    if fault == "half":
        pixels = pixels[:pixels.shape[0] // 2]
    saved = rpath.trace
    if fault == "altered":
        rpath.trace = _altered(saved)
    try:
        return compare.grad_reference(
            cell, sc, target, pixels, sampler_seed, device,
            torch.float32 if fault else torch.bfloat16)
    finally:
        rpath.trace = saved


def numbers(cell, seed, passes, device, fault=None):
    """The control's (name, value, limit) for one seed: the reference in
    bfloat16 in the program's place, or for a gradient cell with `fault`
    (see `grad_side`), against the float32 reference."""
    tr = cell["traffic"]
    limits = tr["check"]["limits"]
    sc = rscene.parse(os.path.join(cell["root"],
                                   cell["config_data"]["scene"]))
    if tr["driver"] == "grad":
        W, H = tr["width"], tr["height"]
        sampler_seed = grad_seed(seed)
        target = compare.grad_target(sc, sampler_seed, W, H, device)
        pixels = torch.arange(W * H, device=device)
        ref = compare.grad_reference(cell, sc, target, pixels, sampler_seed,
                                     device)
        prog = grad_side(cell, sc, target, pixels, sampler_seed, device,
                         fault)
        nums = compare.grad_numbers(
            dict(losses=prog[0], grad_norm=prog[1], change=prog[2]), *ref)
        names = ("loss_gap", "grad_gap", "change_gap")
    else:
        W, H = tr["width"], tr["height"]
        rng = random.Random(int(seed))
        pixels = torch.tensor(sorted(rng.sample(range(W * H),
                                                tr["check"]["pixels"])),
                              device=device)
        if tr["integrator"] == "sppm":
            seeds = [job_seed(seed, j) for j in range(max(1, passes))]
            n_it = max(tr["spp"], 4)
            f32 = compare.sppm_sums(sc, pixels, seeds, W, H, device,
                                    torch.float32, n_it)
            b16 = compare.sppm_sums(sc, pixels, seeds, W, H, device,
                                    torch.bfloat16, n_it)
            one = torch.ones(f32.shape[0], device=device)
            nums = compare.render_numbers(b16, one, f32, one)
        else:
            jobs = render_jobs(tr, seed, passes)
            counts = [compare.sample_counts(p, tr["lanes_per_pass"], W, H)
                      for _, p in jobs]
            seeds = [s for s, _ in jobs]
            f32, w32 = compare.reference_film(sc, pixels, counts, seeds, W,
                                              H, device, torch.float32,
                                              tr["integrator"])
            b16, w16 = compare.reference_film(sc, pixels, counts, seeds, W,
                                              H, device, torch.bfloat16,
                                              tr["integrator"])
            nums = compare.render_numbers(b16, w16, f32, w32)
        names = ("weight_gap", "gap_share", "mean_gap")
    return [(n, v, float(limits[n])) for n, v in zip(names, nums)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--passes", type=int, default=None)
    ap.add_argument("--fault", choices=("half", "altered"), default=None,
                    help="a gradient cell's fault in place of bfloat16")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("benchmark.control: no CUDA card (pass --cpu)",
              file=sys.stderr)
        return 3
    tr = cell["traffic"]
    passes = args.passes if args.passes is not None else tr.get("spp", 1)
    for s in args.seeds:
        nums = numbers(cell, s, passes, device, args.fault)
        print(json.dumps({"seed": s, "passes": passes, "fault": args.fault,
                          "failed_limits": [n for n, v, lim in nums
                                            if v > lim],
                          "compared": {n: {"value": v, "limit": lim}
                                       for n, v, lim in nums}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
