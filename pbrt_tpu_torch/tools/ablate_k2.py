"""Where K2's time goes, on the card: its ablation modes timed against
each other, and its cost per listed chunk.

    python -m pbrt_tpu_torch.tools.ablate_k2 [--workload cornell cluster
        z40] [--g 1 8] [--rounds 5] [--reps 20] [--sweep] [--cpu]

The port's counterpart of the TPU rounds' K2 ablations: s1
(scripts/ablate_loop.py, Cornell), s2 (scripts/ablate_pick.py, the
cluster mesh with g chunks per tile), s3 (scripts/ablate_kernel_step.py,
the cluster mesh seen from z = -40) and, with --sweep, s5
(scripts/debug/micro_loop.py).  Their workloads are
tools/kernel_workloads.py's; their kernels are the modes of
csrc/dense_loop.cu's loop kernel, whose kFull instantiation is
production K2:

  empty     reads the list, joins the barriers     -> machinery
  stage     + stages each chunk in shared memory   -> staging = stage - empty
  sections  + s1, s2, s0, num of every test        -> sections - stage
  full      production K2                          -> epilogue: full - sections
  direct    K2 reading sections from device memory -> direct - full: what
            (no staging, no barriers)                 staging buys

For each workload it first holds every mode against its plain version
(ops/dense_intersect.py::loop_hits_ablate_plain) and direct and full
against production K2 bit for bit, then times all modes in one process:
`--rounds` rounds of `--reps` launches each, the mode order rotated every
round.  It prints each mode's median and min-max over the rounds, and
each share in us per listed chunk (per (tile, chunk) step) and per tile;
a difference whose two modes' min-max ranges overlap is printed as "not
resolved".  --sweep times production K2 on the cluster lists with g in
{0, 1, 2, 4, 8, 16, 32} chunks per tile and prints the slope per chunk,
the fixed cost per tile and the ray-triangle tests per second at the
slope.  On the card it also prints the SASS instruction counts of each
mode (cuobjdump) and fails if nvcc removed the work a mode is meant to
time.

Runs on cuda:0; --cpu runs the plain versions at a small size (host
times, not device times).  Any failed check raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.tools import kernel_workloads as kw

MODES = dense.ABLATE_MODES
#: (share, mode subtracted, mode): each share is a difference of two modes
SHARES = (("machinery", None, "empty"), ("staging", "empty", "stage"),
          ("sections", "stage", "sections"), ("epilogue", "sections", "full"),
          ("what staging buys", "full", "direct"))
SWEEP_G = (0, 1, 2, 4, 8, 16, 32)
# ray-triangle tests/s at the H100 SXM's f32 peak (67 TFLOP/s outside the
# tensor cores), 45 operations a test
F32_TESTS_PER_S = 67e12 / 45


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def workloads(args, device, scene=None):
    """The workloads named in args, at full size (or small with --cpu)."""
    small = device.type != "cuda"
    out = []
    for name in args.workload:
        if name == "cornell":
            out.append(kw.cornell_random(device, 0, 1024 if small else 131072,
                                         scene))
        elif name == "z40":
            out.append(kw.cluster_rays_z40(device, 0,
                                           256 if small else 65536))
        else:
            base = kw.cluster_lists(device, 0, args.g[0],
                                    2 if small else 1024)
            out += [base.with_g(g) for g in args.g]
    return out


def check_modes(wl):
    """Every mode against its plain version on wl, and direct and full
    against production K2 bit for bit.  Returns {mode: largest |t| of
    kernel minus plain} over the lanes each mode's contract compares."""
    args = wl.args()
    t_k2, p_k2 = dense.loop_hits(*args)
    errs = {}
    for mode in MODES:
        t, p = dense.loop_hits_ablate(mode, *args)
        tp, pp = dense.loop_hits_ablate_plain(mode, *args)
        what = f"{wl.name} {mode}"
        if mode in ("empty", "stage"):
            check(torch.equal(t, tp) and torch.equal(p, pp),
                  f"{what}: differs from its plain version")
            errs[mode] = 0.0
        elif mode == "sections":
            check(torch.equal(p, pp), f"{what}: chunks walked differ")
            exact, bnd = dense.sections_reference(wl.r16, wl.tmax, wl.W,
                                                  wl.chunk_list, wl.n_active)
            live = torch.isfinite(exact)
            check(torch.equal(torch.isfinite(t), live), f"{what}: dead lanes")
            for name, x in (("kernel", t), ("plain", tp)):
                gap = (x[live].double() - exact[live]).abs()
                check(bool((gap <= bnd[live]).all()),
                      f"{what}: {name} beyond the f32 bound by "
                      f"{(gap - bnd[live]).max().item()}")
            errs[mode] = (t - tp)[live].abs().max().item() if live.any() \
                else 0.0
        else:
            check(torch.equal(t, t_k2) and torch.equal(p, p_k2),
                  f"{what}: not production K2 bit for bit")
            errs[mode] = k2_agreement(what, wl, t, p, tp, pp)
    return errs


def k2_agreement(what, wl, t, p, tp, pp):
    """K2's contract against loop_hits_plain: found on >= 0.9999 of lanes,
    prim on >= 0.999, every closest-hit lane of both within the f32 bound
    of loop_t_reference.  Returns the largest |t - t_plain| over the
    closest-hit lanes with equal prims."""
    check(((p >= 0) == (pp >= 0)).float().mean().item() >= 0.9999,
          f"{what}: found agreement")
    check((p == pp).float().mean().item() >= 0.999, f"{what}: prim agree")
    closest = (wl.r16[:, 12] < 0.5) & (p == pp) & (p >= 0)
    if not closest.any():
        return 0.0
    t64, bnd = dense.loop_t_reference(wl.r16[closest], wl.W, p[closest])
    for x in (t, tp):
        check(bool(((x[closest].double() - t64).abs()
                    <= bnd * t64.abs()).all()), f"{what}: t beyond bound")
    return (t - tp)[closest].abs().max().item()


def time_modes(wl, rounds, reps, device):
    """{mode: [ms per launch, one per round]}, interleaved rounds."""
    args = wl.args()
    return kw.interleaved(
        {m: (lambda m=m: dense.loop_hits_ablate(m, *args)) for m in MODES},
        rounds, reps, device)


def split_lines(wl, times):
    """Each mode's median and range, then each share per listed chunk and
    per tile (or "not resolved")."""
    lines = []
    for m in MODES:
        med, lo, hi = kw.spread(times[m])
        lines.append(f"  {m:9s} {med:.4f} ms [{lo:.4f}-{hi:.4f}]")
    for share, a, b in SHARES:
        tb = times[b]
        if a is not None and not kw.resolved(times[a], tb):
            lines.append(f"  {share:17s} not resolved ({a} and {b} ranges "
                         "overlap)")
            continue
        d = kw.spread(tb)[0] - (kw.spread(times[a])[0] if a else 0.0)
        lines.append(f"  {share:17s} {d * 1e3 / max(wl.listed, 1):+.5f} us "
                     f"per listed chunk, {d * 1e3 / wl.n_tiles:+.4f} us "
                     "per tile")
    return lines


def sweep(base, rounds, reps, device):
    """Production K2 over SWEEP_G chunks per tile on the cluster lists,
    each held to K2's contract.  Returns {g: [ms per round]} and the fit
    (slope us per chunk per tile, fixed us per tile, tests/s)."""
    wls = {g: base.with_g(g) for g in SWEEP_G}
    for g, wl in wls.items():
        t, p = dense.loop_hits(*wl.args())
        tp, pp = dense.loop_hits_plain(*wl.args())
        k2_agreement(wl.name, wl, t, p, tp, pp)
    times = kw.interleaved(
        {g: (lambda wl=wl: dense.loop_hits(*wl.args()))
         for g, wl in wls.items()}, rounds, reps, device)
    gs = np.array([g for g in SWEEP_G if g > 0], np.float64)
    per_tile = np.array([kw.spread(times[g])[0] for g in gs]) * 1e3 \
        / base.n_tiles                                      # us per tile
    slope, fixed = np.polyfit(gs, per_tile, 1)
    tests = dense.TILE * base.chunk / (slope * 1e-6)
    return times, (slope, fixed, tests)


def sass_lines():
    """SASS counts of each loop-kernel mode, K2 motion and the dump, with
    ptxas's registers, stack and spills, and what nvcc did wrong: removed
    the work a mode is meant to time, or spilled.  Returns (lines,
    faults)."""
    from pbrt_tpu_torch.ops import cuda_kernels
    counts = cuda_kernels.sass_counts()
    report = cuda_kernels.ptxas_report()
    lines, faults = [], []
    keys = ("FFMA", "FMUL", "MUFU.RCP", "BAR.SYNC", "BAR", "LDGSTS", "STS",
            "LDS", "LDS.128", "LDG")

    def one(key, table):
        fn = [c for n, c in table.items() if key in n]
        check(len(fn) == 1, f"SASS: no single function {key}")
        return fn[0]

    def want(ok, what):
        if not ok:
            faults.append("SASS: " + what)

    names = {m: f"dense_loop_kernelILi{i}ELb0E" for i, m in enumerate(MODES)}
    names["K2 motion"] = "dense_loop_kernelILi4ELb1E"
    names["tile dump"] = "dense_loop_kernelILi5ELb0E"
    by = {m: one(key, counts) for m, key in names.items()}
    for mode, c in by.items():
        r = one(names[mode], report)
        lines.append(f"  {mode:9s} " + " ".join(
            f"{k} {c.get(k, 0)}" for k in keys) + f" | registers "
            f"{r.get('registers')} stack {r.get('stack')} B spill "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} B")
        # direct (sm_90a build) keeps 4 B on the stack around the call to
        # the IEEE division's slow path, which only operands the fast
        # path rejects take; production K2, K2 motion, the dump and the
        # modes that split K2's time must not spill at all
        want(mode == "direct" or (r.get("spill_stores") == 0
                                  and r.get("spill_loads") == 0),
             f"{mode} spills to local memory")
    # four tests a step, each 18 FFMA and 3 FMUL (a side's first
    # product), from 22 float4 loads
    for mode in ("sections", "full", "tile dump"):
        want(by[mode].get("FFMA", 0) >= 72 and by[mode].get("FMUL", 0)
             >= 12, f"{mode} has {by[mode].get('FFMA', 0)} FFMA (< 72) or "
             f"{by[mode].get('FMUL', 0)} FMUL (< 12)")
    want(by["full"].get("LDS.128", 0) >= 22
         and by["full"].get("LDS", 0) * 2 <= by["full"].get("FFMA", 0),
         "full reads its rows by fewer than 22 16-byte loads, or issues "
         "more than one shared load per 2 FFMA")
    want(by["K2 motion"].get("FFMA", 0) >= 4 * 84,
         "K2 motion lost its Horner FFMAs")
    for mode in ("stage", "sections", "full", "K2 motion", "tile dump"):
        want(by[mode].get("LDGSTS", 0) >= 1,
             f"{mode} stages nothing asynchronously")
    want(by["empty"].get("LDGSTS", 0) == 0 and by["empty"].get("STS", 0)
         <= 1, "empty stages to shared memory")
    want(by["direct"].get("LDGSTS", 0) == 0
         and by["direct"].get("LDG", 0) >= 22
         and by["direct"].get("BAR.SYNC", 0)
         < by["empty"].get("BAR.SYNC", 0),
         "direct stages, or has the loop's barriers, or reads no rows from "
         "device memory")
    return lines, faults


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ablate_k2", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--workload", nargs="+", default=["cornell", "cluster",
                                                      "z40"],
                    choices=["cornell", "cluster", "z40"])
    ap.add_argument("--g", nargs="+", type=int, default=[1, 8],
                    help="chunks per tile of the cluster lists")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="production K2 over g chunks per tile (s5)")
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU at a small size")
    return ap.parse_args(argv)


def run(args, scene=None):
    """Runs the tool; returns {workload name: {"errs", "times",
    "workload"}} plus "sweep" when asked.  `scene`: a Cornell scene to
    reuse."""
    device = devmod.resolve("cpu" if args.cpu else None)
    card = kw.card_name(device)
    print(f"ablate_k2 on {card}")
    if device.type == "cuda":
        print("SASS instruction counts per loop-kernel mode:")
        lines, faults = sass_lines()
        for line in lines:
            print(line)
        check(not faults, "; ".join(faults))
    res = {}
    for wl in workloads(args, device, scene):
        errs = check_modes(wl)
        times = time_modes(wl, args.rounds, args.reps, device)
        res[wl.name] = dict(errs=errs, times=times, workload=wl)
        print(f"{wl.name}: B={wl.r16.shape[0]} tiles={wl.n_tiles} listed "
              f"chunks={wl.listed} ({wl.listed / wl.n_tiles:.2f} per tile), "
              f"modes agree with their plain versions (largest |t| err "
              + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
              + f"); {args.rounds} rounds x {args.reps} launches:")
        for line in split_lines(wl, times):
            print(line)
    if args.sweep:
        base = kw.cluster_lists(device, 0, 0,
                                2 if device.type != "cuda" else 1024)
        times, (slope, fixed, tests) = sweep(base, args.rounds, args.reps,
                                             device)
        res["sweep"] = dict(times=times, slope_us=slope, fixed_us=fixed,
                            tests_per_s=tests)
        print(f"sweep: production K2 on the cluster lists, "
              f"{base.n_tiles} tiles, held to K2's contract at every g:")
        for g, ms in times.items():
            med, lo, hi = kw.spread(ms)
            print(f"  g={g:2d} {med:.4f} ms [{lo:.4f}-{hi:.4f}] "
                  f"{med * 1e3 / base.n_tiles:.4f} us per tile")
        print(f"  slope {slope:.5f} us per chunk per tile, fixed "
              f"{fixed:.5f} us per tile (fit over g >= 1), "
              f"{tests:.4e} ray-triangle tests/s at the slope, "
              f"{tests / F32_TESTS_PER_S:.3f} of the f32 bound")
    return res


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
