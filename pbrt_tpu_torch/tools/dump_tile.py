"""One ray tile of K2, every intermediate dumped and held against the
plain version: where the kernel and its plain twin part.

    python -m pbrt_tpu_torch.tools.dump_tile [--picks 0 1 2 2] [--tile K]
        [--scene file.pbrt] [--cpu]

The port's counterpart of the TPU rounds' s6
(scripts/debug/dbg_dense_dump.py) and s7 (scripts/debug/dbg_dense_full.py).
It runs the tile dump (csrc/dense_loop.cu's kDump instantiation of K2's
body) on ray tile K (default 0) over a list of chunks: `--picks` (repeats
allowed; s6's case is 0 1 2 2), or else tile K's real K1 list (s7).  The workload is
tools/kernel_workloads.py::tiny600 (600 triangles, 2,048 rays from
z = -20), or with --scene the camera rays of a static .pbrt scene's first
2,048 pixels.

It prints the largest difference of the kernel's sections from
tile_dump_plain's and, for entries beyond the f32 bound of two
evaluations (ops/dense_intersect.py::tile_dump_bounds), where they lie by
section, pick and lane (s6's printout); the first lane and triangle where
the two disagree on accepting the hit, with the sections, t and bound
there (s7's question); and whether the kernel's running (t, prim) after
the last pick equals production K2's on the tile, bit for bit.  A
section or a t beyond its bound, an accept flag that differs where no
f32 rounding explains it (`unexplained_accepts`) or a running best unlike
K2's raises.  Runs on cuda:0; --cpu runs the plain version against
itself at the same size.
"""

from __future__ import annotations

import argparse
import sys

import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.integrators import path
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.tools import kernel_workloads as kw

SECTIONS = ("s1", "s2", "s0", "num")


def scene_workload(file, device, n_rays=2048):
    """The camera rays of a static scene's first n_rays pixels (sample 0),
    with their K1 lists."""
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import pbrt as cli
    job = parse_scene(file, device=device)
    scene = job.scene
    if scene.dense_motion:
        raise SystemExit(f"{file}: a mesh moves; the dump is static K2's")
    camera = cli.build_camera(job, job.film_width, job.film_height, device)
    ray, _, _, _, _ = path.camera_rays_for_pixels(
        camera, job.film_width, job.film_height,
        SamplerConfig("sobol", 0, job.spp),
        torch.arange(n_rays, device=device), 0)
    return kw._k1_workload(file, ray.o, ray.d, scene.dense_w, scene.dense_cb,
                           scene.dense_center)


def k2_on_tile(wl, tile, picks):
    """Production K2's (t, prim) on the tile's lanes with `picks` as the
    tile's list.  A chunk listed again changes nothing (its hits are
    already in the running best), so K2 gets each pick once, in order of
    first appearance, and the other chunks after them, inactive."""
    first = list(dict.fromkeys(picks.tolist()))
    rest = [c for c in range(wl.W.shape[0]) if c not in set(first)]
    sl = slice(tile * dense.TILE, (tile + 1) * dense.TILE)
    cl = torch.tensor([first + rest], dtype=torch.int32, device=picks.device)
    na = torch.tensor([len(first)], dtype=torch.int32, device=picks.device)
    return dense.loop_hits(wl.r16[sl].contiguous(), wl.tmax[sl].contiguous(),
                           wl.W, cl, na)


def running_best(d, tmax):
    """[n,chunk,TILE] f64: each lane's running best t just before each
    test of the dump d, from its own accept flags and t (an accepted
    closest-hit test lowers the best to its t; an any-hit lane's later
    tests accept nothing)."""
    taken = torch.where(d["accepted"], d["t"], float("inf")).double()
    upto = torch.cummin(taken, 1).values                   # tests <= j
    before = torch.cat([torch.full_like(upto[:, :1], float("inf")),
                        upto[:, :-1]], 1)
    pick0 = torch.cat([tmax[None], d["best_t"][:-1]]).double()
    return torch.minimum(pick0[:, None], before)


def done_before(d, tmax, anyhit):
    """[n,chunk,TILE] bool: the lane is dead, or any-hit and has accepted
    at an earlier test of the walk (pick by pick, triangle by triangle)."""
    n, chunk, tile = d["accepted"].shape
    took = (d["accepted"] & anyhit).reshape(n * chunk, tile).int().cumsum(0)
    took = torch.cat([torch.zeros_like(took[:1]), took[:-1]]) > 0
    return took.reshape(n, chunk, tile) | ~(tmax > 0)


def unexplained_accepts(got, ref, tmax, anyhit, sec_bound, t_rel):
    """Where the kernel's (got) and the plain (ref) dump's accept flags
    differ, and which of those differences no f32 rounding explains.

    A differing flag is explained only where two f32 evaluations may
    round the test either way: kernel and plain t both within t_rel of
    their walk's running best (plus the gap between the two bests, which
    an earlier explained difference opened), or t within t_rel of the
    1e-4 floor, or an edge side within its section bound of 0 (its sign
    may flip), or t_rel infinite (nd may cancel); or where the walks
    already part (an any-hit lane done on one side only).  Every other
    difference is a wrong kernel.  Returns (differ, unexplained)
    [n,chunk,TILE] bool masks."""
    differ = got["accepted"] != ref["accepted"]
    tk, tp = got["t"].double(), ref["t"].double()
    bk, bp = running_best(got, tmax), running_best(ref, tmax)
    tol = t_rel * tp.abs() + torch.where(bk == bp, 0.0, (bk - bp).abs())
    near_best = ((tk - bk).abs() <= tol) & ((tp - bp).abs() <= tol)
    near_floor = (tp - 1e-4).abs() <= t_rel * tp.abs()
    edge = (ref["sections"][:, :3].double().abs()
            <= sec_bound[:, :3]).any(1)
    apart = done_before(got, tmax, anyhit) != done_before(ref, tmax, anyhit)
    explained = (near_best | near_floor | edge | apart
                 | ~torch.isfinite(t_rel))
    return differ, differ & ~explained


def compare(wl, tile, picks):
    """Kernel dump against plain dump on the tile; returns a dict of what
    was found (and prints it).  Raises on a section beyond its f32 bound,
    a t beyond its relative bound, an accept flag that differs where no
    rounding explains it, or a last running best unlike K2's."""
    sl = slice(tile * dense.TILE, (tile + 1) * dense.TILE)
    got = dense.tile_dump(wl.r16, wl.tmax, wl.W, picks, tile)
    ref = dense.tile_dump_plain(wl.r16[sl], wl.tmax[sl], wl.W, picks)
    sec_bound, t_rel = dense.tile_dump_bounds(wl.r16[sl], wl.W, picks)
    diff = (got["sections"] - ref["sections"]).abs()
    bad = (diff.double() > sec_bound).nonzero()
    out = dict(max_abs_err=diff.max().item(), bad=bad.shape[0],
               picks=picks.tolist(), accepted=int(ref["accepted"].sum()))
    print(f"tile {tile}, picks {out['picks']}: sections max abs diff "
          f"{out['max_abs_err']:.3e} (mean {diff.mean().item():.3e}); "
          f"entries beyond the f32 bound: {out['bad']}")
    if out["bad"]:
        secs = sorted({SECTIONS[i] for i in bad[:, 1].tolist()})
        print(f"  bad sections {secs}, picks "
              f"{sorted(set(bad[:, 0].tolist()))}, lanes "
              f"{bad[:, 3].min().item()}-{bad[:, 3].max().item()}, "
              f"triangles {bad[:, 2].min().item()}-{bad[:, 2].max().item()}")
        k, s, j, lane = bad[0].tolist()
        print(f"  first: pick {k} {SECTIONS[s]} triangle {j} lane {lane}: "
              f"kernel {got['sections'][k, s, j, lane].item():.9g} plain "
              f"{ref['sections'][k, s, j, lane].item():.9g} bound "
              f"{sec_bound[k, s, j, lane].item():.3e}")
    t_gap = ((got["t"] - ref["t"]).abs().double()
             / ref["t"].abs().double())
    finite = torch.isfinite(t_gap)
    out["t_beyond"] = int((t_gap[finite] > t_rel[finite]).sum())
    differ, unexplained = unexplained_accepts(
        got, ref, wl.tmax[sl], wl.r16[sl, 12] > 0.5, sec_bound, t_rel)
    out["accept_differ"] = int(differ.sum())
    out["unexplained"] = int(unexplained.sum())
    print(f"  t beyond its relative bound: {out['t_beyond']} entries; "
          f"{out['accepted']} tests accepted (plain), accept flags differ "
          f"on {out['accept_differ']} of {got['accepted'].numel()}, "
          f"{out['unexplained']} of them where no rounding explains it")
    part = (unexplained if out["unexplained"] else differ).nonzero()
    if part.shape[0]:
        k, j, lane = part[0].tolist()
        c = out["picks"][k]
        secs = ", ".join(
            f"{n} {got['sections'][k, i, j, lane].item():.6g}/"
            f"{ref['sections'][k, i, j, lane].item():.6g}"
            for i, n in enumerate(SECTIONS))
        print(f"  first: pick {k} (chunk {c}) triangle {j} (prim "
              f"{c * wl.chunk + j}) lane {lane}: accepted kernel "
              f"{bool(got['accepted'][k, j, lane])} plain "
              f"{bool(ref['accepted'][k, j, lane])}; kernel/plain {secs}; "
              f"t {got['t'][k, j, lane].item():.8g}/"
              f"{ref['t'][k, j, lane].item():.8g}, rel bound "
              f"{t_rel[k, j, lane].item():.3e}")
    if out["bad"]:
        raise AssertionError("dump sections beyond the f32 bound")
    if out["t_beyond"]:
        raise AssertionError("dump t beyond its relative bound")
    if out["unexplained"]:
        raise AssertionError("dump accept flags differ where no rounding "
                             "explains it")
    k2 = k2_on_tile(wl, tile, picks)
    out["k2_equal"] = (torch.equal(got["best_t"][-1], k2[0])
                       and torch.equal(got["best_prim"][-1], k2[1]))
    out["plain_prim_agree"] = (ref["best_prim"][-1] == k2[1]).float().mean() \
        .item()
    print(f"  last running (t, prim) equal to production K2's on the tile, "
          f"bit for bit: {out['k2_equal']}; the plain dump's prims agree "
          f"with it on {out['plain_prim_agree']:.4f} of lanes")
    if not out["k2_equal"]:
        raise AssertionError("the dump's last running best is not K2's")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="dump_tile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--picks", nargs="+", type=int, default=None,
                    help="chunk ids to walk (default: the tile's K1 list)")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--scene", default=None,
                    help="a static .pbrt scene in place of tiny600")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain version on the CPU")
    return ap.parse_args(argv)


def run(args):
    device = devmod.resolve("cpu" if args.cpu else None)
    print(f"dump_tile on {kw.card_name(device)}")
    wl = (scene_workload(args.scene, device) if args.scene
          else kw.tiny600(device))
    if not 0 <= args.tile < wl.n_tiles:
        raise SystemExit(f"--tile: {wl.n_tiles} tiles")
    if args.picks is None:
        picks = wl.chunk_list[args.tile, :int(wl.n_active[args.tile])]
    else:
        picks = torch.tensor(args.picks, dtype=torch.int32, device=device)
    if picks.numel() == 0:
        raise SystemExit(f"tile {args.tile} lists no chunk")
    print(f"{wl.name}: {wl.W.shape[0]} chunks of {wl.chunk}, "
          f"{wl.r16.shape[0]} rays")
    return compare(wl, args.tile, picks.contiguous())


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
