"""Where the time of one intersect call goes, stage by stage, on the card.

    python -m pbrt_tpu_torch.tools.dissect_intersect [--scene cornell
        cluster] [--batch 262144 ...] [--rounds 5] [--reps 16] [--cpu]

The port's counterpart of the TPU rounds' s4
(scripts/debug/dissect_queue2.py): rays uniform in the scene's bounds
with normalised Gaussian directions, 70% of them live, in 8 batches drawn
from numpy seeds 0-7 and used in turn.  On the Cornell scene and on the
cluster mesh as a scene (tools/kernel_workloads.py::cluster_scene; s4's
killeroo is not in the repo), it times by CUDA events each stage of
ops/intersect.py::intersect on its own inputs:

  0. the sphere pre-test (scenes with spheres)
  1. ray_vectors
  2. coherence key, sort and the gathers of o, d and tmax
  3. the unsort scatters of t and prim
  4. K1 alone: its cull, the TPU kernel's contract (tile_queue: K1's
     kCull instantiation)
  5. K1 lists: the cull and the front-to-back chunk lists in one launch,
     as the main path runs it (tile_chunk_lists: kList)
  6. K2 on the sorted rays with their lists (loop_hits)
  7. the whole intersect call

and prints each stage's median and min-max over the rounds, and the sum
of stages 0, 1, 2, 3, 5 and 6 against stage 7.  Beside each it prints
the device time of the stage's kernels and their number per call, from
torch.profiler: where the events' time exceeds the device time, the
stage waits on the host that launches it.  It first checks that the
stages, composed, give intersect's (t, prim) exactly.  Runs on cuda:0;
--cpu runs the plain versions at a small batch (host times, not device
times).  Any failed check raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import geometry as geom
from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.tools import kernel_workloads as kw

N_BATCHES = 8
LIVE = 0.7
STAGES = ("sphere pre-test", "ray_vectors", "key + sort + gathers",
          "unsort scatters", "K1 alone", "K1 lists",
          "K2 presorted", "intersect")
SUMMED = ("sphere pre-test", "ray_vectors", "key + sort + gathers",
          "unsort scatters", "K1 lists", "K2 presorted")


def scene_bounds(scene):
    """World bounds [3], [3] of the scene's triangles."""
    v = torch.stack([scene.tri_v0, scene.tri_v0 + scene.tri_e1,
                     scene.tri_v0 + scene.tri_e2])
    return (v.amin((0, 1)).cpu().numpy().astype(np.float64),
            v.amax((0, 1)).cpu().numpy().astype(np.float64))


def batch(scene, B, seed, device):
    """s4's batch: o uniform in the scene's bounds, normalised Gaussian d,
    tmax 1e30 on 70% of the lanes and -1 (dead) on the rest."""
    lo, hi = scene_bounds(scene)
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=B) < LIVE, 1e30, -1.0)
    o, d, tmax = (torch.as_tensor(x, dtype=torch.float32, device=device)
                  for x in (o, d, tmax))
    return geom.Ray.make(o, d, tmax=tmax)


def stages(scene, ray):
    """intersect(scene, ray) cut at its stages.  Returns ({stage: fn()},
    (t, prim, found) composed from the stages' outputs)."""
    o, d = ray.o, ray.d
    t_init = ray.tmax.to(torch.float32)
    prim_init = torch.full(t_init.shape, -1, dtype=torch.int32,
                           device=t_init.device)

    def pre():
        return isect.all_quadrics_test(scene, o, d, t_init, ray.time)

    if scene.n_quadrics > 0:
        tq, qprim, qhit = pre()
        t_init = torch.where(qhit, tq, t_init)
        prim_init = torch.where(qhit, qprim, prim_init)
    t0 = t_init

    def sort():
        order = torch.sort(isect._coherence_key(scene, o, d, t0),
                           stable=True).indices
        return order, o[order], d[order], t0[order]

    order, os_, ds, ts = sort()
    r16 = dense.ray_vectors(os_, ds, scene.dense_center).contiguous()
    cl, na = dense.tile_chunk_lists(r16, ts, scene.dense_cb)
    t_s, prim_s = dense.loop_hits(r16, ts, scene.dense_w, cl, na)

    def unsort():
        t = torch.empty_like(t_s)
        t[order] = t_s
        prim = torch.empty_like(prim_s)
        prim[order] = prim_s
        return t, prim

    t, prim = unsort()
    prim = torch.where(prim >= 0, prim, prim_init)
    fns = {
        "sphere pre-test": pre if scene.n_quadrics > 0 else None,
        "ray_vectors": lambda: dense.ray_vectors(o, d, scene.dense_center),
        "key + sort + gathers": sort,
        "unsort scatters": unsort,
        "K1 alone": lambda: dense.tile_queue(r16, ts, scene.dense_cb),
        "K1 lists": lambda: dense.tile_chunk_lists(r16, ts, scene.dense_cb),
        "K2 presorted": lambda: dense.loop_hits(r16, ts, scene.dense_w, cl,
                                                na),
        "intersect": lambda: isect.intersect(scene, ray),
    }
    return fns, (t, prim, prim >= 0)


def dissect(scene, B, rounds, reps, device):
    """Checks the composed stages against intersect on every batch, then
    times the stages over the batches in turn.  Returns {stage: [ms per
    round]}."""
    per_batch = []
    for seed in range(N_BATCHES):
        ray = batch(scene, B, seed, device)
        fns, composed = stages(scene, ray)
        whole = isect.intersect(scene, ray)
        for name, a, b in zip(("t", "prim", "found"), composed, whole):
            if not torch.equal(a, b):
                raise AssertionError(f"batch {seed}: the composed stages' "
                                     f"{name} differs from intersect's")
        per_batch.append(fns)
    calls = {}
    for name in STAGES:
        if per_batch[0][name] is None:
            continue
        state = {"i": 0}

        def call(name=name, state=state):
            state["i"] += 1
            return per_batch[state["i"] % N_BATCHES][name]()
        calls[name] = call
    times = kw.interleaved(calls, rounds, reps, device)
    return times, device_ms(calls) if device.type == "cuda" else {}


def device_ms(calls):
    """{stage: (device ms per call, kernels per call)} of the stages'
    kernels (kernel_workloads.device_ms), or {} where the trace holds no
    device time."""
    out = {}
    for name, fn in calls.items():
        d = kw.device_ms(fn)
        if d is None:
            return {}
        out[name] = d
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="dissect_intersect",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", nargs="+", default=["cornell", "cluster"],
                    choices=["cornell", "cluster"])
    ap.add_argument("--batch", nargs="+", type=int, default=None,
                    help="rays per call (default 262144; 1024 with --cpu)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU at a small batch")
    return ap.parse_args(argv)


def run(args, scenes=None):
    """Runs the tool; returns {(scene, B): {stage: [ms per round]}}.
    `scenes`: {name: SceneData} to reuse."""
    device = devmod.resolve("cpu" if args.cpu else None)
    print(f"dissect_intersect on {kw.card_name(device)}")
    scenes = dict(scenes or {})
    res = {}
    for name in args.scene:
        if name not in scenes:
            scenes[name] = (flagship.cornell(device=device)[0]
                            if name == "cornell"
                            else kw.cluster_scene(device))
        scene = scenes[name]
        for B in args.batch or ([1024] if args.cpu else [1 << 18]):
            times, dev = dissect(scene, B, args.rounds, args.reps, device)
            res[(name, B)] = times
            print(f"{name}: {scene.tri_v0.shape[0]} triangles in "
                  f"{scene.dense_cb.shape[0]} chunks, B={B}, "
                  f"{int(LIVE * 100)}% live, {N_BATCHES} batches; the "
                  f"composed stages equal intersect; {args.rounds} rounds "
                  f"x {args.reps} calls:")
            for st, ms in times.items():
                med, lo, hi = kw.spread(ms)
                d = (f"device {dev[st][0]:.4f} ms in {dev[st][1]:.0f} "
                     "kernels" if st in dev else "device time not measured")
                print(f"  {st:21s} {med:.4f} ms [{lo:.4f}-{hi:.4f}], {d}")
            total = sum(kw.spread(times[s])[0] for s in SUMMED if s in times)
            whole = kw.spread(times["intersect"])[0]
            print(f"  sum of the stages but K1 alone: {total:.4f} ms "
                  f"against intersect {whole:.4f} ms "
                  f"({total / whole:.3f})")
    return res


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
