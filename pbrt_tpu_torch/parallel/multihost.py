"""Multi-process rendering entry point (port of pbrt_tpu.parallel.multihost,
on torch.distributed).

Every rank runs the same program: it joins the process group, renders
the flagship Cornell scene through `mesh.render_sharded` (the scene
replicated, the pixels split, the film summed by all_reduce) and rank 0
reports checksums:

    python -m pbrt_tpu_torch.parallel.multihost \
        --init-method tcp://localhost:29500 --world-size 2 --rank <i> \
        --backend nccl

The backend is the caller's choice, never a fallback: nccl with a card a
rank, gloo on the CPU (--cpu), or gloo with CUDA tensors for several
ranks on one card.  Without --cpu a rank runs on cuda:(rank % the
visible cards) and raises when none is visible.  Each rank prints its
ms a pass and the all-reduce's ms (after --warmup's untimed spp, if
any); rank 0 prints

    MULTIHOST_OK mean=... sum=... ranks=N backend=...

(the spectral image's mean and sum) and, with --out FILE, writes the
summed film's arrays (weighted, weight, raw, splat) to FILE (.npz).

With --train-step it runs `__graft_entry__.dryrun_multichip`'s step in
place of the render: `mesh.sharded_train_step` over 16 rays a rank of
the 64x64 Cornell model at depth 2 (mat_kd and light_L against a 0.25
target); rank 0 prints `TRAIN_STEP_OK loss=...` and, with --out, writes
the loss, the gradients (grad_<name>) and the new parameters.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.parallel import mesh
from pbrt_tpu_torch.samplers.samplers import SamplerConfig


def rank_device(rank, cpu=False):
    """cuda:(rank % visible cards), or the CPU when asked; raises when
    no card is visible and the CPU was not asked for."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass --cpu to run "
                           "the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def render_flagship_distributed(width=32, height=32, spp=2, max_depth=3,
                                device=None, tessellate=False, timings=None):
    """Render the flagship scene over the default process group (a box
    film, Sobol', one pass a sample: max(64, pixels // ranks) rays a rank,
    as the JAX package's); returns the summed film, whole on every
    rank."""
    world = dist.get_world_size()
    scene, cam_ctor = flagship.cornell(tessellate=tessellate, device=device)
    camera = cam_ctor(width, height)
    film = filmmod.make_film(width, height, "box", device=device)
    cfg = SamplerConfig("sobol", 0, spp)
    return mesh.render_sharded(
        scene, camera, film, cfg, spp, max_depth=max_depth,
        rays_per_rank=max(64, width * height // world), timings=timings)


def train_step_distributed(device, rays_per_rank=16, size=64, depth=2):
    """dryrun_multichip's step over the default group: returns (new
    params, loss, gradients)."""
    world = dist.get_world_size()
    scene, cam_ctor = flagship.cornell(tessellate=True, device=device)
    camera = cam_ctor(size, size)
    cfg = SamplerConfig("sobol", 0, 4)
    B = rays_per_rank * world
    pixel_ids = torch.arange(B, dtype=torch.int64, device=device)
    target = torch.full((size * size, 31), 0.25, device=device)
    params = {"mat_kd": scene.mat_kd, "light_L": scene.light_L}
    return mesh.sharded_train_step(params, scene, camera, size, size, cfg,
                                   pixel_ids, 0, target, max_depth=depth)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch.multihost")
    ap.add_argument("--init-method", required=True,
                    help="torch.distributed init method: "
                         "tcp://host:port or file:///path")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", required=True, choices=["nccl", "gloo"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (with --backend gloo)")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=0, metavar="SPP",
                    help="render this many spp first, untimed and "
                         "discarded (each process's first passes and "
                         "collective pay its warm-up)")
    ap.add_argument("--tessellate", action="store_true",
                    help="the benchmark Cornell (meshed spheres and glass)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="rank 0 writes the summed film (or the train "
                         "step's results) here (.npz)")
    ap.add_argument("--train-step", action="store_true",
                    help="run one sharded gradient step, not the render")
    args = ap.parse_args(argv)
    device = rank_device(args.rank, args.cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(args.backend, init_method=args.init_method,
                            world_size=args.world_size, rank=args.rank)
    try:
        if args.train_step:
            new, loss, grads = train_step_distributed(device)
            if args.rank == 0:
                if args.out:
                    np.savez(args.out, loss=loss.cpu().numpy(),
                             **{f"grad_{k}": v.cpu().numpy()
                                for k, v in grads.items()},
                             **{k: v.cpu().numpy() for k, v in new.items()})
                print(f"TRAIN_STEP_OK loss={loss.item():.6f} "
                      f"ranks={args.world_size} backend={args.backend}",
                      flush=True)
            dist.barrier()
            return 0
        if args.warmup:
            render_flagship_distributed(args.size, args.size, args.warmup,
                                        args.depth, device,
                                        tessellate=args.tessellate)
        timings = {}
        film = render_flagship_distributed(
            args.size, args.size, args.spp, args.depth, device,
            tessellate=args.tessellate, timings=timings)
        print(f"rank {args.rank} on {device}: "
              f"{timings['render_s'] * 1e3 / timings['passes']:.2f} ms a "
              f"pass ({timings['passes']} passes), all-reduce "
              f"{timings['allreduce_s'] * 1e3:.2f} ms", flush=True)
        img = filmmod.develop_spectral(film).cpu().numpy()
        if args.rank == 0:
            if args.out:
                np.savez(args.out, **{k: getattr(film, k).cpu().numpy()
                                      for k in mesh.FILM_FIELDS})
            print(f"MULTIHOST_OK mean={img.mean():.6f} sum={img.sum():.4f} "
                  f"ranks={args.world_size} backend={args.backend}",
                  flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
