"""Rendering split over ranks (port of pbrt_tpu.parallel.mesh, on
torch.distributed; replaces the reference's pthread tile pool,
src/core/parallel.cpp:184-322).

The scene and camera are replicated on every rank.  Each pass's pixel
chunk is cut into one contiguous share per rank (as the JAX package's
`P(axis)` splits its pixel ids), each rank traces its share into a
zeroed film of its own, and at the end the four film arrays are summed
over the ranks by one all_reduce each, into `film` on every rank.  The
counter-based samplers make each sample the one a single render draws,
so the result is a single render's up to the order of the f32 sums (one
all-reduce at the end in place of the JAX package's psum after every
pass; a single rank is bit for bit).

The process group is the caller's (torch.distributed.init_process_group
with an explicit backend; parallel/multihost.py): NCCL with a card a
rank, gloo on the CPU, or gloo with CUDA tensors for two ranks on one
card, which NCCL refuses.

`sharded_train_step` is the port of `__graft_entry__.dryrun_multichip`'s
step: each rank's share of the rays through `diff.render_loss`, the loss
and the gradients all-reduced, then one clamped SGD step.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from pbrt_tpu_torch.integrators import diff
from pbrt_tpu_torch.integrators import path as pathmod

FILM_FIELDS = ("weighted", "weight", "raw", "splat")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rank_pixel_ids(n_pix, world, rank, rays_per_rank):
    """This rank's pixel ids over every pass, in pass order: each pass's
    chunk of rays_per_rank * world pixels (a multiple of world; the last
    padded with 0xFFFFFFFF) cut into world contiguous shares.  Returns
    (ids [n_chunks * share] int64, share)."""
    chunk = min(n_pix, rays_per_rank * world)
    chunk = -(-chunk // world) * world
    n_chunks = -(-n_pix // chunk)
    share = chunk // world
    ids = np.arange(n_chunks * chunk, dtype=np.int64)
    ids[n_pix:] = 0xFFFFFFFF
    mine = ids.reshape(n_chunks, world, share)[:, rank]
    return mine.reshape(-1), share


def render_sharded(scene, camera, film, cfg, spp, max_depth=5, group=None,
                   rays_per_rank=1 << 16, generate_rays=None, trace_fn=None,
                   progress=None, timings=None):
    """Render over the ranks of `group` (None: the default group) into
    `film`, which every rank holds whole at the end (module docstring).
    timings, a dict, receives this rank's render seconds ("render_s"),
    its passes ("passes") and the all-reduces' seconds ("allreduce_s"),
    each ended by a device synchronisation."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = film.weighted.device
    ids, share = rank_pixel_ids(film.height * film.width, world, rank,
                                rays_per_rank)
    local = dataclasses.replace(film, **{
        k: torch.zeros_like(getattr(film, k)) for k in FILM_FIELDS})
    t0 = time.perf_counter()
    pathmod.render(scene, camera, local, cfg, spp, max_depth=max_depth,
                   max_rays_per_pass=share, trace_fn=trace_fn,
                   generate_rays=generate_rays, progress=progress,
                   pixel_ids=ids)
    _sync(dev)
    t1 = time.perf_counter()
    # merge the ranks' films (MergeFilmTile, film.cpp:124): one
    # collective per array
    for k in FILM_FIELDS:
        part = getattr(local, k)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        getattr(film, k).add_(part)
    _sync(dev)
    if timings is not None:
        timings.update(render_s=t1 - t0, passes=spp * len(ids) // share,
                       allreduce_s=time.perf_counter() - t1)
    return film


def sharded_train_step(params, scene, camera, W, H, cfg, pixel_ids,
                       sample_idx, target, max_depth=2, learning_rate=0.1,
                       group=None):
    """One data-parallel gradient step of the MSE against target
    [n_pix, 31] over the global batch pixel_ids [B] (B a multiple of the
    ranks): each rank renders its contiguous share, its loss weighted by
    its share of B; the loss and the gradients of every parameter are
    summed over the ranks; then params <- max(params - lr * grad, 0).
    Returns (new params, global loss, global gradients), the same on
    every rank."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    B = pixel_ids.shape[0]
    n = B // world
    if n * world != B:
        raise ValueError(f"batch {B} is not a multiple of {world} ranks")
    mine = pixel_ids[rank * n:(rank + 1) * n]
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = diff.render_loss(p, scene, camera, W, H, cfg, mine,
                            (sample_idx,), target, max_depth) * (n / B)
    grads = torch.autograd.grad(loss, list(p.values()))
    loss = loss.detach()
    for t in (loss, *grads):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    grads = dict(zip(p, grads))
    new = {k: torch.clamp(v.detach() - learning_rate * grads[k], min=0.0)
           for k, v in p.items()}
    return new, loss, grads
