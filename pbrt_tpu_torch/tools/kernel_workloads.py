"""The kernel harnesses' workloads: the scenes, rays and chunk lists that
the TPU rounds' ablation and debug scripts measured K1 and K2 on, made
from the same numpy seeds by the port's own code.

  cornell_random    s1 (scripts/ablate_loop.py:26-35): the Cornell scene,
                    131,072 rays from inside the box in random directions,
                    coherence-sorted, real K1 lists.
  cluster_mesh      s2, s3, s5 (scripts/ablate_pick.py:32-43): 256
                    clusters of 257 small triangles, 65,792 in all: 514
                    chunks of 128, a 16.8 MB table.
  cluster_lists     s2, s5: 1,024 tiles of 128 rays from uniform origins
                    in [-12,12]^3, each tile listing exactly g distinct
                    random chunks (a prefix of one random order, so the
                    lists of a sweep over g nest).
  cluster_rays_z40  s3 (scripts/ablate_kernel_step.py:150-158): 65,536
                    rays from z = -40 aimed at 0.8 (x, y) on z = 0, real
                    K1 lists.
  tiny600           s6, s7 (scripts/debug/dbg_dense_dump.py:20-35): 600
                    triangles, 2,048 rays from (0, 0, -20) through
                    [-6,6]^2, real K1 lists.
  cluster_scene     s4 in place of killeroo (whose geometry is not in the
                    repo): the cluster mesh as a scene, for whole
                    intersect calls.

Each takes a device and a seed; nothing is built at import.  The s3
script drew its rays with jax.random; here numpy draws them from the same
distribution.  The timing helpers at the end (CUDA events, interleaved
rounds, spreads) serve the three tools alike.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.ops import intersect as isect
from pbrt_tpu_torch.scene.ir import SceneBuilder, MaterialSpec, MAT_MATTE

N_CLUSTERS = 256
CLUSTER_TRIS = 66000 // N_CLUSTERS        # 257, as the scripts cut it


@dataclass
class Workload:
    """K2's inputs: r16 [B,16], tmax [B], W [C,16,4*chunk], chunk_list
    [n_tiles,C] int32, n_active [n_tiles] int32, and the chunk boxes."""
    name: str
    r16: torch.Tensor
    tmax: torch.Tensor
    W: torch.Tensor
    chunk_bounds: torch.Tensor
    chunk_list: torch.Tensor
    n_active: torch.Tensor

    @property
    def chunk(self):
        return self.W.shape[2] // 4

    @property
    def n_tiles(self):
        return self.r16.shape[0] // dense.TILE

    @property
    def listed(self):
        """(tile, chunk) steps K2 walks: the sum of n_active."""
        return int(self.n_active.sum())

    def args(self):
        return (self.r16, self.tmax, self.W, self.chunk_list, self.n_active)

    def with_g(self, g):
        """The same lists cut to their first g chunks in every tile."""
        return dataclasses.replace(
            self, name=f"{self.name.split(' g=')[0]} g={g}",
            n_active=torch.full_like(self.n_active, g))


def _unit(d):
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _to(device, *xs):
    return [torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                            device=device) for x in xs]


def _tables(v0, e1, e2, device):
    tab = dense.build_dense_tables(v0, e1, e2)
    W, cb, center = _to(device, tab["W"], tab["chunk_bounds"], tab["center"])
    return W, cb, center


def _k1_workload(name, o, d, W, cb, center):
    """Rays o, d [B,3] f32 with tmax 1e30 and their real K1 lists."""
    r16 = dense.ray_vectors(o, d, center).contiguous()
    tmax = torch.full((o.shape[0],), 1e30, device=o.device)
    cl, na = dense.tile_chunk_lists(r16, tmax, cb)
    return Workload(name, r16, tmax, W, cb, cl, na)


def cornell_random(device, seed=0, n_rays=131072, scene=None):
    """s1: the Cornell scene (`scene`, or a new flagship.cornell), rays
    o = U[0,1)^3 * 4.6 + 0.2 with normalised Gaussian directions, sorted
    by the intersector's coherence key, real K1 lists."""
    if scene is None:
        scene, _ = flagship.cornell(device=device)
    rs = np.random.RandomState(seed)
    o, d = _to(device, rs.rand(n_rays, 3) * 4.6 + 0.2,
               _unit(rs.randn(n_rays, 3)))
    tmax = torch.full((n_rays,), 1e30, device=o.device)
    order = torch.sort(isect._coherence_key(scene, o, d, tmax),
                       stable=True).indices
    return _k1_workload("cornell_random", o[order], d[order], scene.dense_w,
                        scene.dense_cb, scene.dense_center)


def _cluster_soup(rs):
    """v0, e1, e2 [65792,3] f64 of the cluster mesh, drawn from rs."""
    centers = rs.rand(N_CLUSTERS, 3) * 20 - 10
    centers = centers[np.argsort(centers[:, 0]
                                 + 37.1 * np.floor(centers[:, 1]))]
    n = N_CLUSTERS * CLUSTER_TRIS
    v0 = np.repeat(centers, CLUSTER_TRIS, 0) + rs.randn(n, 3) * 0.3
    return v0, rs.randn(n, 3) * 0.1, rs.randn(n, 3) * 0.1


def cluster_mesh(seed=0):
    """s2/s3/s5's synthetic mesh: (v0, e1, e2) [65792,3] f64, clusters in
    the scripts' center order (triangles stay in that order: the dense
    tables take them as BVH-leaf order)."""
    return _cluster_soup(np.random.RandomState(seed))


def cluster_lists(device, seed=0, g=8, n_tiles=1024):
    """s2/s5: the cluster mesh's tables and n_tiles * 128 rays (origins
    U[-12,12)^3, normalised Gaussian directions, tmax 1e30; drawn after
    the mesh from the same stream, as the scripts draw them), each tile
    listing g distinct random chunks."""
    rs = np.random.RandomState(seed)
    W, cb, center = _tables(*_cluster_soup(rs), device)
    B = n_tiles * dense.TILE
    o = rs.rand(B, 3).astype(np.float32) * 24 - 12
    d = rs.randn(B, 3).astype(np.float32)
    o, d = _to(device, o, d / np.linalg.norm(d, axis=-1, keepdims=True))
    cl = np.argsort(rs.rand(n_tiles, W.shape[0]), 1).astype(np.int32)
    r16 = dense.ray_vectors(o, d, center).contiguous()
    return Workload(
        f"cluster g={g}", r16, torch.full((B,), 1e30, device=o.device), W,
        cb, torch.as_tensor(cl, device=o.device),
        torch.full((n_tiles,), g, dtype=torch.int32, device=o.device))


def cluster_rays_z40(device, seed=0, n_rays=65536):
    """s3: the cluster mesh, rays from (x, y, -40), (x, y) U[-12,12)^2,
    toward (0.8x, 0.8y, 0), real K1 lists (unsorted, as s3 ran them)."""
    rs = np.random.RandomState(seed)
    W, cb, center = _tables(*_cluster_soup(rs), device)
    px = rs.rand(n_rays, 2) * 24 - 12
    o = np.concatenate([px, np.full((n_rays, 1), -40.0)], 1)
    tgt = np.concatenate([px * 0.8, np.zeros((n_rays, 1))], 1)
    o, d = _to(device, o, _unit(tgt - o))
    return _k1_workload("cluster_z40", o, d, W, cb, center)


def tiny600_mesh(seed=0):
    """s6/s7's 600-triangle soup: (v0, e1, e2) f64, and the RandomState
    positioned after it."""
    rs = np.random.RandomState(seed)
    v0 = rs.rand(600, 3) * 10 - 5
    e1 = rs.randn(600, 3) * 0.4
    e2 = rs.randn(600, 3) * 0.4
    return (v0, e1, e2), rs


def tiny600(device, seed=0, n_rays=2048):
    """s6/s7: 600 triangles in [-5,5]^3, edges sigma 0.4; rays from
    (0, 0, -20) through (x, y, 0), (x, y) U[-6,6)^2; real K1 lists."""
    (v0, e1, e2), rs = tiny600_mesh(seed)
    W, cb, center = _tables(v0, e1, e2, device)
    px = rs.rand(n_rays, 2) * 12 - 6
    o = np.tile(np.array([[0.0, 0.0, -20.0]]), (n_rays, 1))
    tgt = np.concatenate([px, np.zeros((n_rays, 1))], 1)
    o, d = _to(device, o, _unit(tgt - o))
    return _k1_workload("tiny600", o, d, W, cb, center)


def cluster_scene(device, seed=0):
    """s4's large scene: the cluster mesh as one matte triangle mesh
    (SceneBuilder reorders it into BVH-leaf order)."""
    v0, e1, e2 = cluster_mesh(seed)
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(type=MAT_MATTE,
                                    kd=np.full(31, 0.5, np.float32)))
    verts = np.stack([v0, v0 + e1, v0 + e2], 1).reshape(-1, 3)
    b.add_triangle_mesh(verts, np.arange(len(verts)).reshape(-1, 3), m)
    return b.build(device=device)


# ---------------------------------------------------------------------------
# timing, shared by the three tools
# ---------------------------------------------------------------------------

def time_ms(fn, reps, device):
    """Mean time of fn() in ms over `reps` calls after one warm-up: CUDA
    events on a card; on the CPU the host clock (the plain versions'
    time, never a device time)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved(fns, rounds, reps, device):
    """Times each of `fns` ({name: fn}) once per round, `reps` calls each,
    the order rotated by one every round so that no name always runs
    first.  Returns {name: [ms per call, one per round]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        k = r % len(names)
        for n in names[k:] + names[:k]:
            out[n].append(time_ms(fns[n], reps, device))
    return out


def spread(ms):
    """(median, min, max) of a list of round times."""
    return float(np.median(ms)), float(min(ms)), float(max(ms))


def resolved(a, b):
    """Whether two lists of round times tell their medians apart: their
    min-max ranges do not overlap."""
    return min(a) > max(b) or min(b) > max(a)


def card_name(device):
    """What a result ran on: the card's name and power limit as
    nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu (plain versions; host clock)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else torch.cuda.get_device_name(0)
