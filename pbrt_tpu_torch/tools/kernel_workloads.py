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
  box_table         K1 alone at the most chunks a table has (MAX_CHUNKS
                    = 576): random boxes about [-10,10]^3 and z40's rays.
  queue_cases       K1's edge cases, constructed: equal and signed-zero
                    entry t, dead and all-miss tiles, C = 1, 48, 576.
  shells_scene      a light inside SHELLS nested material-less boxes,
                    each a MediumInterface, over a floor: every shadow
                    ray from the floor crosses a triangle at each of the
                    shadow walk's 8 steps (volpath_walk_batches).
  bdpt_batches      a bdpt pass's first light-subpath call and its
                    (2,2) and (2,1) connection calls; photon_batch, an
                    SPPM iteration's first photon call (the light-side
                    integrators' kinds of batch).
  accel_batches     the camera and bounce-1 batches of a render over the
                    dense cap, as its BVH or kd walk receives them, and
                    walk_bound, the walks' bound from the plain version's
                    counts; walk_edge_rays, the walks' edge cases.
  gather_batches    the arguments of each SPPM photon gather of one
                    iteration (G1, csrc/sppm_gather.cu) on a scene;
                    gather_cases, a synthetic batch of the gather's edge
                    cases; gather_bound, its bound; gather_near_ties.

Each takes a device and a seed; nothing is built at import.  The s3
script drew its rays with jax.random; here numpy draws them from the same
distribution.  K2's bound (loop_bytes, loop_bound) and the timing
helpers at the end (CUDA events, interleaved rounds, spreads) serve the
tools and chip_smoke.py alike, as do K1's bound (queue_bytes,
queue_bound) and the device-time helper (device_ms).
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd import DeviceType

from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.ops import accel_walk
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

    @property
    def chunk_static(self):
        """Every chunk of a static table: loop_test_counts' and
        loop_bound's chunk_static."""
        return torch.ones(self.W.shape[0], dtype=torch.bool,
                          device=self.W.device)

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


def box_table(device, seed=0, n_chunks=dense.MAX_CHUNKS, n_rays=65536):
    """K1's inputs at n_chunks chunks, with no triangles behind them:
    (r16 [n_rays,16], tmax [n_rays], chunk_bounds [n_chunks,8]).  Boxes
    centred U[-10,10)^3 with half sides U[0.3,1.5); rays from (x, y, -40),
    (x, y) U[-12,12)^2, toward (0.8x, 0.8y, 0), tmax 1e30 on 70% of the
    lanes and -1 (dead) on the rest."""
    rs = np.random.RandomState(seed)
    ctr = rs.rand(n_chunks, 3) * 20 - 10
    half = rs.rand(n_chunks, 3) * 1.2 + 0.3
    cb = np.zeros((n_chunks, 8))
    cb[:, 0:3], cb[:, 4:7] = ctr - half, ctr + half
    px = rs.rand(n_rays, 2) * 24 - 12
    o = np.concatenate([px, np.full((n_rays, 1), -40.0)], 1)
    tgt = np.concatenate([px * 0.8, np.zeros((n_rays, 1))], 1)
    tmax = np.where(rs.rand(n_rays) < 0.7, 1e30, -1.0)
    o, d, cb, tmax = _to(device, o, _unit(tgt - o), cb, tmax)
    return (dense.ray_vectors(o, d, torch.zeros(3, device=o.device))
            .contiguous(), tmax, cb)


def queue_cases(device, seed=0, n_rays=512):
    """K1's edge cases, {name: (r16, tmax, chunk_bounds)}, with r16 built
    directly (origin - centre in columns 6-8, inverse direction in 9-11):

      ties        one ray, 8 boxes: two pairs of equal boxes (equal entry
                  t, ordered by chunk id), one holding the origin (entry
                  0), one entered at 0.5, one beside the ray and one
                  behind it (missed).
      signed_zero one ray, 4 boxes: chunks 0 and 3 entered at -0.0 (their
                  low x face is -0.0, the origin's x +0.0), chunk 1 at
                  +0.0 (it holds the origin), chunk 2 at 2: the list is
                  0, 1, 3, 2.
      dead_miss   3 tiles, 8 boxes: tile 0 live and hitting, tile 1 dead
                  (tmax <= 0) on the rays of tile 0, tile 2 live with
                  every ray pointing away from every box.
      C1, C48, C576  box_table with 1, 48 and 576 chunks, n_rays rays."""
    def ray_rows(o, d):
        r16 = torch.zeros((o.shape[0], 16), dtype=torch.float32)
        r16[:, 6:9] = torch.as_tensor(o, dtype=torch.float32)
        r16[:, 9:12] = 1.0 / torch.as_tensor(d, dtype=torch.float32)
        return r16

    def boxes(lo_hi):
        cb = torch.zeros((len(lo_hi), 8), dtype=torch.float32)
        for c, (lo, hi) in enumerate(lo_hi):
            cb[c, 0:3] = torch.tensor(lo, dtype=torch.float32)
            cb[c, 4:7] = torch.tensor(hi, dtype=torch.float32)
        return cb

    def one_live(o, d, cb, n_tiles=1):
        B = n_tiles * dense.TILE
        r16 = ray_rows(np.tile(o, (B, 1)), np.tile(d, (B, 1)))
        tmax = torch.full((B,), -1.0)
        tmax[0] = 1e30
        return r16, tmax, cb

    along = [([3, -.5, -.5], [4, .5, .5]), ([1, -.5, -.5], [2, .5, .5]),
             ([1, -.5, -.5], [2, .5, .5]), ([3, -.5, -.5], [4, .5, .5]),
             ([1, 2, 2], [2, 3, 3]), ([-1, -.5, -.5], [.5, .5, .5]),
             ([-2, -.5, -.5], [-1, .5, .5]), ([.5, -.5, -.5], [5, .5, .5])]
    cases = {"ties": one_live([0.0, 0.0, 0.0], [1.0, 1e-20, 1e-20],
                              boxes(along))}
    cases["signed_zero"] = one_live(
        [0.0, 0.5, 0.5], [1.0, 1e-20, 1e-20],
        boxes([([-0.0, 0, 0], [1, 1, 1]), ([-1, 0, 0], [1, 1, 1]),
               ([2, 0, 0], [3, 1, 1]), ([-0.0, 0, 0], [1, 1, 1])]))
    rs = np.random.RandomState(seed)
    T = dense.TILE
    o = np.zeros((3 * T, 3))
    d = np.tile([1.0, 1e-20, 1e-20], (3 * T, 1))
    o[:T, 1:] = rs.rand(T, 2) * 0.8 - 0.4          # tile 0: through the boxes
    o[T:2 * T] = o[:T]                             # tile 1: the same, dead
    d[2 * T:, 0] = -1.0                            # tile 2: away from them
    o[2 * T:, 0] = -3.0
    tmax = torch.full((3 * T,), 1e30)
    tmax[T:2 * T] = torch.where(torch.arange(T) % 2 == 0, 0.0, -1.0)
    cases["dead_miss"] = (ray_rows(o, d), tmax, boxes(along))
    for C in (1, 48, dense.MAX_CHUNKS):
        cases[f"C{C}"] = tuple(x.cpu() for x in box_table(
            "cpu", seed, n_chunks=C, n_rays=n_rays))
    return {k: tuple(x.to(device).contiguous() for x in v)
            for k, v in cases.items()}


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


def _record(run, calls):
    """The (r16, tmax, time) batches that run() hands the dense kernels,
    which must be `calls` intersect calls."""
    batches = []
    inner = dense.dense_intersect_loop

    def record(r16, tmax, W_, cb, chunk_static, time=None):
        batches.append((r16.clone(), tmax.clone(),
                        None if time is None else time.clone()))
        return inner(r16, tmax, W_, cb, chunk_static, time=time)

    dense.dense_intersect_loop = record
    try:
        run()
    finally:
        dense.dense_intersect_loop = inner
    if len(batches) != calls:
        raise AssertionError(f"expected {calls} intersect calls, got "
                             f"{len(batches)}")
    return batches


def _recorded_batches(run, depth):
    """{"camera": call 0, "bounce1": call 1} of run()'s depth + 1
    intersect calls."""
    batches = _record(run, depth + 1)
    return {"camera": batches[0], "bounce1": batches[1]}


SHELLS = 8


def shells_scene(res):
    """The shell scene's .pbrt text at res x res (module docstring): boxes
    of half-width 0.2 to 0.9 about (0, 1.5, 0), each with an absorbing
    medium inside, a sphere light at their centre, a matte floor at y = 0
    and volpath at depth 1."""
    def box(h):
        lo, hi = [-h, 1.5 - h, -h], [h, 1.5 + h, h]
        pts = [(x, y, z) for z in (lo[2], hi[2]) for y in (lo[1], hi[1])
               for x in (lo[0], hi[0])]
        idx = [0, 1, 3, 0, 3, 2, 4, 6, 7, 4, 7, 5, 0, 4, 5, 0, 5, 1,
               2, 3, 7, 2, 7, 6, 0, 2, 6, 0, 6, 4, 1, 5, 7, 1, 7, 3]
        return (' AttributeBegin\n Material ""\n'
                ' MediumInterface "ink" ""\n'
                ' Shape "trianglemesh" "point P" ['
                + " ".join(f"{c:g}" for p in pts for c in p)
                + '] "integer indices" [' + " ".join(map(str, idx))
                + ']\n AttributeEnd\n')
    return (
        'LookAt 0 4 -6  0 0.8 0  0 1 0\nCamera "perspective" "float fov" '
        f'[40]\nFilm "image" "integer xresolution" [{res}] '
        f'"integer yresolution" [{res}]\n'
        'Integrator "volpath" "integer maxdepth" [1]\nWorldBegin\n'
        'MakeNamedMedium "ink" "string type" "homogeneous" '
        '"rgb sigma_a" [.5 .5 .5] "rgb sigma_s" [0 0 0]\n'
        'Material "matte" "rgb Kd" [.5 .5 .5]\n'
        'Shape "trianglemesh" "point P" [-6 0 -6 6 0 -6 6 0 6 -6 0 6] '
        '"integer indices" [0 1 2 2 3 0]\n'
        + "".join(box(0.2 + 0.1 * i) for i in range(SHELLS))
        + 'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [40 40 40]\n'
        'Translate 0 1.5 0\nShape "sphere" "float radius" [0.08]\n'
        'AttributeEnd\nWorldEnd\n')


def volpath_walk_batches(job, camera, cfg, width, height, rays, depth,
                         crossings=(1, 2, 8), bounce=1):
    """The shadow walk's batches of one volpath pass (sample 0 of `rays`
    pixels) of a job whose media are bound through MediumInterface: each
    bounce's closest-hit call and then its walk's 8 crossings, one
    intersect call each.  Returns {"walk{c}": `bounce`'s crossing c}."""
    from pbrt_tpu_torch.integrators import path, volpath
    n = 8                        # intersect_tr_walk's max_crossings
    trace = volpath.make_trace_volpath(job)

    def run():
        ids = torch.arange(rays, device=job.scene.device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            camera, width, height, cfg, ids, 0)
        trace(job.scene, ray, pid, sidx, cfg, max_depth=depth)

    batches = _record(run, depth + 1 + depth * n)
    return {f"walk{c}": batches[bounce * (n + 1) + c] for c in crossings}


def main_path_batches(scene, camera, cfg, width, height, rays, depth,
                      **trace_kw):
    """The batches the main path hands the dense kernels in one pass of
    `rays` camera rays (trace_paths with trace_kw, e.g. light_strategy):
    call 0 is the camera batch, call 1 the first trace_pair (bounce-1
    rays + bounce-0 shadow rays).  time is None for static scenes.
    Returns {"camera": ..., "bounce1": ...}."""
    return _recorded_batches(_one_pass(scene, camera, cfg, width, height,
                                       rays, depth, trace_kw), depth)


def _one_pass(scene, camera, cfg, width, height, rays, depth, trace_kw):
    """run(): trace_paths over sample 0 of the first `rays` pixels."""
    from pbrt_tpu_torch.integrators import path

    def run():
        ids = torch.arange(rays, device=scene.device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            camera, width, height, cfg, ids, 0)
        path.trace_paths(scene, ray, pid, sidx, cfg, max_depth=depth,
                         **trace_kw)
    return run


def sss_probe_batches(scene, camera, cfg, width, height, rays, depth,
                      bounces=(0, 1), passes=None, **trace_kw):
    """The BSSRDF probe passes' batches (integrators/path.py _sss_event)
    of one main-path pass of a scene with subsurface materials: call 0 is
    the camera's, then each bounce below `depth` makes SSS_PROBE_PASSES
    probe calls and its trace_pair.  passes: which probe passes (default
    the first and the last).  Returns {"b{bounce}_p{pass}": (r16, tmax,
    time)}."""
    from pbrt_tpu_torch.integrators import path
    P = path.SSS_PROBE_PASSES
    passes = (0, P - 1) if passes is None else passes
    batches = _record(_one_pass(scene, camera, cfg, width, height, rays,
                                depth, trace_kw), 1 + depth * (P + 1))
    return {f"b{b}_p{k}": batches[1 + b * (P + 1) + k]
            for b in bounces for k in passes}


def bdpt_batches(scene, camera, cfg, width, height, rays, depth):
    """The light-side batches of one bdpt pass (integrators/bdpt.py
    trace_pass over sample 0 of the first `rays` pixels): depth + 1
    camera-subpath and depth light-subpath closest-hit calls, then the
    any-hit connections in bdpt.strategies' order.  Returns {"light": the
    first light-subpath call (rays leaving the lights), "s2t2": the
    (s=2, t=2) connections (finite tmax between two surface points, many
    lanes dead), "t1": the (s=2, t=1) connections to the camera}."""
    from pbrt_tpu_torch.film import film as filmmod
    from pbrt_tpu_torch.integrators import bdpt
    T, S = depth + 2, depth + 1
    order = bdpt.strategies(T, S, T, scene.n_lights)

    def run():
        film = filmmod.make_film(width, height, device=scene.device)
        ids = torch.arange(rays, device=scene.device)
        bdpt.trace_pass(scene, camera, film, cfg, ids, 0, depth)

    batches = _record(run, (T - 1) + (S - 1) + len(order))
    n0 = (T - 1) + (S - 1)
    return {"light": batches[T - 1],
            "s2t2": batches[n0 + order.index((2, 2))],
            "t1": batches[n0 + order.index(("t1", 2))]}


def photon_batch(scene, cfg, photons, depth):
    """The first photon call of an SPPM iteration (integrators/sppm.py
    photon_pass at sample 0: `photons` rays leaving the lights), as the
    dense kernels receive it; the pass's `depth` calls run against one
    dead visible point."""
    from pbrt_tpu_torch.integrators import sppm
    dev = scene.device

    def run():
        sppm.photon_pass(scene, cfg, 0, photons, depth,
                         torch.zeros((1, 3), device=dev),
                         torch.zeros(1, dtype=torch.bool, device=dev),
                         torch.ones(1, device=dev))

    return _record(run, depth)[0]


def gather_batches(scene, camera, cfg, width, height, photons, depth,
                   radius):
    """The arguments (vp_p, vp_valid, r2, p, alive, beta, tau_add, M) of
    each `sppm.gather` call of one SPPM iteration at sample 0 (the camera
    pass and the photon pass to `depth`, every pixel's radius `radius`),
    cloned as each call received them: depth - 1 tuples."""
    from pbrt_tpu_torch.integrators import sppm
    _, vp_p, _, vp_valid, _ = sppm.camera_pass(scene, camera, width, height,
                                                cfg, 0, depth)
    calls = []
    inner = sppm.gather

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return inner(*args)

    sppm.gather = record
    try:
        sppm.photon_pass(scene, cfg, 0, photons, depth, vp_p, vp_valid,
                         torch.full((width * height,), float(radius),
                                    device=vp_p.device))
    finally:
        sppm.gather = inner
    return calls


GATHER_TIE = 0.125     # the exact ties' offset: d2 = r2 = 1/64, dyadic


def gather_cases(device, seed=0, V=1000, P=3001):
    """A synthetic gather batch (gather_batches' tuple) of the kernel's edge
    cases, V and P multiples of no tile size: points on a 1/64 grid in
    [-1, 1]^3, a tenth invalid; random photons, a fifth dead; photons on
    points (d2 = 0), on dead and on invalid points; duplicate photons; and
    exact ties, photons GATHER_TIE from a point whose r2 is GATHER_TIE^2
    (d2 == r2 in any order of the sums: each term is dyadic).  beta,
    tau_add and M are positive, so deposits add onto earlier ones."""
    rs = np.random.RandomState(seed)
    vp_p = (rs.randint(-64, 65, (V, 3)) / 64.0).astype(np.float32)
    vp_valid = rs.rand(V) > 0.1
    r2 = (rs.uniform(0.05, 0.3, V) ** 2).astype(np.float32)
    p = rs.uniform(-1, 1, (P, 3)).astype(np.float32)
    alive = rs.rand(P) > 0.2
    n = P // 10
    on = rs.randint(0, V, n)                       # photons on points
    p[:n] = vp_p[on]
    ties = rs.randint(0, V, n)                     # exact ties
    axis = rs.randint(0, 3, n)
    p[n:2 * n] = vp_p[ties]
    p[n + np.arange(n), axis] += np.float32(GATHER_TIE)
    r2[ties] = np.float32(GATHER_TIE * GATHER_TIE)
    p[2 * n:3 * n] = p[rs.randint(0, n, n)]        # duplicate photons
    beta = rs.uniform(0.01, 2.0, (P, 31)).astype(np.float32)
    tau_add = rs.uniform(0.0, 1.0, (V, 31)).astype(np.float32)
    M = rs.randint(0, 5, V).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (
        vp_p, vp_valid, r2, p, alive, beta, tau_add, M))


GATHER_PAIR_INSTR = 8    # f32 instructions a pair test (3 sub, 3 mul, 2 add)


def gather_bound(V, P):
    """The least ms the card could take for V P pair tests, at 33.5e12 f32
    instructions/s (F32_PEAK with an FMA counted once): the gather is
    bound by operations, its bytes being a few tens of MB a call."""
    return V * P * GATHER_PAIR_INSTR / (F32_PEAK / 2) * 1e3


GATHER_NEAR_ULPS = 4


def gather_near_ties(vp_p, vp_valid, r2, p, alive, rows=None):
    """[len(rows)] bool (rows: point indices, default all): the valid
    points with a live photon whose d2, evaluated in float64, lies within
    GATHER_NEAR_ULPS ulp of r2 but not on it, where two f32 orders of the
    sum may fall on either side (exact ties, as gather_cases' dyadic ones,
    fall on no side).  Runs on the inputs' device, a slice of photons at a time."""
    if rows is None:
        rows = torch.arange(vp_p.shape[0], device=vp_p.device)
    vp, r = vp_p[rows].double(), r2[rows]
    rr = r.double()
    ulp = (torch.nextafter(r, torch.full_like(r, float("inf"))) - r
           ).double() * GATHER_NEAR_ULPS
    pp = p[alive].double()
    near = torch.zeros(rows.shape[0], dtype=torch.bool, device=vp.device)
    step = max(1, (1 << 22) // max(rows.shape[0], 1))
    for c0 in range(0, pp.shape[0], step):
        d2 = ((vp[:, None, :] - pp[None, c0:c0 + step, :]) ** 2).sum(-1)
        gap = (d2 - rr[:, None]).abs()
        near |= ((gap <= ulp[:, None]) & (gap > 0)).any(-1)
    return near & vp_valid[rows]


def probe_repeats(scene, camera, cfg, width, height, rays, depth,
                  **trace_kw):
    """The probe march's re-hits in one main-path pass: for each bounce,
    (probe lanes whose pass k+1 returned the same triangle as pass k,
    live lanes of passes 1 .. P-1), summed over k.  The march steps
    t (1 + 2e-4) + eps past a hit (sized for the TPU kernel's bf16x2 t);
    a lane that finds its own triangle again has re-hit it."""
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.ops import intersect as isect
    P = path.SSS_PROBE_PASSES
    out = []
    inner = isect.intersect

    def record(sc, ray, *a, **k):
        t, prim, found = inner(sc, ray, *a, **k)
        out.append((ray.tmax > 0, prim.clone(), found.clone()))
        return t, prim, found

    isect.intersect = record
    try:
        _one_pass(scene, camera, cfg, width, height, rays, depth,
                  trace_kw)()
    finally:
        isect.intersect = inner
    if len(out) != 1 + depth * (P + 1):
        raise AssertionError(f"expected {1 + depth * (P + 1)} intersect "
                             f"calls, got {len(out)}")
    rep = {}
    for b in range(depth):
        calls = out[1 + b * (P + 1):1 + b * (P + 1) + P]
        same = live = 0
        for (_, p0, f0), (l1, p1, f1) in zip(calls, calls[1:]):
            same += int((l1 & f0 & f1 & (p0 == p1)).sum())
            live += int(l1.sum())
        rep[b] = (same, live)
    return rep


# the walks' per-ray arguments (the rest are the scene's tables)
WALK_RAY_ARGS = ("o", "d", "tmax", "t_init", "prim_init", "anyhit", "time")
# the walk routes' cells over the dense cap (PERF.md section 4; chip_smoke
# phase 25, tools/ab_walk.py): tools/shapes_scene.py arguments, the route,
# resolution, spp, the walk kernel
WALK_CELLS = {
    "shapes_1m": (dict(level=6, instances=12, field=256), "BVH", 256, 4,
                  "bvh_walk"),
    "shapes_motion": (dict(moving_field=True), "BVH", 128, 4,
                      "bvh_walk_motion"),
    "shapes_kd": (dict(level=5, instances=13, accel="kdtree"), "kd-tree",
                  256, 4, "kd_walk"),
    "shapes_kd_motion": (dict(moving_field=True, accel="kdtree"), "kd-tree",
                         128, 4, "kd_walk_motion"),
}
# the walks' batches measured: (row, cell, batch of accel_batches)
WALK_ROWS = (("bvh_1m_camera", "shapes_1m", "camera"),
             ("bvh_1m_bounce1", "shapes_1m", "bounce1"),
             ("bvh_motion_bounce1", "shapes_motion", "bounce1"),
             ("kd_camera", "shapes_kd", "camera"),
             ("kd_bounce1", "shapes_kd", "bounce1"),
             ("kd_motion_bounce1", "shapes_kd_motion", "bounce1"))


def accel_batches(scene, camera, cfg, width, height, rays, depth,
                  **trace_kw):
    """The walk route's main_path_batches: the arguments that one pass of
    `rays` camera rays (trace_paths with trace_kw) hands the BVH walk, or
    the kd walk when the scene took the kd-tree, as {"camera": call 0,
    "bounce1": call 1 (bounce-1 rays + bounce-0 shadow rays)}; each a dict
    of keyword arguments of accel_walk.bvh_walk / kd_walk, the per-ray
    tensors cloned.  The scene must be over the dense cap (or have
    use_dense set false)."""
    from pbrt_tpu_torch.integrators import path
    if scene.use_dense:
        raise ValueError("accel_batches: the scene takes the dense route")
    name = "kd_walk" if scene.use_kd else "bvh_walk"
    inner = getattr(accel_walk, name)
    calls = []

    def record(**kw):
        calls.append({k: (v.clone() if k in WALK_RAY_ARGS and v is not None
                          else v) for k, v in kw.items()})
        return inner(**kw)

    def run():
        ids = torch.arange(rays, device=scene.device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            camera, width, height, cfg, ids, 0)
        path.trace_paths(scene, ray, pid, sidx, cfg, max_depth=depth,
                         **trace_kw)

    setattr(accel_walk, name, record)
    try:
        run()
    finally:
        setattr(accel_walk, name, inner)
    if len(calls) != depth + 1:
        raise AssertionError(f"expected {depth + 1} walk calls, got "
                             f"{len(calls)}")
    return {"camera": calls[0], "bounce1": calls[1]}


def walk_edge_rays(scene, seed=0, n_random=256, aim=()):
    """The walks' edge cases on `scene` (BVH or kd), as (o, d, tmax, time,
    anyhit) tensors on its device:

      split plane   for each of the first 8 interior kd nodes (with a
                    kd-tree), rays whose origin lies on the node's split
                    plane, parallel to it (p_at == split at every t, d_ax
                    +0.0 or -0.0: the d_ax <= 0 tie rule) or leaving it
                    below or above;
      axis          axis-parallel rays and rays with a component of
                    +-1e-21 (the guarded reciprocal's 2e20 and 0);
      inside        origins inside the root box, random directions;
      face          origins on each face of the root box, or 1e-6 past
                    it, leaving it: the kd walk's cell exit t_cell <= 0;
      aim           any-hit rays through each point of `aim` (a quadric's
                    centre gives a pre-hit that ends the walk);
    with random shutter times in [-0.2, 1.2] and a finite tmax on some."""
    rs = np.random.RandomState(seed)
    box = (scene.kd_bounds if scene.use_kd else
           scene.bvh_packed[0, 0:6].reshape(2, 3)).cpu().numpy()
    lo, hi = box[0].astype(np.float64), box[1].astype(np.float64)
    inner = lambda n: rs.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                                 (n, 3))
    o, d, any_ = [], [], []

    def add(oo, dd, a=False):
        o.append(np.asarray(oo, np.float64).reshape(-1, 3))
        d.append(np.asarray(dd, np.float64).reshape(-1, 3))
        any_.append(np.full(len(o[-1]), a))

    if scene.use_kd:
        kp = scene.kd_packed.cpu().numpy()
        axes = kp[:, 1].view(np.int32)
        for n in np.nonzero(axes != 3)[0][:8]:
            a, s = int(axes[n]), float(kp[n, 0])
            for side in (0.0, -0.0, -1.0, 1.0):
                oo = inner(2)
                oo[:, a] = s
                dd = rs.normal(size=(2, 3))
                dd[:, a] = side * np.abs(dd[:, a])
                add(oo, dd)
    eye = np.eye(3)
    add(inner(6), np.concatenate([eye, -eye]))
    tiny = rs.normal(size=(6, 3))
    tiny[np.arange(6), np.arange(6) % 3] = np.where(
        np.arange(6) < 3, 1e-21, -1e-21)
    add(inner(6), tiny)
    add(inner(n_random), rs.normal(size=(n_random, 3)))
    for a in range(3):
        for k, edge in enumerate((lo[a], hi[a])):
            out = 1.0 if k else -1.0
            for past in (0.0, 1e-6):
                oo = inner(2)
                oo[:, a] = edge + out * past
                dd = rs.normal(size=(2, 3)) * 0.1
                dd[:, a] = out
                add(oo, dd)
    for c in aim:
        oo = inner(8)
        add(oo, np.asarray(c, np.float64)[None] - oo, True)
    o = np.concatenate(o).astype(np.float32)
    d = np.concatenate(d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    # the split-plane origins exactly on the plane after the f32 cast,
    # the tiny components kept (the normalisation above keeps them)
    B = len(o)
    tmax = np.full(B, np.inf, np.float32)
    tmax[3::7] = rs.uniform(0.3, 1.0, len(tmax[3::7])) * float(
        np.linalg.norm(hi - lo))
    time = rs.uniform(-0.2, 1.2, B).astype(np.float32)
    dev = scene.tri_packed.device
    return (*_to(dev, o, d, tmax, time),
            torch.as_tensor(np.concatenate(any_), device=dev))


def bitonic_batch(scene, n_rays=65536, seed=0):
    """(r16, tmax, None): rays from points inside the scene's box in
    uniform directions, unsorted, so that a tile's 128 rays enter most of
    the scene's chunks, more than K1 orders by counting
    (dense.QUEUE_RANK_MAX) on a scene of a few hundred chunks."""
    dev = scene.dense_w.device
    rs = np.random.RandomState(seed)
    lo = scene.dense_cb[:, 0:3].amin(0).cpu().numpy()
    hi = scene.dense_cb[:, 4:7].amax(0).cpu().numpy()
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n_rays, 3))
    d = _unit(rs.normal(size=(n_rays, 3)))
    o, d = _to(dev, o, d)
    r16 = dense.ray_vectors(o, d, scene.dense_center)
    return r16, torch.full((n_rays,), 1e30, device=dev), None


def refpath_batches(scene, camera, width, height, depth):
    """The batches one matched-RNG pass (integrators/refpath.py, sample
    0, every pixel) hands the dense kernels: "camera", the W*H camera rays
    in scanline order, and "bounce1", the first bounce's continuation,
    probe and shadow rays as one batch of 3 W*H, the last W*H any-hit."""
    from pbrt_tpu_torch.integrators import refpath

    def run():
        sampler = refpath.RefSampler.make(width, height)
        ids = torch.arange(width * height, device=scene.device)
        ray, _, _, pid, sidx = refpath.camera_rays_ref(
            camera, width, height, sampler, ids, 0)
        refpath.trace_ref(scene, refpath.build_ref_lights(scene), sampler,
                          ray, pid, sidx, max_depth=depth)

    return _recorded_batches(run, depth)


# ---------------------------------------------------------------------------
# K2's bound: the least time the card could take for its work
# ---------------------------------------------------------------------------

F32_PEAK = 67e12     # FLOP/s, H100 SXM f32 outside the tensor cores
HBM_BPS = 3.35e12    # B/s, H100 SXM HBM3
# f32 operations per ray-triangle test: the static body (21 FMAs, two
# adds, the division), and K2 motion's on a moving chunk (66 Horner FMAs
# more); K2 motion runs static chunks with the static body
TEST_FLOPS, TEST_FLOPS_MOVING = 45, 177


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it: "operations" or
    "bytes") for `flops` f32 operations and `nbytes` bytes moved."""
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def loop_bound(r16, tmax, W, chunk_list, n_active, t, prim, chunk_static,
               time=None):
    """(ms, what bounds it, (tests on static chunks, on moving chunks)) of
    production K2 (or K2 motion, given `time`) on these inputs, whose
    outputs were (t, prim): TEST_FLOPS per test on a static chunk and
    TEST_FLOPS_MOVING on a moving one (dense.loop_test_counts), and
    loop_bytes("full").  chunk_static as loop_test_counts'."""
    n_coef = 1 if time is None else dense.N_COEF
    chunk = W.shape[2] // (4 * n_coef)
    st, mv = dense.loop_test_counts(r16, tmax, prim, chunk_list, n_active,
                                    chunk, chunk_static)
    nb = loop_bytes("full", r16, tmax, W, chunk_list, n_active, t, prim,
                    chunk_static=chunk_static, time=time)
    return (*bound(TEST_FLOPS * st + TEST_FLOPS_MOVING * mv, nb), (st, mv))


def loop_bytes(mode, r16, tmax, W, chunk_list, n_active, *outs,
               chunk_static, time=None):
    """Bytes a loop-kernel mode (production K2 and K2 motion are "full")
    must move, each input read once: n_active and each tile's first
    n_active list entries; tmax (but for stage, which never reads it);
    except for empty, the LOOP_ROWS staged rows of each distinct listed
    chunk (K2 motion: all four planes of a moving chunk, plane 0 of a
    static one); the ray columns the tests read (d, (o-c) x d, o-c: 9
    floats, the any-hit flag where hits are taken, the time for motion);
    the merge keys where lists are split across blocks (zeroed, then read
    back); and the outputs.  chunk_static as dense.loop_test_counts'."""
    n_coef = 1 if time is None else dense.N_COEF
    C = W.shape[0]
    chunk = W.shape[2] // (4 * n_coef)
    B, n_tiles = r16.shape[0], chunk_list.shape[0]
    on = (torch.arange(C, device=n_active.device) < n_active[:, None])
    b = sum(x.numel() * x.element_size() for x in (n_active, *outs))
    b += int(n_active.sum()) * 4
    if dense.loop_blocks(C) > 1:
        b += (B + n_tiles) * 8
    if mode != "stage":
        b += tmax.numel() * 4
    if mode == "empty":
        return b
    listed = torch.unique(chunk_list[on].long())
    n_moving = int((~chunk_static.to(torch.bool)[listed]).sum())
    b += (listed.numel() + (n_coef - 1) * n_moving) * dense.LOOP_ROWS \
        * chunk * 4
    cols = {"stage": 0, "sections": 9}.get(mode, 10 + (time is not None))
    return b + B * cols * 4


# ---------------------------------------------------------------------------
# the walks' bound
# ---------------------------------------------------------------------------

# f32 operations: a BVH slab test (3 x (2 subs, 2 muls, min, max), the
# far scale, 3 compares), a kd descent step (p_at, t_split, the compares)
# and a triangle test (ray_triangle: the shear of three vertices, three
# edge functions with their on-edge test, det, t and the range test; a
# moving triangle's 9 multiply-adds more)
SLAB_FLOPS, KD_STEP_FLOPS = 22, 9
TRI_FLOPS, TRI_FLOPS_MOVING = 68, 86


def walk_bytes(kw, counts, kd=False):
    """Bytes a walk must move on these inputs (kw: accel_batches' record),
    each read once: every lane's ray (o, d, t_init, prim_init; tmax for
    the kd walk, the any-hit flag and the time where given), the distinct
    node rows it touched (a BVH node's 32 bytes and its link, a kd node's
    16), the distinct triangle rows (48 bytes, 96 with motion) and kd
    list entries, and the outputs t, prim.  counts: the plain version's
    WalkCounts."""
    B = kw["o"].shape[0]
    per_ray = 24 + 8 + 8 + (4 if kd else 0)
    per_ray += 1 if kw.get("anyhit") is not None else 0
    per_ray += 4 if kw.get("time") is not None else 0
    tri = 96 if kw.get("time") is not None else 48
    node = 16 if kd else 32 + 4
    return (B * per_ray + counts.nodes * node + counts.tris * tri
            + counts.list_entries * 4)


def walk_bound(kw, counts, kd=False):
    """(ms, what bounds it) of a walk on these inputs: SLAB_FLOPS (or
    KD_STEP_FLOPS) a node step and TRI_FLOPS (TRI_FLOPS_MOVING with
    motion) a triangle test, from the plain version's counts, against
    walk_bytes."""
    steps = int(counts.visits.sum())
    tests = int(counts.tests.sum())
    tri = TRI_FLOPS_MOVING if kw.get("time") is not None else TRI_FLOPS
    flops = (KD_STEP_FLOPS if kd else SLAB_FLOPS) * steps + tri * tests
    return bound(flops, walk_bytes(kw, counts, kd))


def walk_ties(scene, o, d, time, lanes, prim_a, prim_b, rel=1e-5):
    """[len(lanes)] bool: whether each lane's two prims are both
    triangles that hit its ray at t within `rel` of each other (the port's
    f32 ray_triangle, at the ray's clamped time when `time` is given), so
    that either answer is the nearest."""
    if not len(lanes):
        return torch.zeros(0, dtype=torch.bool, device=prim_a.device)
    pid = torch.stack([prim_a[lanes], prim_b[lanes]], 1).long()
    both = (pid >= 0).all(1)
    pid = pid.clamp(min=0)
    tp = scene.tri_packed[pid]
    v0, e1, e2 = tp[..., 0:3], tp[..., 3:6], tp[..., 6:9]
    if time is not None:
        tm = scene.tri_motion[pid]
        u = time[lanes].clamp(0, 1)[:, None, None]
        v0, e1, e2 = (v0 + u * tm[..., 0:3], e1 + u * tm[..., 3:6],
                      e2 + u * tm[..., 6:9])
    t, _, _, hit = isect.ray_triangle(
        o[lanes], d[lanes], v0, e1, e2,
        torch.full((len(lanes),), 1e30, device=v0.device))
    return both & hit.all(1) & ((t[:, 0] - t[:, 1]).abs()
                                <= rel * t[:, 1].abs())


# ---------------------------------------------------------------------------
# K1's bound
# ---------------------------------------------------------------------------

QUEUE_FLOPS = 28     # f32 operations per (live lane, chunk) slab test


def queue_bytes(mode, r16, tmax, chunk_bounds):
    """Bytes K1 must move on these inputs, each read or written once: the
    64-byte r16 row of each live lane (its origin and inverse direction
    span both 32-byte sectors of the row; a dead lane's row is never
    needed), tmax, the chunk boxes, and the outputs: chunk_list
    [n_tiles,C] int32 and n_active [n_tiles] int32 for mode "list", hits
    (one byte) and near (f32) [n_tiles,C] for mode "cull"."""
    if mode not in ("list", "cull"):
        raise ValueError(f"unknown K1 mode {mode!r}")
    n_tiles = r16.shape[0] // dense.TILE
    C = chunk_bounds.shape[0]
    live = int((tmax > 0).sum())
    out = n_tiles * C * 4 + n_tiles * 4 if mode == "list" \
        else n_tiles * C * 5
    return live * 64 + tmax.numel() * 4 + chunk_bounds.numel() * 4 + out


def queue_bound(mode, r16, tmax, chunk_bounds):
    """(ms, what bounds it) of K1 in `mode` ("list" or "cull") on these
    inputs: QUEUE_FLOPS per live lane and chunk, and queue_bytes.  The
    list's order costs compares, which are not counted."""
    live = int((tmax > 0).sum())
    return bound(QUEUE_FLOPS * live * chunk_bounds.shape[0],
                 queue_bytes(mode, r16, tmax, chunk_bounds))


# ---------------------------------------------------------------------------
# timing, shared by the tools
# ---------------------------------------------------------------------------

def time_ms(fn, reps, device, warmup=True):
    """Mean time of fn() in ms over `reps` calls after one warm-up (none
    when the caller has just run it): CUDA events on a card; on the CPU
    the host clock (the plain versions' time, never a device time)."""
    if warmup:
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


HOLD_CYCLES = 10 ** 8    # ~50 ms of the H100's SM clock


def queued_ms(fn, reps):
    """Device ms per call of fn() from CUDA events that the host's launches
    cannot reach: a spin kernel (torch.cuda._sleep, HOLD_CYCLES) holds the
    stream while the start event, `reps` calls and the end event are
    queued behind it, so the events time the calls back to back on the
    card.  For a call of one kernel that is the kernel's device time.
    None if the hold ran out before the end event was queued."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if held else None


def device_us(event):
    """A torch.profiler event's own device time in us."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_ms(fn, reps=8, traces=3):
    """(device ms per call, kernels per call) of fn() on the card: the
    summed time of the kernels it launches, under torch.profiler, over
    `reps` calls after one warm-up; the time the card waits on the host
    between them is not in it.  On the H100 a trace now and then comes
    back with some or all of its kernels missing, so `traces` traces are
    taken and the one with the most kernel events counts.  None if no
    trace held device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    best = None
    for _ in range(traces):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
        n = sum(e.count for e in ev)
        if ev and (best is None or n > best[1] * reps):
            best = (sum(device_us(e) for e in ev) / 1e3 / reps, n / reps)
    return best


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
