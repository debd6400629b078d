"""Drive a render job of `pbrt_tpu_torch` as its CLI's `run_job` does:
`integrators.dispatch.render_with_integrator` into a fresh film, passes
of the traffic's lanes back to back, a job after a job (a closed loop of
one user).

The window ends at the pass in flight when its seconds have passed: the
film's `progress` callback, which `path.render` calls after each pass is
enqueued, raises once the deadline has passed, and the window closes at
the device synchronisation after it.  An SPPM job has no per-pass hook:
its window runs whole jobs.  Each job samples with its own sampler seed,
drawn from the run's seed.

The check: a sample of pixels drawn from the seed, and for each job the
sums the film holds there (its raw sums and filter weights), against the
plain reference's sums over the same sample indices.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

import torch

from benchmark.reference import compare
from benchmark.seeds import job_seed


# integrators whose jobs run whole, with no per-pass hook (SPPM renders
# max(spp, 4) iterations)
LIGHT_SIDE = ("sppm",)


class _Deadline(Exception):
    pass


@dataclasses.dataclass
class State:
    cell: dict
    traffic: dict
    device: torch.device
    seed: int
    job: object
    camera: object
    width: int
    height: int
    spp: int
    depth: int
    lanes: int
    setup_times: dict
    counts: dict = None
    pixels: torch.Tensor = None
    results: list = dataclasses.field(default_factory=list)
    n_jobs: int = 0
    passes_per_unit: int = 1


def setup(cell, seed, device):
    from pbrt_tpu_torch.parser.api import parse_scene
    from pbrt_tpu_torch.tools import pbrt as cli

    tr = cell["traffic"]
    times = {}
    t0 = time.perf_counter()
    scene_file = os.path.join(cell["root"], cell["config_data"]["scene"])
    job = parse_scene(scene_file, device=device)
    times["parse_build_s"] = time.perf_counter() - t0
    if tr["integrator"] != job.integrator_kind:
        job.integrator_kind = tr["integrator"]
    job.integrator_params.update(tr.get("integrator_params", {}))
    W, H = tr["width"], tr["height"]
    camera = cli.build_camera(job, W, H, device)
    st = State(cell=cell, traffic=tr, device=device, seed=seed, job=job,
               camera=camera, width=W, height=H, spp=tr["spp"],
               depth=job.integrator_params["maxdepth"],
               lanes=tr["lanes_per_pass"], setup_times=times)
    if tr["integrator"] in LIGHT_SIDE:
        # a light-side job runs whole: its iterations are its passes
        st.passes_per_unit = max(st.spp, 4)
    scene = job.scene
    st.counts = dict(triangles=int((scene.prim_type == 0).sum()),
                     quadrics=int(scene.n_quadrics))
    rng = random.Random(int(seed))
    st.pixels = torch.tensor(sorted(rng.sample(range(W * H),
                                               tr["check"]["pixels"])),
                             device=device)
    # warm-up: the cell's own shapes, with seeds no job uses
    t0 = time.perf_counter()
    for k in range(tr.get("warmup_passes", 2)):
        _render(st, (job_seed(seed, -1) + k) % (1 << 32),
                st.spp if tr["integrator"] in LIGHT_SIDE else 1, None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["warmup_s"] = time.perf_counter() - t0
    return st


def _render(st, sampler_seed, spp, progress):
    """One job of spp samples a pixel into a new film; returns (film,
    passes done).  progress may raise _Deadline to end it early."""
    from pbrt_tpu_torch.film import film as filmmod
    from pbrt_tpu_torch.integrators import dispatch
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig

    job = st.job
    fp = dict(job.filter_params)
    radius = fp.pop("radius", None)
    film = filmmod.make_film(st.width, st.height, job.filter_name,
                             radius=radius, device=st.device, **fp)
    cfg = SamplerConfig(kind=job.sampler_kind, seed=sampler_seed, spp=spp)
    done = [0]

    def prog(d, total):
        done[0] = d
        if progress is not None:
            progress()

    try:
        dispatch.render_with_integrator(job, st.camera, film, cfg, spp,
                                        st.depth,
                                        max_rays_per_pass=st.lanes,
                                        progress=prog)
    except _Deadline:
        pass
    if st.traffic["integrator"] in LIGHT_SIDE:
        done[0] = st.passes_per_unit
    return film, done[0]


def _keep(st, film, sampler_seed, passes):
    """Keep the film's sums at the sampled pixels for the check."""
    px = st.pixels
    W = st.width
    st.results.append(dict(
        seed=sampler_seed, passes=passes,
        raw=film.raw[px // W, px % W].clone(),
        weight=film.weight[px // W, px % W].clone()))


def window(st, seconds):
    """Render jobs until `seconds` have passed; returns the units (passes)
    and samples completed and the window's seconds."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n_pix = st.width * st.height
    passes = 0
    films = []

    def stop():
        if time.perf_counter() >= deadline:
            raise _Deadline

    while time.perf_counter() < deadline:
        s = job_seed(st.seed, st.n_jobs)
        st.n_jobs += 1
        film, done = _render(st, s, st.spp, stop)
        films.append((film, s, done))
        passes += done
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    elapsed = time.perf_counter() - t0
    for film, s, done in films:
        _keep(st, film, s, done)
    samples = passes * min(st.lanes, n_pix)
    return dict(units=passes, samples=samples, seconds=elapsed)


def unit(st):
    """One traced unit: a one-pass job (a whole light-side job) with a
    seed of its own."""
    s = job_seed(st.seed, st.n_jobs)
    st.n_jobs += 1
    film, done = _render(st, s, st.spp if st.traffic["integrator"]
                         in LIGHT_SIDE else 1, None)
    _keep(st, film, s, done)


def spans(st):
    """The layers' entry points wrapped in traced runs: (label, module,
    attribute, per-call size)."""
    from pbrt_tpu_torch.ops import intersect

    out = [("intersect", intersect, "intersect",
            lambda scene, ray, *a, **k: int(ray.o.shape[0]))]
    if st.traffic["integrator"] == "volpath":
        # media tracking (the scene medium's and the per-lane grids') and
        # the shadow walk across medium interfaces
        from pbrt_tpu_torch.media import media
        for attr in ("sample_distance", "transmittance",
                     "sample_distance_lanes", "sample_distance_grid_lanes"):
            out.append(("media", media, attr, None))
        out.append(("media", intersect, "intersect_tr_walk", None))
    if st.traffic["integrator"] == "sppm":
        from pbrt_tpu_torch.integrators import sppm
        out.append(("gather", sppm, "gather", None))
    return out


def check(st):
    """(name, value, limit) of every number compared."""
    return compare.check_render(st)
